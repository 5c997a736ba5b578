"""Per-process event counters and spans of the device path.

`COUNTS` is bumped where the event happens, through `add`: a kernel
wrapper adds one where it launches its kernel, the plain versions where
they run, the scorer and the pileup by the rows they apply. Call pools
bump from several threads at once, so every update takes `_LOCK` (a `+=`
on a Counter is a read, an add and a write, and two threads can lose one).
Region workers (pipeline/genotype.py) return their own counts with each
output path; the parent adds those to `WORKERS`, never to `COUNTS`, and
`totals()` reports the sum of the two.

Spans time the pipeline's stages where they run: `span(name, n, parent)`
records the name, start and end (`time.time_ns`, the wall clock onto which
the benchmark maps each process's device operations), the span's id, its
parent's and its job's (the root's), the process and thread, and an item
count `n` (reads, rows or pairs). The parent is the thread's innermost
open span; work handed to another thread or process passes `current()`
as its parent. Finished spans go to `SPANS`; region workers return theirs
with their counts and the parent adds them to `WORKER_SPANS`. `spans()`
returns both. A span's self time is its duration less the union of its
children on its own thread (`self_intervals`).

The recorder is off unless GT_TRACE names a file, read once at import, or
`trace(True)` turns it on; off, `span()` hands back one shared no-op after
a single check. With GT_TRACE set, the top process writes its spans and
its workers' to that file when it exits, as Chrome trace-event JSON
(Perfetto and chrome://tracing open it). Spans are kept in memory until
then, some 20 to 50 a 50 kb unit.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import Counter, namedtuple

#: events in this process
COUNTS: Counter = Counter()
#: events reported back by region worker processes this process started
WORKERS: Counter = Counter()
_LOCK = threading.Lock()

#: one finished span; `parent` is None for a root, whose `job` is its own id
Span = namedtuple("Span", "name start_ns end_ns id parent job pid tid n")
#: finished spans of this process
SPANS: list = []
#: spans reported back by region worker processes this process started
WORKER_SPANS: list = []

TRACE_PATH = os.environ.get("GT_TRACE") or None
_on = TRACE_PATH is not None
_seq = itertools.count(1)
_local = threading.local()


def add(key: str, n: int | float = 1) -> None:
    """COUNTS[key] += n, safe from several threads."""
    with _LOCK:
        COUNTS[key] += n


def add_worker(counts: dict, spans: list) -> None:
    """Add a region worker's counts and spans, as it returned them."""
    with _LOCK:
        WORKERS.update(counts)
        WORKER_SPANS.extend(spans)


def take() -> tuple[dict, list]:
    """This process's counts and spans, cleared: what a region worker
    returns for one job."""
    with _LOCK:
        out = dict(COUNTS), list(SPANS)
        COUNTS.clear()
        SPANS.clear()
    return out


def reset() -> None:
    with _LOCK:
        COUNTS.clear()
        WORKERS.clear()
        SPANS.clear()
        WORKER_SPANS.clear()


def totals() -> dict:
    with _LOCK:
        out = Counter(COUNTS)
        out.update(WORKERS)
    return dict(out)


# ---- spans -----------------------------------------------------------------

def trace(on: bool) -> None:
    """Turn the span recorder of this process on or off."""
    global _on
    _on = on


def tracing() -> bool:
    return _on


def spans() -> list:
    """Every finished span of this process and of its region workers."""
    with _LOCK:
        return SPANS + WORKER_SPANS


class _Noop:
    """What `span()` returns while the recorder is off."""

    __slots__ = ()
    n = property(lambda self: None, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _Noop()


def _ids(parent: tuple | None) -> tuple:
    """(id, parent id, job id) of a new span under `parent`, else under
    this thread's innermost open span, else a root. Ids hold the pid, so
    those of region workers never collide with their parent's."""
    sid = os.getpid() * 10**9 + next(_seq)
    parent = parent if parent is not None else current()
    return (sid, *parent) if parent is not None else (sid, None, sid)


class _Open:
    """A span being timed; `n` may be set before it ends."""

    __slots__ = ("name", "n", "id", "parent", "job", "start_ns")

    def __init__(self, name: str, n, parent) -> None:
        self.name, self.n = name, n
        self.id, self.parent, self.job = _ids(parent)

    def __enter__(self) -> "_Open":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        _local.stack.pop()
        done = Span(self.name, self.start_ns, end, self.id, self.parent, self.job, os.getpid(),
                    threading.get_native_id(), self.n)
        with _LOCK:
            SPANS.append(done)


def current() -> tuple | None:
    """(id, job id) of this thread's innermost open span, to pass as the
    `parent` of work handed to another thread or process; None when there
    is none or the recorder is off."""
    stack = getattr(_local, "stack", None) if _on else None
    if not stack:
        return None
    top = stack[-1]
    return top.id, top.job


def span(name: str, n: int | None = None, parent: tuple | None = None):
    """A context manager timing the work inside it as span `name`, child
    of `parent` (a `current()` of another thread or process) or else of
    this thread's innermost open span."""
    if not _on:
        return _NOOP
    return _Open(name, n, parent)


def record(name: str, start_ns: int, end_ns: int, n: int | None = None, parent: tuple | None = None) -> None:
    """A span timed elsewhere: from `start_ns` (stamped in another process,
    on the same clock) to `end_ns`, on this thread."""
    if not _on:
        return
    done = Span(name, start_ns, end_ns, *_ids(parent), os.getpid(), threading.get_native_id(), n)
    with _LOCK:
        SPANS.append(done)


def self_intervals(all_spans: list) -> dict:
    """span id -> the (start_ns, end_ns) pieces of its interval that none of
    its children on its own thread covers: its self time."""
    kids: dict = {}
    where = {s.id: (s.pid, s.tid) for s in all_spans}
    for s in all_spans:
        if s.parent is not None and where.get(s.parent) == (s.pid, s.tid):
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in all_spans:
        pieces, at = [], s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, s.start_ns), min(b, s.end_ns)
            if a > at:
                pieces.append((at, a))
            at = max(at, b)
        if at < s.end_ns:
            pieces.append((at, s.end_ns))
        out[s.id] = pieces
    return out


def self_seconds(all_spans: list) -> dict:
    """span name -> the self time of all its spans, in seconds."""
    pieces = self_intervals(all_spans)
    out: dict = {}
    for s in all_spans:
        out[s.name] = out.get(s.name, 0.0) + sum(b - a for a, b in pieces[s.id]) / 1e9
    return out


def _export() -> None:
    """Write every span to TRACE_PATH as Chrome trace-event JSON: complete
    events, in µs."""
    events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "pid": s.pid, "tid": s.tid, "args": {"id": s.id, "parent": s.parent, "job": s.job, "n": s.n}}
              for s in spans()]
    try:
        with open(TRACE_PATH, "w") as f:
            json.dump({"displayTimeUnit": "ms", "traceEvents": events}, f)
    except OSError as e:
        from graphtyper_tpu_torch.utils.log import get_logger

        get_logger().warning("GT_TRACE: could not write the spans to %s: %s", TRACE_PATH, e)


if TRACE_PATH is not None:
    import multiprocessing

    if multiprocessing.parent_process() is None:
        atexit.register(_export)
