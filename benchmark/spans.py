"""The program's spans (graphtyper_tpu_torch/counters.py) beside the device
trace: names for the device's idle gaps, and the readings of single stages.

A traced run of the port with GT_TRACE set records a span at each stage
boundary of every process, on the wall clock (`time.time_ns`) onto which
`harness.device_intervals` maps each process's device operations, so the
two compare without conversion. Spans are `counters.Span` tuples.
"""

from __future__ import annotations

from benchmark import harness

#: the stages read as `<stage>.s_per_job`: the spans whose self time each sums
STAGES = {
    "bamshrink": ("bamshrink",),
    "discovery": ("discovery", "discovery.pileup"),
    "index": ("graph.build", "index.build"),
    "call": ("call.pool",),
    "scoring": ("scoring.flush", "scoring.materialize"),
    "merge": ("merge", "write", "sites.write"),
}
#: the root span: the caller's whole job, which in a region-pool cell is the
#: parent process waiting on its workers, so it names no stage
ROOT = "job"


def clip(spans: list, window: tuple) -> list:
    """The spans that overlap the window, cut to it."""
    lo, hi = window
    return [s._replace(start_ns=max(s.start_ns, lo), end_ns=min(s.end_ns, hi))
            for s in spans if s.end_ns > lo and s.start_ns < hi]


def self_pieces(spans: list) -> list:
    """(start_ns, end_ns, name) of every piece of self time: each span's
    interval less its children's on its own thread."""
    from graphtyper_tpu_torch.counters import self_intervals

    pieces = self_intervals(spans)
    return [(a, b, s.name) for s in spans for a, b in pieces[s.id]]


def idle_gaps(intervals: list, window: tuple) -> list:
    """(start_ns, end_ns, name) of each stretch of the window with no device
    operation, as `harness.breakdown` finds them."""
    lo, hi = window
    gaps, last = [], lo
    for s, e in sorted((s, e) for s, e in intervals if s >= lo and e <= hi):
        if s > last:
            gaps.append((last, s, "idle between device operations"))
        last = max(last, e)
    if hi > last:
        gaps.append((last, hi, "idle after the last device operation"))
    return gaps


def gap_name(gap: tuple, pieces: list) -> str:
    """`host:<name>` of the span whose self time covers most of the gap,
    summed over every process and thread; the gap's own name where no span
    but the root covers half of it."""
    g0, g1, name = gap
    cover: dict = {}
    for a, b, span_name in pieces:
        if span_name != ROOT and b > g0 and a < g1:
            cover[span_name] = cover.get(span_name, 0) + min(b, g1) - max(a, g0)
    if not cover:
        return name
    best = max(cover, key=cover.get)
    covered = harness.union_seconds([(max(a, g0), min(b, g1)) for a, b, n in pieces
                                     if n != ROOT and b > g0 and a < g1])
    return "host:" + best if 2 * covered >= g1 - g0 else name


def breakdown(named: list, intervals: list, window: tuple, spans: list | None = None, top: int = 10) -> dict:
    """`harness.breakdown`, and given the program's spans, each of the
    longest idle gaps named for the stage the host was in (`gap_name`)."""
    out = harness.breakdown(named, intervals, window, top)
    if spans is None:
        return out
    pieces = self_pieces(clip(spans, window))
    gaps = sorted(idle_gaps(intervals, window), key=lambda g: -(g[1] - g[0]))[:top]
    out["idle_gaps"] = [[gap_name(g, pieces), (g[1] - g[0]) / 1e9] for g in gaps]
    return out


def idle_named_percent(intervals: list, spans: list, window: tuple) -> float | None:
    """Share of the window's device-idle time in which some process had a
    span other than the root open, in %: the union of those spans and the
    device's operations, less the operations, over the idle time."""
    lo, hi = window
    busy = [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]
    open_ = [(s.start_ns, s.end_ns) for s in clip(spans, window) if s.name != ROOT]
    busy_ns = harness.union_seconds(busy)
    if busy_ns >= hi - lo:
        return None
    return 100.0 * (harness.union_seconds(busy + open_) - busy_ns) / (hi - lo - busy_ns)


def stage_s_per_job(spans: list, window: tuple, stage: str, n_jobs: int) -> float | None:
    """Self seconds of the stage's spans in the window, over every process
    and thread, a job of the window."""
    inside = clip(spans, window)
    if not n_jobs or not any(s.name in STAGES[stage] for s in inside):
        return None
    return sum(b - a for a, b, name in self_pieces(inside) if name in STAGES[stage]) / 1e9 / n_jobs


def pool_wait_p95_s(spans: list, window: tuple) -> float | None:
    """95th percentile of the window's `pool.wait` spans: from a unit's
    hand-over to the region pool to its start in a worker, in s."""
    waits = [(s.end_ns - s.start_ns) / 1e9 for s in clip(spans, window) if s.name == "pool.wait"]
    return harness.quantile(waits, 0.95) if waits else None


def overhangs(ops: list, spans: list, pid: int, names) -> list:
    """For each device operation (start_ns, end_ns) of process `pid`, how
    far in ns it reaches outside the nearest span of `names` of that
    process: 0 where one holds it whole."""
    mine = sorted((s.start_ns, s.end_ns) for s in spans if s.pid == pid and s.name in names)
    out = []
    for a, b in ops:
        out.append(min((max(0, s - a) + max(0, b - e) for s, e in mine), default=None))
    return out
