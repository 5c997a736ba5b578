"""Per-process event counters of the device path.

`COUNTS` is bumped where the event happens, through `add`: a kernel
wrapper adds one where it launches its kernel, the plain versions where
they run, the scorer and the pileup by the rows they apply. Call pools
bump from several threads at once, so every update takes `_LOCK` (a `+=`
on a Counter is a read, an add and a write, and two threads can lose one).
Region workers (pipeline/genotype.py) return their own counts with each
output path; the parent adds those to `WORKERS`, never to `COUNTS`, and
`totals()` reports the sum of the two.
"""

from __future__ import annotations

import threading
from collections import Counter

#: events in this process
COUNTS: Counter = Counter()
#: events reported back by region worker processes this process started
WORKERS: Counter = Counter()
_LOCK = threading.Lock()


def add(key: str, n: int | float = 1) -> None:
    """COUNTS[key] += n, safe from several threads."""
    with _LOCK:
        COUNTS[key] += n


def reset() -> None:
    with _LOCK:
        COUNTS.clear()
        WORKERS.clear()


def totals() -> dict:
    with _LOCK:
        out = Counter(COUNTS)
        out.update(WORKERS)
    return dict(out)
