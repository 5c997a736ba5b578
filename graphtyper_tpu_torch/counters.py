"""Per-process event counters of the device path.

`COUNTS` is bumped where the event happens: a kernel wrapper adds one where
it launches its kernel, the plain versions where they run, the scorer and
the pileup by the rows they apply. Region workers (pipeline/genotype.py)
return their own counts with each output path; the parent adds those to
`WORKERS`, never to `COUNTS`, and `totals()` reports the sum of the two.
"""

from __future__ import annotations

from collections import Counter

#: events in this process
COUNTS: Counter = Counter()
#: events reported back by region worker processes this process started
WORKERS: Counter = Counter()


def reset() -> None:
    COUNTS.clear()
    WORKERS.clear()


def totals() -> dict:
    out = Counter(COUNTS)
    out.update(WORKERS)
    return dict(out)
