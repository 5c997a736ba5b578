"""95th percentile of the window's `pool.wait` spans: from a unit's
hand-over to the region pool to its start in a worker, in s; nothing
where no unit went through the pool."""

from benchmark.spans import pool_wait_p95_s


def read(run):
    return pool_wait_p95_s(run.spans, run.window)
