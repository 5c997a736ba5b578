"""95th percentile of the wall of every job in the window."""

from benchmark.harness import quantile


def read(run):
    return quantile([j.wall_s for j in run.jobs], 0.95)
