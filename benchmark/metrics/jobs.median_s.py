"""Median wall of the window's jobs, from the harness's job timers; it
stands beside the tail, never in its place."""

from benchmark.harness import median


def read(run):
    return median([j.wall_s for j in run.jobs])
