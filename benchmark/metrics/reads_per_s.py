"""Simulated reads of all jobs in the window over the window's measured
seconds: all the work over all the time."""

from benchmark.harness import window_rate


def read(run):
    return window_rate(run.jobs, run.window_s)
