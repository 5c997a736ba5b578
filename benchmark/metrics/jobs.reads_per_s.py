"""Simulated reads of all jobs in the window over the window's measured
seconds, as `reads_per_s` takes them, in a cell whose rate spreads too
widely from run to run to carry a bound."""

from benchmark.harness import window_rate


def read(run):
    return window_rate(run.jobs, run.window_s)
