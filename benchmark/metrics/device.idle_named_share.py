"""Share of the window's device-idle time (no operation of any process on
the card, by torch.profiler) in which some process of the port had a span
other than the root `job` open, in %: the idle time that the spans name.
Nothing where the run recorded no span."""

from benchmark.spans import idle_named_percent


def read(run):
    if not run.spans:
        return None
    return idle_named_percent(run.intervals, run.spans, run.window)
