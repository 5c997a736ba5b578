"""Seconds of the port's `call` spans on the `genotype_sv` path (those
opened right under a job's root: the job's call pools, on whichever
threads they run, and their reduce), duration and not self time, cut to
the window, a job of the window; nothing where the run recorded no such
span."""

from benchmark.spans import clip


def read(run):
    calls = [s for s in clip(run.spans, run.window) if s.name == "call" and s.parent == s.job]
    if not run.jobs or not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) / 1e9 / len(run.jobs)
