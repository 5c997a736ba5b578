"""Self seconds of the port's `scoring.flush` and `scoring.materialize`
spans (`ObsBatcher`'s flushes: staging, launch, collect, and the fold into
site state) in the window, summed over every thread, a job of the window;
nothing where the run recorded no such span."""

from benchmark.spans import stage_s_per_job


def read(run):
    return stage_s_per_job(run.spans, run.window, "scoring", len(run.jobs))
