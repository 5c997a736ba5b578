"""Self seconds of the port's `bamshrink` spans (`run_bamshrink`: the
shrink of every sample's reads to the unit) in the window, summed over
every process and thread, a job of the window; nothing where the run
recorded no such span."""

from benchmark.spans import stage_s_per_job


def read(run):
    return stage_s_per_job(run.spans, run.window, "bamshrink", len(run.jobs))
