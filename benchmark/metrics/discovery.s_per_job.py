"""Self seconds of the port's `discovery` and `discovery.pileup` spans
(`streamlined_discovery`, up to the pileup's copy back) in the window,
summed over every process and thread, a job of the window; nothing where
the run recorded no such span."""

from benchmark.spans import stage_s_per_job


def read(run):
    return stage_s_per_job(run.spans, run.window, "discovery", len(run.jobs))
