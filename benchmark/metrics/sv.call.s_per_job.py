"""Self seconds of the port's `call.pool` spans in a `genotype_sv` cell
(the one call pool of every sample: reading, aligning to the SV graph,
scoring; less its `sv.reformat`) in the window, summed over every process
and thread, a job of the window; nothing where the run recorded no such
span."""

from benchmark.spans import stage_s_per_job


def read(run):
    return stage_s_per_job(run.spans, run.window, "call", len(run.jobs))
