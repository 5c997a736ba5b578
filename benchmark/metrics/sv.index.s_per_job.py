"""Self seconds of the port's `graph.build` and `index.build` spans in a
`genotype_sv` cell (the SV graph of the job's region, padded 200 kb past
its end, and its k-mer index) in the window, summed over every process
and thread, a job of the window; nothing where the run recorded no such
span."""

from benchmark.spans import stage_s_per_job


def read(run):
    return stage_s_per_job(run.spans, run.window, "index", len(run.jobs))
