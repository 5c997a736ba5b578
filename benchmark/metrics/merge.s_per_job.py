"""Self seconds of the port's `merge`, `write` and `sites.write` spans
(`vcf_merge_and_filter`, `vcf_merge_and_break`, the copy of the results,
the it1 sites VCF) in the window, summed over every process and thread,
a job of the window; nothing where the run recorded no such span."""

from benchmark.spans import stage_s_per_job


def read(run):
    return stage_s_per_job(run.spans, run.window, "merge", len(run.jobs))
