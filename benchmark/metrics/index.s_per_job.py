"""Self seconds of the port's `graph.build` and `index.build` spans (each
call iteration's `construct_graph` and `index_graph`) in the window,
summed over every process and thread, a job of the window; nothing where
the run recorded no such span."""

from benchmark.spans import stage_s_per_job


def read(run):
    return stage_s_per_job(run.spans, run.window, "index", len(run.jobs))
