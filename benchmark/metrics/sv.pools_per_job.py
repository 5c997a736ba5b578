"""Call pools of the window's `genotype_sv` jobs (the port's `sv_pools`
counter: the pools a job's samples split into over its `--threads` pool
threads) per job of the window; nothing where the program keeps no such
counter."""


def read(run):
    n = run.counters.get("sv_pools")
    return n / len(run.jobs) if n is not None and run.jobs else None
