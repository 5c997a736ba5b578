"""Discovery pileup rows (the port's `pileup_rows` counter, all processes)
per read of the window."""


def read(run):
    return run.counters.get("pileup_rows", 0) / run.reads
