"""SV alleles in the SV graphs of the window's jobs (the port's
`sv_alleles` counter: each breakpoint allele apart, so an insertion or a
duplication with two breakpoints counts two) per job of the window;
nothing where the program keeps no such counter."""


def read(run):
    n = run.counters.get("sv_alleles")
    return n / len(run.jobs) if n is not None and run.jobs else None
