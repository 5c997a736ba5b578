"""`sw_rot` kernel launches of realignment (the port's counter, all
processes) per job of the window."""


def read(run):
    return run.counters.get("sw_rot", 0) / len(run.jobs)
