"""The largest VmRSS summed over the run's process tree (the harness and
its region workers), sampled each second over the window, in GiB."""


def read(run):
    return run.peak_rss_bytes / 2**30
