"""The largest VmRSS summed over the harness's descendants (the region
workers), sampled each second over the window, in GiB: the region pool's
part of `peak_rss_gib`. Nothing to read where the jobs run in process."""


def read(run):
    if not run.workers_rss_bytes:
        return None
    return run.workers_rss_bytes / 2**30
