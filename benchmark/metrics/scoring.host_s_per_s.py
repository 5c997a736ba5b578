"""Host seconds that the call iterations' scoring spends staging,
launching and collecting its flushes (the sum of `device_wall_s` of the
GT_SCORING_STATS lines of every process) per second of the window. The
telemetry's name says device; the time is the host's."""


def read(run):
    if not run.scoring_stats:
        return None
    return sum(d.get("device_wall_s", 0.0) for d in run.scoring_stats) / run.window_s
