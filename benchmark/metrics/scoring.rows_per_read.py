"""Scoring rows applied on the device (the sum of `device_rows` of the
GT_SCORING_STATS lines of every process) per read of the window."""


def read(run):
    if not run.scoring_stats:
        return None
    return sum(d.get("device_rows", 0) for d in run.scoring_stats) / run.reads
