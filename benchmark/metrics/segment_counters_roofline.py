"""`segment_counters` (csrc/discovery_pileup.cu) calls of this process:
the least time of their bytes at HBM bandwidth over the profiler's device
time of the operations each call launched (its memset and kernel), in %."""

from benchmark.harness import roofline_percent


def read(run):
    return roofline_percent(run.kernel_calls, "segment_counters")
