"""`apply_tier` (csrc/site_scoring.cu) calls of this process: the least
time of their bytes at HBM bandwidth over the profiler's device time of
the operations each call launched (its memset and kernels), in %."""

from benchmark.harness import roofline_percent


def read(run):
    return roofline_percent(run.kernel_calls, "apply_tier")
