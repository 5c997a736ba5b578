"""Share of the window in which no kernel ran on the card, by NVML's
GPU-utilization counter (every process on the card; whole percent over
each NVML sample period, read every 100 ms), in %."""


def read(run):
    if not run.util_samples:
        return None
    return 100.0 - sum(u for _, u in run.util_samples) / len(run.util_samples)
