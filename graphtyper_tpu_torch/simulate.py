"""Simulated cohorts for driving the port: a reference FASTA and one BAM per
sample, made from a seed. The simulator is the port's copy of the host
layer's (utils/simulate.py, numpy only); this module names it for the
port's entry scripts, such as chip_smoke.py.
"""

from graphtyper_tpu_torch.utils.simulate import SimConfig, simulate_cohort

__all__ = ["SimConfig", "simulate_cohort"]
