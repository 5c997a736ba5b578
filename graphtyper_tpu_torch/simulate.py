"""Simulated cohorts for driving the port: a reference FASTA and one BAM per
sample, made from a seed. The simulator is the shared host layer's
(graphtyper_tpu/utils/simulate.py, numpy only); this module names it for
the port's drivers, such as chip_smoke.py.
"""

from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort

__all__ = ["SimConfig", "simulate_cohort"]
