"""Simulated cohorts for driving the port, made from a seed: a reference
FASTA and one BAM per sample (`simulate_cohort`), or the independent
workload's Markov reference, indel-rich clustered sites and one CRAM per
sample (`simulate_indep`). The simulators are the port's copies of the
host layer's (utils/simulate.py, utils/simulate_indep.py, numpy only);
this module names them for the port's entry scripts, such as
chip_smoke.py.
"""

from graphtyper_tpu_torch.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch.utils.simulate_indep import IndepConfig, simulate_indep

__all__ = ["IndepConfig", "SimConfig", "simulate_cohort", "simulate_indep"]
