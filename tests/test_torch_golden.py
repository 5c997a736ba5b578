"""The port's `genotype_regions` on the CPU device, with device_align off
and on, against the absolute goldens of tests/pipeline/test_golden_e2e.py:
the same two simulated workloads must hash to the same VCF record
sections (headers excluded)."""

import importlib.util
import os
import pathlib
from dataclasses import replace

import pytest

from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu.utils.simulate_indep import IndepConfig, simulate_indep
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.pipeline import genotype as port_genotype

_spec = importlib.util.spec_from_file_location(
    "golden_e2e", pathlib.Path(__file__).resolve().parent / "pipeline" / "test_golden_e2e.py")
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)

WORKLOADS = {  # golden_e2e's test_golden_snp_cohort and test_golden_indep_indel_rich
    "snp": (lambda d: simulate_cohort(d, SimConfig(region_length=50_000, coverage=30.0, n_samples=2,
                                                   seed=7, out_format="bam")),
            "chrS:1-50000", golden.GOLDEN_SNP),
    "indep": (lambda d: simulate_indep(d, IndepConfig(region_length=40_000, coverage=25.0, seed=3)),
              "chrI:1-40000", golden.GOLDEN_INDEP),
}


@pytest.mark.parametrize("device_align", ["off", "on"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_port_matches_golden(tmp_path, workload, device_align):
    make, region, want = WORKLOADS[workload]
    sim = make(os.path.join(str(tmp_path), "m"))
    config.set_options(replace(config.DEFAULT_OPTIONS, device_align=device_align))
    counters.reset()
    try:
        outs = port_genotype.genotype_regions(sim.fasta, sim.sams, region,
                                              os.path.join(str(tmp_path), "o"), "cpu", processes=1)
    finally:
        config.set_options(config.DEFAULT_OPTIONS)
    assert golden._hash(outs) == want
    assert (counters.totals().get("device_align_rows", 0) > 0) == (device_align == "on")
