"""CRAM input on the card: the independent workload
(utils/simulate_indep.py: Markov reference, clustered indel-rich sites,
adapter soft clips, one CRAM) at 40 kb through the port's `genotype` on
cuda and on the CPU device, one md5 of the VCF records, with the SW kernel
launched and no plain version on the card's run. Skips without a GPU; run
on the card with
  python -m pytest tests/test_torch_indep_cuda.py -q
"""

import gzip
import hashlib

import pytest
import torch

pytestmark = pytest.mark.gpu


def _records_md5(path):
    h = hashlib.md5()
    with gzip.open(path, "rt") as f:
        for line in f:
            if not line.startswith("#"):
                h.update(line.encode())
    return h.hexdigest()


def test_indep_cram_workload_cuda_matches_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from graphtyper_tpu_torch import config, counters
    from graphtyper_tpu_torch.pipeline.genotype import genotype
    from graphtyper_tpu_torch.simulate import IndepConfig, simulate_indep

    cfg = IndepConfig(region_length=40_000, n_samples=1, coverage=28.0, seed=11)
    sim = simulate_indep(str(tmp_path / "sim"), cfg)
    assert all(s.endswith(".cram") for s in sim.sams)
    region = f"{cfg.chrom}:1-{cfg.region_length}"
    config.set_options(config.DEFAULT_OPTIONS)
    counters.reset()
    card = genotype(sim.fasta, sim.sams, region, str(tmp_path / "cuda"), "cuda")
    seen = counters.totals()
    host = genotype(sim.fasta, sim.sams, region, str(tmp_path / "cpu"), "cpu")
    assert seen.get("sw_rot", 0) > 0 and seen.get("scoring_rows", 0) > 0, seen
    assert not {k: v for k, v in seen.items() if k.endswith("_plain")}, seen
    assert _records_md5(card) == _records_md5(host)
