"""The port's whole `genotype` path on the CPU device against the JAX
package's, on one small noisy cohort whose discovery reaches indel
realignment: byte-identical VCF bodies (md5 of the uncompressed outputs).
Run serially, over two spawn region workers, and with the streaming caller."""

import gzip
import hashlib
from dataclasses import replace

import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline import genotype as ref_genotype
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.pipeline import genotype as port_genotype

# a cohort whose realignment outcomes reach the VCF: with every SW result
# discarded, the port writes another VCF
CFG = SimConfig(region_length=50_000, coverage=10, n_samples=4, error_rate=0.02, out_format="bam",
                seed=2)
REGION = f"{CFG.chrom}:1-{CFG.region_length}"
UNIT = 25_000  # two region units, so processes=2 really fans out


def _md5(paths):
    h = hashlib.md5()
    for p in sorted(paths):
        with gzip.open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    sim = simulate_cohort(str(root / "sim"), CFG)
    _reset_options()  # genotype_regions tunes the global options per cohort
    try:
        outs = ref_genotype.genotype_regions(
            sim.fasta, sim.sams, REGION, str(root / "ref"), max_region_size=UNIT, processes=1
        )
    finally:
        _reset_options()
    return sim, root, _md5(outs)


def _reset_options():
    """Each package reads its own options; both start from the defaults."""
    for cfg in (config, ref_config):
        cfg.set_options(cfg.DEFAULT_OPTIONS)


@pytest.mark.parametrize("processes,streaming", [(1, "auto"), (2, "auto"), (1, "on")])
def test_port_matches_reference_vcf(cohort, processes, streaming):
    sim, root, ref_md5 = cohort
    _reset_options()
    config.set_options(replace(config.DEFAULT_OPTIONS, streaming_caller=streaming))
    counters.reset()
    try:
        outs = port_genotype.genotype_regions(
            sim.fasta, sim.sams, REGION, str(root / f"port_{processes}_{streaming}"), "cpu",
            max_region_size=UNIT, processes=processes,
        )
    finally:
        _reset_options()
        port_genotype.shutdown_region_pool()
    assert len(outs) == 2
    assert _md5(outs) == ref_md5
    seen = counters.totals()
    assert seen.get("sw_plain", 0) >= 1, seen  # realignment reached the SW path
    assert seen.get("scoring_rows", 0) > 0 and seen.get("pileup_rows", 0) > 0, seen
    assert seen.get("sw_rot", 0) == 0, seen  # no kernel launch on the CPU device
