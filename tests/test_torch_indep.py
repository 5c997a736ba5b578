"""The port's utils/simulate_indep.py against the JAX package's, and the
port's `genotype` on the CPU device on the independent CRAM workload:

- for a given seed the FASTA, the sites VCF, each CRAM and the truth
  equal the JAX package's byte for byte (one process, one zlib);
- on tests/pipeline/test_indep_workload.py's recipe (40 kb, 1 sample,
  28x, seed 11) the port's VCF records equal the JAX package's, and
  the recall over the truth sites is what that test asks of it."""

import gzip
import importlib.util
import os
import pathlib
from dataclasses import replace

import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline import genotype as ref_genotype
from graphtyper_tpu.utils.simulate_indep import IndepConfig as RefIndepConfig
from graphtyper_tpu.utils.simulate_indep import simulate_indep as ref_simulate_indep
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.pipeline import genotype as port_genotype
from graphtyper_tpu_torch.simulate import IndepConfig, simulate_indep

TESTS = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("indep_workload", TESTS / "pipeline" / "test_indep_workload.py")
indep_workload = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(indep_workload)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed,kw", [(3, dict(region_length=8_000, n_samples=1, coverage=10.0)),
                                     (21, dict(region_length=20_000, n_samples=2, coverage=8.0))])
def test_simulate_indep_byte_equal(tmp_path, seed, kw):
    got = simulate_indep(str(tmp_path / "port"), IndepConfig(seed=seed, **kw))
    want = ref_simulate_indep(str(tmp_path / "ref"), RefIndepConfig(seed=seed, **kw))
    assert got.n_reads == want.n_reads > 0
    assert list(got.truth.items()) == list(want.truth.items())
    assert len(got.sams) == len(want.sams) == kw["n_samples"]
    for a, b in [(got.fasta, want.fasta), (got.vcf, want.vcf), *zip(got.sams, want.sams)]:
        assert os.path.basename(a) == os.path.basename(b)
        assert _bytes(a) == _bytes(b), os.path.basename(a)


def _records(path):
    with gzip.open(path, "rt") as f:
        return [line for line in f if not line.startswith("#")]


def test_port_genotype_on_indep_workload(tmp_path):
    cfg = IndepConfig(region_length=40_000, n_samples=1, coverage=28.0, seed=11)
    res = simulate_indep(str(tmp_path / "sim"), cfg)
    assert res.n_reads > 5_000 and all(s.endswith(".cram") for s in res.sams)
    region = f"{cfg.chrom}:1-{cfg.region_length}"
    for c in (config, ref_config):
        c.set_options(c.DEFAULT_OPTIONS)
    try:
        ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, threads=1))
        want = ref_genotype.genotype(res.fasta, res.sams, region, str(tmp_path / "ref"))
        counters.reset()
        got = port_genotype.genotype(res.fasta, res.sams, region, str(tmp_path / "port"), "cpu")
        seen = counters.totals()
    finally:
        for c in (config, ref_config):
            c.set_options(c.DEFAULT_OPTIONS)
    records = _records(got)
    assert records == _records(want)
    # the realignment ran (on the plain version, on the CPU)
    assert seen.get("sw_plain", 0) > 0 and seen.get("scoring_rows", 0) > 0, seen

    calls = indep_workload._load_calls(got)
    assert len(calls) > 50
    truth_sites = [(pos, gts[0]) for (pos, _r, _a), gts in res.truth.items() if gts[0] != (0, 0)]
    called = {}
    for (pos, _r, _a), gt in calls.items():
        called.setdefault(pos, []).append(gt)
    hit = sum(any(gt not in ("0/0", "./.") for p in range(pos - 24, pos + 27) for gt in called.get(p, []))
              for pos, _ in truth_sites)
    assert len(truth_sites) > 40 and hit / len(truth_sites) > 0.85
