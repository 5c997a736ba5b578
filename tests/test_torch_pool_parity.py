"""Multi-pool and end-to-end parity of the port on the CPU device: the
inputs of tests/pipeline/test_pool_merge.py (six samples; max_files_open
864 and 2; threads 1, 3 and the default, which splits the cohort into one
pool a thread) and of tests/pipeline/test_genotype_e2e.py, each held to the
JAX package's VCF at threads=1 (the only safe reference: the JAX package's
prepared-pool cache frees pools in use when more than four run at once).
##fileDate is masked."""

import gzip
import importlib.util
import os
from dataclasses import replace

import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.graph.build import construct_graph as ref_construct_graph
from graphtyper_tpu.pipeline import genotype as ref_genotype
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch import config
from graphtyper_tpu_torch.pipeline import genotype as port_genotype

TESTS = os.path.dirname(os.path.abspath(__file__))


def _masked(path):
    with gzip.open(path, "rt") as f:
        return ["##fileDate=" if line.startswith("##fileDate=") else line for line in f.read().splitlines()]


def _reset():
    for cfg in (config, ref_config):
        cfg.set_options(cfg.DEFAULT_OPTIONS)


def _run_both(root, name, fn_name, args, ref_opts, port_opts):
    """The JAX package's `fn_name` at threads=1 and the port's on the CPU
    device with `port_opts`; both VCFs, masked."""
    _reset()
    try:
        ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, threads=1, **ref_opts))
        want = getattr(ref_genotype, fn_name)(*args, str(root / f"{name}_ref"))
        config.set_options(replace(config.DEFAULT_OPTIONS, **port_opts))
        got = getattr(port_genotype, fn_name)(*args, str(root / f"{name}_port"), "cpu")
    finally:
        _reset()
    return _masked(got), _masked(want)


# tests/pipeline/test_pool_merge.py:80-126
POOL_COHORTS = {
    "merge": SimConfig(region_length=5000, coverage=14.0, n_samples=6, seed=51),
    "threaded": SimConfig(region_length=5000, coverage=12.0, n_samples=6, seed=53, out_format="bam"),
}


@pytest.fixture(scope="module")
def pool_cohorts(tmp_path_factory):
    root = tmp_path_factory.mktemp("pool_parity")
    sims = {name: simulate_cohort(str(root / name), cfg) for name, cfg in POOL_COHORTS.items()}
    _reset()
    try:
        ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, threads=1, max_files_open=864))
        refs = {name: _masked(ref_genotype.genotype(sim.fasta, sim.sams, f"{POOL_COHORTS[name].chrom}:1-5000",
                                                    str(root / f"{name}_ref")))
                for name, sim in sims.items()}
    finally:
        _reset()
    return root, sims, refs


@pytest.mark.parametrize("cohort", sorted(POOL_COHORTS))
@pytest.mark.parametrize("max_files_open", [864, 2])
@pytest.mark.parametrize("threads", [1, 3, None])
def test_pools_match_single_thread_reference(pool_cohorts, cohort, max_files_open, threads):
    root, sims, refs = pool_cohorts
    sim = sims[cohort]
    opts = dict(max_files_open=max_files_open)
    if threads is not None:
        opts["threads"] = threads
    config.set_options(replace(config.DEFAULT_OPTIONS, **opts))
    try:
        out = port_genotype.genotype(sim.fasta, sim.sams, f"{POOL_COHORTS[cohort].chrom}:1-5000",
                                     str(root / f"{cohort}_{max_files_open}_{threads}"), "cpu")
    finally:
        _reset()
    got = _masked(out)
    assert any(not line.startswith("#") for line in got)
    assert got == refs[cohort]


def _simulate_sam():
    spec = importlib.util.spec_from_file_location(
        "genotype_e2e_inputs", os.path.join(TESTS, "pipeline", "test_genotype_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.simulate_sam


@pytest.mark.parametrize("case", ["het", "homalt"])
def test_genotype_with_a_vcf_matches_reference(data_dir, tmp_path, case):
    """test_genotype_e2e.py's one-sample SAMs drawn from graph haplotypes,
    through `genotype_only_with_a_vcf`."""
    fa, vcf = str(data_dir / "index_test.fa"), str(data_dir / "index_test.vcf.gz")
    chrom, n_pairs = ("chr1", 30) if case == "het" else ("chr3", 25)
    ref = ref_construct_graph(fa, vcf, chrom).get_all_ref()
    haps = [ref, ref[:36] + b"G" + ref[37:]] if case == "het" else [ref[:30] + b"GA" + ref[31:]]
    sam = tmp_path / "s.sam"
    _simulate_sam()(sam, chrom, 66, haps, n_pairs=n_pairs)
    got, want = _run_both(tmp_path, case, "genotype_only_with_a_vcf", (fa, [str(sam)], vcf, chrom), {}, {})
    assert any(not line.startswith("#") for line in got)
    assert got == want


# test_genotype_e2e.py's simulated cohorts: (SimConfig, options, with a VCF)
E2E_CASES = {
    "bamshrink": (SimConfig(region_length=6000, coverage=20.0, seed=61), {}, False),
    "primer": (SimConfig(region_length=5000, coverage=16.0, seed=71), "primer", True),
    "differential": (SimConfig(region_length=20_000, coverage=18.0, n_samples=2, seed=101, out_format="bam",
                               indel_rate=0.002, error_rate=0.005), {}, False),
    "hq_reads": (SimConfig(region_length=20_000, coverage=18.0, n_samples=2, seed=101, out_format="bam",
                           indel_rate=0.002, error_rate=0.005), dict(hq_reads=True), False),
    "csi": (SimConfig(region_length=8000, coverage=14.0, seed=5, out_format="bam"), dict(is_csi=True), False),
}


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_e2e_cohorts_match_reference(tmp_path, case):
    cfg, opts, with_vcf = E2E_CASES[case]
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    region = f"{cfg.chrom}:1-{cfg.region_length}"
    if opts == "primer":
        bedpe = str(tmp_path / "p.bedpe")
        with open(bedpe, "w") as f:
            f.write(f"{cfg.chrom}\t1000\t1030\t{cfg.chrom}\t1400\t1430\n")
        opts = dict(primer_bedpe=bedpe)
    if with_vcf:
        got, want = _run_both(tmp_path, case, "genotype_only_with_a_vcf", (sim.fasta, sim.sams, sim.vcf, region),
                              opts, opts)
    else:
        got, want = _run_both(tmp_path, case, "genotype", (sim.fasta, sim.sams, region), opts, opts)
    assert sum(not line.startswith("#") for line in got) > 0
    assert got == want
