"""The port's device seeding (ops/seed_probe.py) against the JAX package's,
on the CPU device: `probe_bits` (its plain PyTorch version on CPU tensors)
equals `_probe_bits_impl` bit for bit, the seeder's bitset is the engine's
gt_build_seed_bitset and equals `build_bitset`, and `genotype` with
device_seed on writes the VCF of its own off run and of the JAX package,
byte for byte (the inputs of tests/ops/test_seed_probe.py:132)."""

import gzip
import types
from dataclasses import replace

import numpy as np
import pytest
import torch

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.ops import seed_probe as ref_seed_probe
from graphtyper_tpu.pipeline import genotype as ref_genotype
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.ops import seed_probe
from graphtyper_tpu_torch.ops.seed_probe import DeviceSeeder, probe_bits, stage_kmers
from graphtyper_tpu_torch.pipeline import genotype as port_genotype
from test_torch_device_align_batches import synthetic_index, synthetic_rows


def test_ham_masks_match_reference():
    for got, want in zip(seed_probe._ham_masks(), ref_seed_probe._ham_masks()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [14, 24])
@pytest.mark.parametrize("nk", [2, 4, 8])
def test_probe_bits_match_reference(nk, bits):
    """At 14 bits about a third of the probes pass, at 24 (a pool's size)
    few; the rows hold invalid kmers and the special keys."""
    idx = synthetic_index(0)
    hi, lo, valid, *_ = synthetic_rows(idx, nk, seed=20 + nk)
    words = seed_probe.build_bitset(idx["keys"], bits)
    want = np.asarray(ref_seed_probe._probe_bits_impl(hi, lo, valid, words, nk=nk, bits=bits))
    before = counters.COUNTS["seed_probe_plain"]
    got = probe_bits(*(torch.from_numpy(a) for a in (hi, lo, valid, words)), bits)
    assert counters.COUNTS["seed_probe_plain"] == before + 1
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_seeder_bitset_is_the_engines():
    """DeviceSeeder builds its bitset with the engine's gt_build_seed_bitset;
    it equals the numpy build and the JAX package's seeder's."""
    keys = np.sort(np.random.default_rng(11).integers(0, 2**63, size=1000, dtype=np.uint64))
    bits = seed_probe.bitset_bits_for(len(keys))
    seeder = DeviceSeeder(keys, "cpu", bits=bits)
    np.testing.assert_array_equal(seeder.bitset.numpy(), seed_probe.build_bitset(keys, bits))
    np.testing.assert_array_equal(seeder.bitset.numpy(),
                                  np.asarray(ref_seed_probe.DeviceSeeder(keys, bits=bits).bitset))


def test_seeder_words_match_reference():
    """DeviceSeeder.probe_bits on staged, row-padded matrices: the first
    n_rows rows of the candidate words, as the JAX package's seeder gives
    them."""
    idx = synthetic_index(0)
    hi, lo, valid, *_ = synthetic_rows(idx, 4, seed=3)
    got = DeviceSeeder(idx["keys"], "cpu").probe_bits(stage_kmers(hi, lo, valid, "cpu"), len(hi), 4)
    want = ref_seed_probe.DeviceSeeder(idx["keys"]).probe_bits(
        ref_seed_probe.stage_kmers(hi, lo, valid), len(hi), 4)
    assert got.dtype == np.uint32 and got.shape == (len(hi), seed_probe.prow_for(4))
    np.testing.assert_array_equal(got, want)


def test_genotype_device_seed_parity(tmp_path):
    """genotype with device_seed on writes its off run's VCF and the JAX
    package's, byte for byte; the seed pass ran on the CPU device."""
    cfg = SimConfig(region_length=30_000, coverage=25.0, seed=13, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "c"), cfg)
    region = f"{cfg.chrom}:1-30000"
    outs = {}
    try:
        for mode in ("off", "on"):
            config.set_options(replace(config.DEFAULT_OPTIONS, device_seed=mode))
            counters.reset()
            out = port_genotype.genotype(sim.fasta, sim.sams, region, str(tmp_path / f"port_{mode}"),
                                         "cpu")
            outs[mode] = gzip.open(out, "rb").read()
            assert (counters.totals().get("seed_probe_plain", 0) > 0) == (mode == "on")
        ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, device_seed="on"))
        out = ref_genotype.genotype(sim.fasta, sim.sams, region, str(tmp_path / "ref_on"))
        ref = gzip.open(out, "rb").read()
    finally:
        config.set_options(config.DEFAULT_OPTIONS)
        ref_config.set_options(ref_config.DEFAULT_OPTIONS)
    assert outs["on"] == outs["off"]
    assert outs["on"] == ref


def test_seeder_on_a_card_free_host_raises(monkeypatch, tmp_path):
    """A non-CPU tensor goes to the kernel or raises; with no nvcc the build
    fails and the plain version does not run. Meta tensors stand in for
    CUDA ones."""
    from graphtyper_tpu_torch import kernels

    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernel_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    t = torch.zeros((1024, 4), dtype=torch.uint32, device="meta")
    before = counters.COUNTS["seed_probe_plain"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        probe_bits(t, t, torch.zeros((1024, 4), dtype=torch.uint8, device="meta"),
                   torch.zeros(1 << 19, dtype=torch.uint32, device="meta"), 24)
    assert counters.COUNTS["seed_probe_plain"] == before
