"""The port's device alignment (ops/device_align.py and its hooks in
pipeline/native_caller.py) against the JAX package's, on the CPU device.

Op level: the port's `DeviceAligner.verdicts` (its plain PyTorch version on
CPU tensors) equals the JAX package's `DeviceAligner.verdicts` (XLA on the
CPU) in all 9 columns of every row: on the synthetic adversarial batches of
tests/test_torch_device_align_batches.py at nk = 2, 4 and 8, and on the
engine's rows of a small cohort against each package's own graph and index.

Pipeline level: the port's pooled call with device_align off, on and
verify, in memory and streaming, on the cohorts of
tests/pipeline/test_device_align.py, leaves the scorer in the JAX
package's state and gives its (clean, fallback, 0) stats.

No fallback: the port raises where the JAX package would quietly align on
the host. Integer outputs everywhere, tolerance 0."""

import types
from dataclasses import replace

import numpy as np
import pytest
import torch

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.graph.build import construct_graph as ref_construct_graph
from graphtyper_tpu.graph.coords import GenomicRegion as RefRegion
from graphtyper_tpu.index.build import index_graph as ref_index_graph
from graphtyper_tpu.ops import device_align as ref_device_align
from graphtyper_tpu.ops import seed_probe as ref_seed_probe
from graphtyper_tpu.pipeline import native_caller as ref_native_caller
from graphtyper_tpu.pipeline.caller import call_pool as ref_call_pool
from graphtyper_tpu.typer.native_align import NativeAligner as RefNativeAligner
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch import config, counters, kernels
from graphtyper_tpu_torch.graph.build import construct_graph
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.index.build import index_graph
from graphtyper_tpu_torch.io.native import get_lib
from graphtyper_tpu_torch.ops.device_align import DeviceAligner, stage_tails
from graphtyper_tpu_torch.ops.seed_probe import stage_kmers
from graphtyper_tpu_torch.pipeline import native_caller
from graphtyper_tpu_torch.pipeline.caller import call_pool
from graphtyper_tpu_torch.typer.native_align import NativeAligner
from test_torch_device_align_batches import arena_edge_index, arena_edge_rows, synthetic_index, synthetic_rows
from test_torch_site_scoring import _site_state

# tests/pipeline/test_device_align.py's cohorts
RECIPES = {
    "clean_41": dict(region_length=9000, coverage=22.0, n_samples=2, seed=41, error_rate=0.001),
    "indel_rich_42": dict(region_length=7000, coverage=18.0, n_samples=2, seed=42, error_rate=0.01,
                          snp_rate=1 / 120.0, indel_rate=1 / 600.0),
    "on_43": dict(region_length=9000, coverage=22.0, n_samples=2, seed=43, error_rate=0.002),
    "stream_44": dict(region_length=9000, coverage=22.0, n_samples=3, seed=44, error_rate=0.002),
}


def _reference_verdicts(na, rows):
    hi, lo, valid, tails, lens = rows
    dal = ref_device_align.DeviceAligner(na)
    return dal.verdicts(ref_seed_probe.stage_kmers(hi, lo, valid),
                        *ref_device_align.stage_tails(tails, lens), len(lens), hi.shape[1])


def _port_verdicts(na, rows):
    hi, lo, valid, tails, lens = rows
    dal = DeviceAligner(na, "cpu")
    return dal.verdicts(stage_kmers(hi, lo, valid, "cpu"), *stage_tails(tails, lens, "cpu"),
                        len(lens), hi.shape[1])


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_verdicts_match_reference_on_synthetic_rows(nk):
    idx = synthetic_index(0)
    na = types.SimpleNamespace(**idx)
    rows = synthetic_rows(idx, nk, seed=nk)
    want = _reference_verdicts(na, rows)
    before = counters.COUNTS["device_align_plain"]
    np.testing.assert_array_equal(_port_verdicts(na, rows), want)
    assert counters.COUNTS["device_align_plain"] == before + 1
    meta = want[:, 0]
    # the batch reaches every rule: clean rows, tail mismatches, crossed
    # variants beyond the 6 slots, ids >= 2^24, and a slot that wrapped
    assert (meta & 1).any() and ((meta >> 1) & 7).any() and (meta >> 4 == 6).any()
    assert (want[:, 3:] >= 1 << 24).any() and (want[:, 3:] < -1).any()


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_verdicts_match_reference_at_the_arena_edges(nk):
    """Tails whose arena bytes run past the arena's start and its end: each
    byte's index is clamped, in the mismatch count of every row."""
    idx = arena_edge_index(0)
    na = types.SimpleNamespace(**idx)
    rows = arena_edge_rows(idx, nk, seed=nk)
    lens = rows[-1]
    want = _reference_verdicts(na, rows)
    # the arena index of each row's first tail byte: the chain ends tail
    # bases before the row's end, in the node at or before it
    nk_r = np.minimum(np.where(lens >= 32, 1 + (lens - 32) // 31, 0), nk)
    tail = np.maximum(lens - 1 - 31 * nk_r, 0)
    chain_end = (want[:, 2].astype(np.int64) & 0xFFFFFFFF) - tail
    r = np.searchsorted(idx["ref_order"], chain_end, side="right") - 1
    first = idx["ref_dna_start"][r] + (chain_end - idx["ref_order"][r]) + 1
    assert ((first < 0) & (first + tail > 0)).any()  # past the arena's start
    n_arena = len(idx["ref_arena"])
    assert ((first < n_arena) & (first + tail > n_arena)).any()  # past its end
    np.testing.assert_array_equal(_port_verdicts(na, rows), want)


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """Each recipe's simulated BAMs, and its graph and index built by each
    package's own host layer."""
    out = {}
    for name, recipe in RECIPES.items():
        cfg = SimConfig(out_format="bam", **recipe)
        sim = simulate_cohort(str(tmp_path_factory.mktemp(name)), cfg)
        spec = f"{cfg.chrom}:1-{cfg.region_length}"
        port = construct_graph(sim.fasta, sim.vcf, spec, use_index=True)
        ref = ref_construct_graph(sim.fasta, sim.vcf, spec, use_index=True)
        out[name] = dict(sim=sim, spec=spec, port=(port, index_graph(port)),
                         ref=(ref, ref_index_graph(ref)))
    return out


def _engine_rows(cohort):
    """The engine's rows of the cohort's pool (gt_prep_fetch_kmers and
    gt_prep_fetch_tails, through the port's prepared-pool cache)."""
    lib = get_lib()
    native_caller._setup_lib(lib)
    entry = native_caller._get_prep(lib, cohort["sim"].sams, GenomicRegion.parse(cohort["spec"]),
                                    3840, False)
    try:
        return (*entry.fetch_kmers(lib), *entry.fetch_tails(lib))
    finally:
        entry.release(lib)


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_verdicts_match_reference_on_engine_rows(cohorts, nk):
    """The engine gives 151 bp reads 4 kmers; at nk = 2 every row's tail is
    misread (no row is clean), at 8 the extra columns are invalid."""
    cohort = cohorts["clean_41"]
    hi, lo, valid, tails, lens = _engine_rows(cohort)
    assert hi.shape[1] == 4 and len(lens) > 1000
    if nk < 4:
        hi, lo, valid = (np.ascontiguousarray(a[:, :nk]) for a in (hi, lo, valid))
    else:
        hi, lo, valid = (np.pad(a, ((0, 0), (0, nk - 4))) for a in (hi, lo, valid))
    rows = (hi, lo, valid, tails, lens)
    want = _reference_verdicts(RefNativeAligner(*cohort["ref"]), rows)
    got = _port_verdicts(NativeAligner(*cohort["port"]), rows)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] & 1).mean() > (0.3 if nk >= 4 else -1)


def _reset_options():
    for cfg in (config, ref_config):
        cfg.set_options(cfg.DEFAULT_OPTIONS)


def _run_pool(package, cohort, mode, stream):
    """One pooled call of `package` ("port" or "ref") with device_align =
    mode; (state, num_records, num_duplicated, device_align_stats())."""
    graph, index = cohort[package]
    sams = cohort["sim"].sams
    _reset_options()
    if package == "port":
        config.set_options(replace(config.DEFAULT_OPTIONS, device_align=mode))
        nc, region = native_caller, GenomicRegion.parse(cohort["spec"])
    else:
        ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, device_align=mode))
        nc, region = ref_native_caller, RefRegion.parse(cohort["spec"])
    dev = ("cpu",) if package == "port" else ()
    try:
        nc.device_align_stats()  # reset the engine's counters
        if stream:
            res = nc.run_native_call_pool_stream(graph, index, sams, region, *dev, batch_records=4096)
            assert res is not None
            _, scorer, n_rec, n_dup, _ = res
            scorer.finalize()
            calls = None
        else:
            call = call_pool if package == "port" else ref_call_pool
            res = call(graph, index, sams, *dev, region=region, is_writing_hap=True)
            scorer, n_rec, n_dup = res.scorer, res.num_records, res.num_duplicated
            calls = (dict(res.ph), [(v.abs_pos, v.seqs, [(c.phred.tolist(), c.coverage.tolist())
                                                          for c in v.calls])
                                    for v in res.vcf.variants])
        return (_site_state(scorer.sites), calls), n_rec, n_dup, nc.device_align_stats()
    finally:
        _reset_options()


@pytest.mark.parametrize("stream", [False, True], ids=["in_memory", "streaming"])
@pytest.mark.parametrize("mode", ["off", "on", "verify"])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_pool_matches_reference(cohorts, recipe, mode, stream):
    cohort = cohorts[recipe]
    counters.reset()
    port = _run_pool("port", cohort, mode, stream)
    seen = counters.totals()
    ref = _run_pool("ref", cohort, mode, stream)
    assert port[1:3] == ref[1:3]
    assert port[3] == ref[3]
    assert port[0] == ref[0]
    clean, fallback, bad = port[3]
    if mode == "off":
        assert (clean, fallback, bad) == (0, 0, 0) and "device_align_plain" not in seen
    else:
        assert clean > 0 and bad == 0, port[3]
        assert seen["device_align_plain"] >= 1 and seen["device_align_rows"] == clean + fallback
        assert seen.get("device_align", 0) == 0  # no kernel launch on the CPU device


def test_verify_state_equals_off(cohorts):
    """In verify mode the host result wins, so the state is the off run's;
    in on mode it is too, by the clean-tier rules."""
    cohort = cohorts["on_43"]
    off = _run_pool("port", cohort, "off", False)
    for mode in ("on", "verify"):
        got = _run_pool("port", cohort, mode, False)
        assert got[:3] == off[:3]
        clean, fallback, bad = got[3]
        assert bad == 0 and clean / (clean + fallback) > 0.3


def test_streaming_over_many_batches_equals_in_memory(cohorts):
    """Batches of 1024 records: the stage/step pipeline runs with two
    batches staged ahead across many batch boundaries."""
    cohort = cohorts["stream_44"]
    graph, index = cohort["port"]
    region = GenomicRegion.parse(cohort["spec"])
    states = {}
    for mode in ("off", "on"):
        _reset_options()
        config.set_options(replace(config.DEFAULT_OPTIONS, device_align=mode))
        try:
            native_caller.device_align_stats()
            counters.reset()
            _, scorer, n_rec, n_dup, _ = native_caller.run_native_call_pool_stream(
                graph, index, cohort["sim"].sams, region, "cpu", batch_records=1024)
            scorer.finalize()
            states[mode] = (_site_state(scorer.sites), n_rec, n_dup)
            if mode == "on":
                assert counters.COUNTS["device_align_plain"] >= 3
                assert native_caller.device_align_stats()[0] > 0
        finally:
            _reset_options()
    assert states["on"] == states["off"]


def test_device_align_without_a_card_raises(cohorts, monkeypatch):
    """device_align on a device other than the CPU goes to the kernel or
    raises: there is no card (and no nvcc) here, and nothing falls back to
    host alignment. Meta tensors stand in for CUDA ones."""
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    graph, index = cohorts["clean_41"]["port"]
    dal = DeviceAligner(NativeAligner(graph, index), "cpu")
    rows = [torch.zeros((1024, 4), dtype=torch.uint32, device="meta")] * 2
    rows.append(torch.zeros((1024, 4), dtype=torch.uint8, device="meta"))
    before = counters.COUNTS["device_align_plain"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dal.launch(rows, torch.zeros((1024, 32), dtype=torch.uint8, device="meta"),
                   torch.zeros(1024, dtype=torch.int32, device="meta"), 4)
    assert counters.COUNTS["device_align_plain"] == before


def test_device_aligner_refuses_an_empty_table():
    idx = synthetic_index(0)
    for name in ("keys", "ref_order", "ref_arena"):
        na = types.SimpleNamespace(**dict(idx, **{name: idx[name][:0]}))
        with pytest.raises(ValueError, match="empty"):
            DeviceAligner(na, "cpu")
