"""The port's device ops on the card against the same ops on the CPU
(which tests/test_torch_site_scoring.py, test_torch_discovery_pileup.py
and test_torch_scoring_kernels.py hold to the JAX package): the scoring
kernel (csrc/site_scoring.cu) through `apply_tier`, `apply_tier_sharded`,
`flush_rows` from pinned and pageable memory and `ObsBatcher`, and the
pileup kernel (csrc/discovery_pileup.cu) through `segment_counters`, each
on random rows and on tests/test_torch_scoring_batches.py's adversarial
rows; and the verdict and seed-probe kernels
(csrc/device_align.cu, csrc/seed_probe.cu) against their plain PyTorch
versions on the card, on the synthetic adversarial batches, on the
arena-edge batch (verdicts) and at nk = 40 (seed probes, two chunks of 32
kmers), and on the engine's rows of a small cohort. Integer outputs,
tolerance 0. Skips
without a GPU; run on the card with
  python -m pytest tests/test_torch_ops_cuda.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_discovery_pileup import _rows
from test_torch_scoring_batches import SCORING_SHAPE, pileup_rows, scoring_rows
from test_torch_site_scoring import _padded_matrix, _random_cols

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("A", [2, 4, 8, 64])
def test_apply_tier_cuda_matches_cpu(cuda, A):
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier

    rng = np.random.default_rng(200 + A)
    n_sites, n_samples = 57, 4
    mat = torch.from_numpy(_padded_matrix(_random_cols(rng, 5000, A, n_sites, n_samples), 5000, 5120))
    got = apply_tier(mat.to(cuda), A, n_sites, n_samples).cpu()
    want = apply_tier(mat, A, n_sites, n_samples)
    assert torch.equal(got, want)


def test_segment_counters_cuda_matches_cpu(cuda):
    from graphtyper_tpu_torch.ops.discovery_pileup import segment_counters

    r = _rows(9, 200_000, 7000)
    mat = torch.from_numpy(np.stack([r[k].astype(np.int64) for k in (
        "r_ev", "r_dhq", "r_dlq", "r_bits", "r_mapq", "r_dist")]))
    assert torch.equal(segment_counters(mat.to(cuda), 7000).cpu(), segment_counters(mat, 7000))


@pytest.mark.parametrize("A", [2, 4, 8, 16, 32, 64])
def test_scoring_kernel_matches_plain_on_adversarial_rows(cuda, A):
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier, apply_tier_plain

    mat = torch.from_numpy(scoring_rows(A, 3))
    counters.reset()
    got = apply_tier(mat.to(cuda), A, *SCORING_SHAPE).cpu()
    assert dict(counters.COUNTS) == {"apply_tier": 1}
    assert torch.equal(got, apply_tier_plain(mat, A, *SCORING_SHAPE))


def test_scoring_flush_paths_match_the_cpu(cuda):
    """flush_rows from pinned memory (twice, the second flush larger than
    the first), from pageable memory, and over a 2-entry mesh of the card,
    against the CPU flush."""
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.site_scoring import flush_rows
    from graphtyper_tpu_torch.parallel.mesh import Mesh

    A = 16
    for seeds in ((0,), (1, 2, 3)):
        mat = torch.from_numpy(np.concatenate([scoring_rows(A, s) for s in seeds], axis=1))
        want = flush_rows(mat, A, *SCORING_SHAPE, torch.device("cpu"))
        counters.reset()
        assert torch.equal(flush_rows(mat.pin_memory(), A, *SCORING_SHAPE, cuda).cpu(), want)
        assert torch.equal(flush_rows(mat, A, *SCORING_SHAPE, cuda).cpu(), want)
        mesh = Mesh([cuda, cuda], ("data",))
        assert torch.equal(flush_rows(mat, A, *SCORING_SHAPE, cuda, mesh=mesh).cpu(), want)
        assert counters.COUNTS["apply_tier"] == 4 and not counters.COUNTS["apply_tier_plain"]


def test_scoring_kernel_refuses_other_layouts(cuda):
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier

    mat = torch.from_numpy(scoring_rows(2, 0)).to(cuda)
    with pytest.raises(TypeError):
        apply_tier(mat.to(torch.int64), 2, *SCORING_SHAPE)
    with pytest.raises(ValueError):
        apply_tier(mat[:, ::2], 2, *SCORING_SHAPE)
    with pytest.raises(ValueError):
        apply_tier(mat, 3, *SCORING_SHAPE)


@pytest.mark.parametrize("seed,n,n_events", [(0, 5000, 300), (1, 300, 1000), (3, 200_000, 7)])
def test_pileup_kernel_matches_plain_on_adversarial_rows(cuda, seed, n, n_events):
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.discovery_pileup import segment_counters, segment_counters_plain

    mat = torch.from_numpy(pileup_rows(seed, n, n_events))
    counters.reset()
    got = segment_counters(mat.to(cuda), n_events).cpu()
    assert dict(counters.COUNTS) == {"segment_counters": 1}
    assert torch.equal(got, segment_counters_plain(mat, n_events))


# ---- the verdict and seed-probe kernels against their plain versions ----


@pytest.fixture(scope="module")
def synthetic():
    from test_torch_device_align_batches import synthetic_index

    return synthetic_index(0)


@pytest.fixture(scope="module")
def engine_rows(tmp_path_factory):
    """A small cohort's graph and index, built by the port, and the engine's
    rows of its pool (gt_prep_fetch_kmers, gt_prep_fetch_tails)."""
    from graphtyper_tpu_torch.graph.build import construct_graph
    from graphtyper_tpu_torch.graph.coords import GenomicRegion
    from graphtyper_tpu_torch.index.build import index_graph
    from graphtyper_tpu_torch.io.native import get_lib
    from graphtyper_tpu_torch.pipeline import native_caller
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort
    from graphtyper_tpu_torch.typer.native_align import NativeAligner

    cfg = SimConfig(region_length=9000, coverage=22.0, n_samples=2, seed=41, error_rate=0.001,
                    out_format="bam")
    sim = simulate_cohort(str(tmp_path_factory.mktemp("engine_rows")), cfg)
    spec = f"{cfg.chrom}:1-{cfg.region_length}"
    graph = construct_graph(sim.fasta, sim.vcf, spec, use_index=True)
    index = index_graph(graph)
    lib = get_lib()
    native_caller._setup_lib(lib)
    entry = native_caller._get_prep(lib, sim.sams, GenomicRegion.parse(spec), 3840, False)
    try:
        return NativeAligner(graph, index), (*entry.fetch_kmers(lib), *entry.fetch_tails(lib))
    finally:
        entry.release(lib)


def _verdicts_both(cuda, na, rows):
    """(kernel, plain) verdict rows of `rows` on the card."""
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.device_align import DeviceAligner, stage_tails, verdicts_plain
    from graphtyper_tpu_torch.ops.seed_probe import stage_kmers

    hi, lo, valid, tails, lens = rows
    dal = DeviceAligner(na, cuda)
    kmers = stage_kmers(hi, lo, valid, cuda)
    staged_tails = stage_tails(tails, lens, cuda)
    before = counters.COUNTS["device_align"]
    got = dal.launch(kmers, *staged_tails, hi.shape[1]).cpu()
    assert counters.COUNTS["device_align"] == before + 1
    want = verdicts_plain(*kmers, *staged_tails, *dal.tables, key_steps=dal.key_steps,
                          ref_steps=dal.ref_steps).cpu()
    return got, want


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_device_align_kernel_matches_plain_on_synthetic_rows(cuda, synthetic, nk):
    import types

    from test_torch_device_align_batches import synthetic_rows

    got, want = _verdicts_both(cuda, types.SimpleNamespace(**synthetic), synthetic_rows(synthetic, nk, seed=nk))
    assert torch.equal(got, want)


@pytest.mark.parametrize("nk", [2, 4, 8])
def test_device_align_kernel_matches_plain_at_the_arena_edges(cuda, nk):
    import types

    from test_torch_device_align_batches import arena_edge_index, arena_edge_rows

    idx = arena_edge_index(0)
    got, want = _verdicts_both(cuda, types.SimpleNamespace(**idx), arena_edge_rows(idx, nk, seed=nk))
    assert torch.equal(got, want)


def test_device_align_kernel_matches_plain_on_engine_rows(cuda, engine_rows):
    na, rows = engine_rows
    got, want = _verdicts_both(cuda, na, rows)
    assert torch.equal(got, want)
    assert (want[:, 0] & 1).float().mean() > 0.3


def _probe_both(cuda, rows, keys, bits):
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.seed_probe import DeviceSeeder, probe_bits, probe_bits_plain, stage_kmers

    seeder = DeviceSeeder(keys, cuda, bits=bits)
    kmers = stage_kmers(*rows[:3], cuda)
    before = counters.COUNTS["seed_probe"]
    got = probe_bits(*kmers, seeder.bitset, seeder.bits).cpu()
    assert counters.COUNTS["seed_probe"] == before + 1
    return got, probe_bits_plain(*kmers, seeder.bitset, seeder.bits).cpu()


@pytest.mark.parametrize("bits", [14, 24])
@pytest.mark.parametrize("nk", [2, 4, 8, 40])
def test_seed_probe_kernel_matches_plain_on_synthetic_rows(cuda, synthetic, nk, bits):
    from test_torch_device_align_batches import synthetic_rows

    got, want = _probe_both(cuda, synthetic_rows(synthetic, nk, seed=20 + nk), synthetic["keys"], bits)
    assert torch.equal(got, want) and want.any()


def test_seed_probe_kernel_matches_plain_on_engine_rows(cuda, engine_rows):
    from graphtyper_tpu_torch.ops.seed_probe import bitset_bits_for

    na, rows = engine_rows
    got, want = _probe_both(cuda, rows, na.keys, bitset_bits_for(len(na.keys)))
    assert torch.equal(got, want) and want.any()
