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
kmers), and on the engine's rows of a small cohort. Since the scoring
kernels' pre-reduction in the warp and in shared memory, both are also
held to their plain versions on four row orders (random, sorted, reversed,
one segment or event), the scoring kernel with its site-level block in
shared memory and in global memory at A 2 and A 64, the shared copy also
past 48 KB and in two host threads at once with copies of two sizes, a
flush run one row a lane with and without the warp's sums, and each call
is counted in device operations (torch.profiler: at most 3 an
`apply_tier`, 2 a `segment_counters`, no fill kernel).
The shared copy is the whole site-level block where it fits, else its
first entries, the rest taking global atomics.
Integer outputs, tolerance 0. Skips
without a GPU; run on the card with
  python -m pytest tests/test_torch_ops_cuda.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_discovery_pileup import _rows
from test_torch_scoring_batches import (ORDERS, SCORING_SHAPE, flush_matrix, pileup_order, pileup_rows, scoring_order,
                                        scoring_rows)
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


# (A, sites, whether the whole site-level block, sites x (2 + 8A) int64,
# fits the card's 227 KB of shared memory a block; else a block keeps its
# first entries)
SITE_BLOCK_CASES = [(2, 7, True), (2, 2000, False), (64, 7, True), (64, 64, False)]
PERSISTENT_ROWS = 400_000  # past the rows that one row a lane runs at once on the H100 (~135,000)


@pytest.mark.parametrize("A,n_sites,whole", SITE_BLOCK_CASES)
@pytest.mark.parametrize("order", ORDERS)
def test_scoring_kernel_row_orders_and_site_block_variants(cuda, order, A, n_sites, whole):
    """The persistent grid with its shared copy of the site-level block
    (whole or its first entries), against the plain version on the card."""
    from graphtyper_tpu_torch import kernels
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier, apply_tier_plain

    shape = (n_sites, 3)
    mat = scoring_order(scoring_rows(A, 11, n_random=PERSISTENT_ROWS, n_sites=n_sites, n_samples=3), order, shape)
    entries, shared = n_sites * (2 + 8 * A), kernels.load().gt_site_scoring_shared(mat.shape[1], A, *shape)
    assert shared == entries if whole else 0 < shared < entries
    assert kernels.load().gt_site_scoring_shared(5000, A, *shape) == 0  # one row a lane, no copy
    mat = torch.from_numpy(mat).to(cuda)
    assert torch.equal(apply_tier(mat, A, *shape), apply_tier_plain(mat, A, *shape))


@pytest.mark.parametrize("A", [2, 4, 64])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n_sites,grouped", [(400, False), (7, True)])
def test_scoring_kernel_one_row_a_lane_with_and_without_warp_sums(cuda, n_sites, grouped, order, A):
    """A flush of 5,370 rows runs one row a lane without a shared copy:
    over 400 sites (13 rows a site) each row makes its own atomics, over 7
    sites (767 a site) the warp sums them first; both against the plain
    version on the card, on the four orders."""
    from graphtyper_tpu_torch import kernels
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier, apply_tier_plain

    shape = (n_sites, 3)
    mat = scoring_order(scoring_rows(A, 12, n_random=5000, n_sites=n_sites, n_samples=3), order, shape)
    assert (mat.shape[1] >= 256 * n_sites) == grouped
    assert kernels.load().gt_site_scoring_shared(mat.shape[1], A, *shape) == 0
    mat = torch.from_numpy(mat).to(cuda)
    assert torch.equal(apply_tier(mat, A, *shape), apply_tier_plain(mat, A, *shape))


def test_scoring_kernel_shared_copy_past_48_kb(cuda):
    """A 2 x 512 sites: a 73,728-byte copy a block, which the launch must
    ask for (cudaFuncAttributeMaxDynamicSharedMemorySize)."""
    from graphtyper_tpu_torch import kernels
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier, apply_tier_plain

    A, shape = 2, (512, 50)
    for n in (1_048_576, 1_048_577):  # the last warp full, and with one row
        assert kernels.load().gt_site_scoring_shared(n, A, *shape) == 512 * (2 + 8 * A) > 48 * 1024 // 8
        mat = torch.from_numpy(flush_matrix(n, A, *shape, seed=n)).to(cuda)
        assert torch.equal(apply_tier(mat, A, *shape), apply_tier_plain(mat, A, *shape))


def test_scoring_kernel_shared_copies_in_two_threads_at_once(cuda):
    """Two host threads at once, each making persistent flushes at A 2 with
    a shared copy of its own size past 48 KB (512 sites: 73,728 bytes;
    1,500 sites: 216,000 bytes), 8 each: every launch succeeds and every
    output equals the plain version's. The kernel's shared-memory attribute
    is one setting that the launches of both threads share, as the pool
    threads' flushes share it."""
    import threading

    from graphtyper_tpu_torch import kernels
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier, apply_tier_plain

    A, shapes = 2, [(512, 50), (1500, 20)]
    mats, wants = [], []
    for n_sites, n_samples in shapes:
        assert kernels.load().gt_site_scoring_shared(PERSISTENT_ROWS, A, n_sites, n_samples) == n_sites * (2 + 8 * A)
        mat = torch.from_numpy(flush_matrix(PERSISTENT_ROWS, A, n_sites, n_samples, seed=n_sites)).to(cuda)
        mats.append(mat)
        wants.append(apply_tier_plain(mat, A, n_sites, n_samples))
    errors, start = [], threading.Barrier(len(shapes))

    def flushes(i):
        try:
            start.wait()
            for _ in range(8):
                if not torch.equal(apply_tier(mats[i], A, *shapes[i]), wants[i]):
                    errors.append(f"{shapes[i]}: the output differs")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{shapes[i]}: {e!r}")

    threads = [threading.Thread(target=flushes, args=(i,)) for i in range(len(shapes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors


@pytest.mark.parametrize("n", [100_000, 1_000_001])
@pytest.mark.parametrize("order", ["random", "sorted", "reversed", "one_event"])
def test_pileup_kernel_row_orders(cuda, order, n):
    from graphtyper_tpu_torch.ops.discovery_pileup import segment_counters, segment_counters_plain

    n_events = 3000
    mat = torch.from_numpy(pileup_order(pileup_rows(21, n - 64, n_events), order, n_events))
    assert mat.shape[1] == n
    assert torch.equal(segment_counters(mat.to(cuda), n_events).cpu(), segment_counters_plain(mat, n_events))


@pytest.mark.parametrize("A,ops", [(2, 2), (4, 2), (64, 3)])
def test_scoring_kernel_device_operations(cuda, A, ops):
    """A memset and pass 1, and pass 2 above A 4; no fill kernel."""
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier

    from graphtyper_tpu_torch.tools.bench_scoring import device_ops

    mat = torch.from_numpy(flush_matrix(4096, A, 64, 8)).to(cuda)
    n, _, names = device_ops(lambda: apply_tier(mat, A, 64, 8))
    assert n == ops and not any("fill" in name.lower() for name in names), names


def test_pileup_kernel_device_operations(cuda):
    from graphtyper_tpu_torch.ops.discovery_pileup import segment_counters

    from graphtyper_tpu_torch.tools.bench_scoring import device_ops

    mat = torch.from_numpy(pileup_rows(5, 20_000, 2_500)).to(cuda)
    n, _, names = device_ops(lambda: segment_counters(mat, 2_500))
    assert n == 2 and not any("fill" in name.lower() for name in names), names


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
