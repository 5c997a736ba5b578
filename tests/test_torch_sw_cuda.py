"""The hand-written CUDA SW kernels (csrc/sw_rot.cu behind `sw_align_rot`,
csrc/sw_row.cu behind `sw_align_pallas`) against their plain PyTorch
version and the C++ engine's host DP on the card, exactly (integer outputs,
tolerance 0). Needs an NVIDIA GPU and nvcc; skips without them. Run on the
card with:
    python -m pytest tests/test_torch_sw_cuda.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_sw import CASES
from test_torch_sw_batches import e_tie_batch, insertion_batch, two_band_batch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _wide(seed, B=1024, M=151, N=512):
    """Main-path shapes: 151 bp reads against ~500 bp windows, planted hits
    with substitutions and N codes."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(100, M + 1, B).astype(np.int32)
    dlens = rng.integers(400, N + 1, B).astype(np.int32)
    Q = np.full((B, M), 5, np.uint8)
    D = np.full((B, N), 5, np.uint8)
    for b in range(B):
        D[b, : dlens[b]] = rng.integers(0, 4, dlens[b])
        st = rng.integers(0, dlens[b] - qlens[b])
        Q[b, : qlens[b]] = D[b, st : st + qlens[b]]
        Q[b, rng.integers(0, qlens[b], 4)] = rng.integers(0, 5, 4)
    return Q, qlens, D, dlens


def _run(fn, dev, Q, qlens, D, dlens):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (Q, qlens, D, dlens)]
    out = fn(*t)
    torch.cuda.synchronize()
    return [o.cpu().numpy() for o in out]


@pytest.mark.parametrize("case", sorted(CASES) + ["wide"])
def test_kernel_matches_plain(cuda, case):
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain, sw_align_rot

    args = _wide(0) if case == "wide" else CASES[case]()
    before = counters.COUNTS["sw_rot"]
    got = _run(sw_align_rot, cuda, *args)
    assert counters.COUNTS["sw_rot"] == before + 1
    want = _run(sw_align_plain, cuda, *args)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_kernel_rejects_bad_inputs(cuda):
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot

    Q, qlens, D, dlens = CASES["adversarial"]()
    q, d = torch.from_numpy(Q).to(cuda), torch.from_numpy(D).to(cuda)
    ql, dl = torch.from_numpy(qlens).to(cuda), torch.from_numpy(dlens).to(cuda)
    with pytest.raises(TypeError):
        sw_align_rot(q.to(torch.int32), ql, d, dl)
    with pytest.raises(ValueError):
        sw_align_rot(q, ql, d.t().contiguous().t(), dl)
    with pytest.raises(ValueError):
        sw_align_rot(q, ql[:-1], d, dl)


def _kernels():
    from graphtyper_tpu_torch.ops.sw_pallas import sw_align_pallas
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot

    return {"sw_rot": sw_align_rot, "sw_row": sw_align_pallas}


@pytest.mark.parametrize("kernel", ["sw_rot", "sw_row"])
def test_kernel_matches_host_dp(cuda, kernel):
    """At 4096 pairs x 192 x 512 (151 bp reads padded), against the C++
    engine's host DP (ops/sw.py align_batch_host), which the main path runs
    with device_sw off."""
    from graphtyper_tpu_torch.ops.sw import align_batch_host

    Q, qlens, D, dlens = _wide(1, B=4096)
    Qp = np.full((4096, 192), 5, np.uint8)
    Qp[:, : Q.shape[1]] = Q
    got = _run(_kernels()[kernel], cuda, Qp, qlens, D, dlens)
    host = align_batch_host(Qp, qlens, D, dlens)
    for g, w in zip(got, (host.score, host.database_begin, host.database_end)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES) + ["wide"])
def test_row_kernel_matches_plain(cuda, case):
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.sw_pallas import sw_align_pallas, sw_align_plain

    args = _wide(0) if case == "wide" else CASES[case]()
    before = counters.COUNTS["sw_row"]
    got = _run(sw_align_pallas, cuda, *args)
    assert counters.COUNTS["sw_row"] == before + 1
    want = _run(sw_align_plain, cuda, *args)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kernel", ["sw_rot", "sw_row"])
@pytest.mark.parametrize("M,N", [(12, 32), (24, 128), (40, 256), (151, 512)])
def test_kernel_e_ties(cuda, kernel, M, N):
    """The E scan's tie rule at the row kernel's strip widths 1, 4, 8 and
    16: ties in the in-strip pass, the shuffle scan and the fix-up pass."""
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain

    args = e_tie_batch(N, B=64, M=M, N=N)
    got = _run(_kernels()[kernel], cuda, *args)
    want = _run(sw_align_plain, cuda, *args)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kernel", ["sw_rot", "sw_row"])
@pytest.mark.parametrize("pairs", [1, 6, 40])
def test_row_kernel_at_main_path_batches(cuda, kernel, pairs):
    """The main path's batch sizes at 151 x 506, for both kernels: against
    the plain version and the host DP."""
    from graphtyper_tpu_torch.ops.sw import align_batch_host
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain

    Q, qlens, D, dlens = (a[:pairs] for a in _wide(2, B=64, N=506))
    got = _run(_kernels()[kernel], cuda, Q, qlens, D, dlens)
    host = align_batch_host(Q, qlens, D, dlens)
    want = _run(sw_align_plain, cuda, Q, qlens, D, dlens)
    for g, w, h in zip(got, want, (host.score, host.database_begin, host.database_end)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("case,pairs", [("insertion_N576", 40), ("insertion_N576", 512),
                                        ("two_bands_300x640", 8), ("two_bands_300x640", 256)])
def test_rot_kernel_long_shapes(cuda, case, pairs):
    """sw_rot.cu on a window wider than 512 columns (a 30 bp insertion) and
    on queries of two 256-row bands, which go through the band scratch:
    against the plain version and the host DP."""
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.ops.sw import align_batch_host
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain, sw_align_rot

    make = insertion_batch if case.startswith("insertion") else two_band_batch
    Q, qlens, D, dlens = make(11, pairs)
    before = counters.COUNTS["sw_rot"]
    got = _run(sw_align_rot, cuda, Q, qlens, D, dlens)
    assert counters.COUNTS["sw_rot"] == before + 1
    host = align_batch_host(Q, qlens, D, dlens)
    want = _run(sw_align_plain, cuda, Q, qlens, D, dlens)
    for g, w, h in zip(got, want, (host.score, host.database_begin, host.database_end)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)


def test_row_kernel_rejects_bad_inputs(cuda):
    from graphtyper_tpu_torch.ops.sw_pallas import MAX_N, sw_align_pallas

    Q, qlens, D, dlens = CASES["adversarial"]()
    q, d = torch.from_numpy(Q).to(cuda), torch.from_numpy(D).to(cuda)
    ql, dl = torch.from_numpy(qlens).to(cuda), torch.from_numpy(dlens).to(cuda)
    with pytest.raises(TypeError):
        sw_align_pallas(q, ql.to(torch.int64), d, dl)
    with pytest.raises(ValueError):
        sw_align_pallas(q, ql, d.t().contiguous().t(), dl)
    with pytest.raises(ValueError):
        sw_align_pallas(q, ql, d, dl[:-1])
    wide = torch.full((q.shape[0], MAX_N + 1), 5, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="N <="):
        sw_align_pallas(q, ql, wide, dl)
