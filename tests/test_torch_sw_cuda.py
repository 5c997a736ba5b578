"""The hand-written CUDA SW kernel against its plain PyTorch version on the
card, exactly (integer outputs, tolerance 0). Needs an NVIDIA GPU and nvcc;
skips without them. Run on the card with:
    python -m pytest tests/test_torch_sw_cuda.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_sw import CASES

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


def test_kernel_matches_host_dp(cuda):
    """At 4096 pairs x 192 x 512 (151 bp reads padded), against the JAX
    package's native host DP, which the main path runs with device_sw off."""
    from graphtyper_tpu.constants import (
        SCORE_CLIP, SCORE_GAP_EXTEND, SCORE_GAP_OPEN, SCORE_MATCH, SCORE_MISMATCH,
    )
    from graphtyper_tpu.ops.sw import _align_batch_native
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot

    Q, qlens, D, dlens = _wide(1, B=4096)
    Qp = np.full((4096, 192), 5, np.uint8)
    Qp[:, : Q.shape[1]] = Q
    got = _run(sw_align_rot, cuda, Qp, qlens, D, dlens)
    host = _align_batch_native(Qp, qlens, D, dlens, SCORE_MATCH, SCORE_MISMATCH, SCORE_GAP_OPEN,
                               SCORE_GAP_EXTEND, SCORE_CLIP)
    assert host is not None
    for g, w in zip(got, (host.score, host.database_begin, host.database_end)):
        np.testing.assert_array_equal(g, w)
