"""SW parity of the torch port: `sw_align_plain` (the path every CPU tensor
takes through `sw_align_rot`) against the JAX package's Pallas kernel in
interpret mode and against its host DP, and the port's `align_batch` against
the JAX one. Every output is an integer, so the tolerance is 0."""

import numpy as np
import pytest
import torch

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.ops.sw import align_batch as ref_align_batch
from graphtyper_tpu.ops.sw_rot import sw_align_rot as ref_sw_align_rot
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.ops.sw import align_batch
from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain, sw_align_rot
from test_torch_sw_batches import e_tie_batch, insertion_batch, two_band_batch


def _randomized(seed):
    rng = np.random.default_rng(seed)
    B, Mx, Nx = 64, 24, 64
    qlens = rng.integers(6, Mx + 1, size=B).astype(np.int32)
    dlens = rng.integers(24, Nx + 1, size=B).astype(np.int32)
    Q = np.full((B, Mx), 5, dtype=np.uint8)
    D = np.full((B, Nx), 5, dtype=np.uint8)
    for b in range(B):
        Q[b, : qlens[b]] = rng.integers(0, 4, qlens[b])
        D[b, : dlens[b]] = rng.integers(0, 4, dlens[b])
    # planted noisy hits so score ties and clip races actually occur
    for b in range(0, B, 2):
        m = qlens[b]
        if dlens[b] >= m:
            st = rng.integers(0, dlens[b] - m + 1)
            Q[b, :m] = D[b, st : st + m]
            Q[b, rng.integers(0, m)] = rng.integers(0, 4)
    return Q, qlens, D, dlens


def _adversarial():
    """tests/ops/test_sw_rot.py:test_adversarial_ties_and_gaps."""
    rng = np.random.default_rng(99)
    B, Mx, Nx = 32, 20, 48
    qlens = np.full(B, Mx, np.int32)
    dlens = np.full(B, Nx, np.int32)
    Q = rng.integers(0, 2, (B, Mx)).astype(np.uint8)
    D = rng.integers(0, 2, (B, Nx)).astype(np.uint8)
    Q[0] = 0
    D[0] = 0
    Q[1, :10] = D[1, 5:15]
    Q[1, 10:] = 3
    Q[2] = D[2, :Mx][::-1]
    D[3, :24] = rng.integers(0, 4, 24)
    Q[3, :10] = D[3, :10]
    Q[3, 10:20] = D[3, 16:26]
    return Q, qlens, D, dlens


def _length_edges():
    """tests/ops/test_sw_rot.py:test_length_edges_and_iupac."""
    Mx, Nx = 16, 32
    rng = np.random.default_rng(7)
    Q = rng.integers(0, 4, (8, Mx)).astype(np.uint8)
    D = rng.integers(0, 4, (8, Nx)).astype(np.uint8)
    qlens = np.array([16, 1, 6, 16, 16, 3, 16, 16], np.int32)
    dlens = np.array([32, 32, 32, 8, 32, 3, 32, 32], np.int32)
    Q[4, 2:9] = 4
    D[6, ::3] = 4
    Q[7] = D[7, 10 : 10 + Mx]
    return Q, qlens, D, dlens


def _empty_lengths():
    """qlen = 0 and dlen = 0 rows: the kernel's sentinel outputs."""
    rng = np.random.default_rng(11)
    Q = rng.integers(0, 4, (6, 12)).astype(np.uint8)
    D = rng.integers(0, 4, (6, 30)).astype(np.uint8)
    qlens = np.array([0, 12, 0, 5, 12, 1], np.int32)
    dlens = np.array([30, 0, 0, 0, 30, 1], np.int32)
    return Q, qlens, D, dlens


def gap_tie_batch(seed=19, B=192, M=40, N=80):
    """Dense score ties with different starts: a two-letter alphabet with
    15 % N codes (score 0), half the queries copies of a database window
    with a deletion of 0-3 bases and, in half of those, an insertion of 1-3
    bases. Ties of M against F and of E against H_tmp then decide the begin
    of some pairs, and equal clip-end candidates in neighbouring rows (a
    row of R = 2 rows a lane of the wavefront kernel, csrc/sw_rot.cu)
    decide the end of others. The seed was chosen so that each of those
    three rules, reversed, changes at least two pairs' outputs
    (tests/test_torch_sw_rot_emulated.py)."""
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 2, (B, M)).astype(np.uint8)
    D = rng.integers(0, 2, (B, N)).astype(np.uint8)
    Q[rng.random((B, M)) < 0.15] = 4
    D[rng.random((B, N)) < 0.15] = 4
    for b in range(0, B, 2):
        st = rng.integers(0, N - M - 4)
        hit = D[b, st : st + M + 4].copy()
        cut = rng.integers(3, M - 3)
        gap = rng.integers(0, 4)
        hit = np.concatenate([hit[:cut], hit[cut + gap :]])[:M]
        if rng.random() < 0.5:
            ins = rng.integers(0, 2, rng.integers(1, 4)).astype(np.uint8)
            hit = np.concatenate([hit[:cut], ins, hit[cut:]])[:M]
        Q[b] = hit
        Q[b, rng.integers(0, M, 2)] = rng.integers(0, 5, 2)
    qlens = rng.integers(M // 2, M + 1, B).astype(np.int32)
    dlens = rng.integers(N // 2, N + 1, B).astype(np.int32)
    return Q, qlens, D, dlens


CASES = {
    "random0": lambda: _randomized(0),
    "random1": lambda: _randomized(1),
    "random2": lambda: _randomized(2),
    "adversarial": _adversarial,
    "length_edges": _length_edges,
    "empty_lengths": _empty_lengths,
    "e_ties": lambda: e_tie_batch(3),
    "gap_ties": gap_tie_batch,
}


def _plain(Q, qlens, D, dlens):
    s, bg, en = sw_align_plain(
        torch.from_numpy(Q), torch.from_numpy(qlens), torch.from_numpy(D), torch.from_numpy(dlens)
    )
    return s.numpy(), bg.numpy(), en.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    Q, qlens, D, dlens = CASES[case]()
    want = ref_sw_align_rot(Q, qlens, D, dlens, interpret=True)
    got = _plain(Q, qlens, D, dlens)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_host_dp(case):
    """The host DP differs from the kernel only at qlen = 0, where it
    reports the first valid column as begin/end; those rows are held to
    score 0 alone."""
    Q, qlens, D, dlens = CASES[case]()
    host = ref_align_batch(Q, qlens, D, dlens, device=False)
    s, bg, en = _plain(Q, qlens, D, dlens)
    has_q = qlens > 0
    np.testing.assert_array_equal(host.score, s)
    np.testing.assert_array_equal(host.database_begin[has_q], bg[has_q])
    np.testing.assert_array_equal(host.database_end[has_q], en[has_q])


LONG_CASES = {  # a window wider than 512 columns; queries of two 256-row bands (csrc/sw_rot.cu)
    "insertion_30bp_N576": lambda: insertion_batch(3, 4),
    "two_bands_300x640": lambda: two_band_batch(4, 4),
}


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_plain_matches_pallas_interpret_long(case):
    """The long shapes against the JAX kernel in interpret mode and the host
    DP. The JAX kernel runs with r_block=4, col_unroll=2: its result does not
    depend on its blocking (tests/ops/test_sw_rot.py:83), and on the CPU this
    blocking interprets the two-band case in about 19 s against about 59 s
    at the defaults. Its batch is padded to 1024 pairs whatever B is."""
    Q, qlens, D, dlens = LONG_CASES[case]()
    want = ref_sw_align_rot(Q, qlens, D, dlens, interpret=True, r_block=4, col_unroll=2)
    got = _plain(Q, qlens, D, dlens)
    host = ref_align_batch(Q, qlens, D, dlens, device=False)
    for w, g, h in zip(want, got, (host.score, host.database_begin, host.database_end)):
        np.testing.assert_array_equal(np.asarray(w), g)
        np.testing.assert_array_equal(h, g)


def test_cpu_tensor_routes_to_plain():
    Q, qlens, D, dlens = _adversarial()
    before = counters.COUNTS["sw_plain"]
    got = sw_align_rot(
        torch.from_numpy(Q), torch.from_numpy(qlens), torch.from_numpy(D), torch.from_numpy(dlens)
    )
    assert counters.COUNTS["sw_plain"] == before + 1
    for w, g in zip(_plain(Q, qlens, D, dlens), got):
        np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("device_sw", ["auto", "on", "off"])
def test_align_batch_matches_reference(device_sw):
    """The port's align_batch on the CPU device against the JAX package's
    (host DP): score/begin/end equal; the device route reports clips as -1."""
    from dataclasses import replace

    Q, qlens, D, dlens = _randomized(5)
    # each package reads its own options
    for cfg in (config, ref_config):
        cfg.set_options(replace(cfg.DEFAULT_OPTIONS, device_sw=device_sw))
    try:
        got = align_batch(Q, qlens, D, dlens, device="cpu")
        want = ref_align_batch(Q, qlens, D, dlens, device=False)
    finally:
        for cfg in (config, ref_config):
            cfg.set_options(cfg.DEFAULT_OPTIONS)
    np.testing.assert_array_equal(got.score, want.score)
    np.testing.assert_array_equal(got.database_begin, want.database_begin)
    np.testing.assert_array_equal(got.database_end, want.database_end)
    if device_sw == "off":
        np.testing.assert_array_equal(got.clip_end, want.clip_end)
    else:
        assert (got.clip_end == -1).all() and (got.clip_begin == -1).all()


def test_align_batch_rejects_bad_lengths():
    Q, qlens, D, dlens = _length_edges()
    qlens = qlens.copy()
    qlens[0] = Q.shape[1] + 1
    with pytest.raises(ValueError):
        align_batch(Q, qlens, D, dlens, device="cpu")
