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


def e_tie_batch(seed, B=16, M=24, N=128):
    """Pairs whose best alignment takes a deletion (E) from one of two
    columns with equal prefix values T = H + (j + 1) * ge and different
    starts, so the E scan's tie rule (the latest column wins) decides the
    database begin. The database holds a homopolymer of L bases, an N code,
    d bases the read deletes, then the read's tail; the read is the
    homopolymer and the tail. Ending the homopolymer at its last base (score
    L) or one column later over the N code (score L - 1) gives equal T.
    Half the pairs end the homopolymer on the last column of a lane's strip
    of the row-scan kernel (csrc/sw_row.cu), half inside one, and d reaches
    up to three strips, so the in-strip pass, the shuffle scan and the
    fix-up pass each meet a tie."""
    rng = np.random.default_rng(seed)
    C = 1  # the row-scan kernel's strip width at this N
    while 32 * C < N:
        C *= 2
    Q = np.full((B, M), 5, np.uint8)
    D = rng.integers(0, 4, (B, N)).astype(np.uint8)
    for b in range(B):
        a = b % 4
        L = int(rng.integers(M // 2 - 1, M // 2 + 2))
        tail = M - L
        d = int(rng.integers(1, max(2, min(tail - 2, L - 2, 3 * C + 2))))
        span = L + 1 + d + tail
        s = int(rng.integers(1, N - span + 1))
        s += ((0 if b % 2 == 0 else C // 2) - (s + L)) % C
        if s + span > N:
            s -= C
        D[b, s - 1] = (a + 1) % 4  # the homopolymer starts at s
        D[b, s : s + L] = a
        D[b, s + L] = 4
        D[b, s + L + 1] = (a + 2) % 4
        Q[b, :L] = a
        Q[b, L:] = D[b, s + L + 1 + d : s + span]
    return Q, np.full(B, M, np.int32), D, np.full(B, N, np.int32)


CASES = {
    "random0": lambda: _randomized(0),
    "random1": lambda: _randomized(1),
    "random2": lambda: _randomized(2),
    "adversarial": _adversarial,
    "length_edges": _length_edges,
    "empty_lengths": _empty_lengths,
    "e_ties": lambda: e_tie_batch(3),
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
