"""SW batches made with numpy from seeds, shared by the SW tests and
chip_smoke.py (which imports this file, so it imports neither jax nor the
JAX package nor pytest), and checks that each batch has the shape its name
claims: `planted_batch` the main path's realignment batches,
`insertion_batch` a window wider than 512 columns, `two_band_batch`
queries of more than one 256-row band of csrc/sw_rot.cu, `e_tie_batch`
ties of the E scan."""

import numpy as np


def planted_batch(seed: int, B: int, M: int = 151, N: int = 506):
    """The main path's realignment shape: 151 bp reads (some trimmed)
    padded to M, against windows of 494-N valid bases with N codes; three
    in four reads are planted hits with substitutions and an indel-sized
    shift. Needs M >= 151 and N >= 494."""
    rng = np.random.default_rng(seed)
    qlens = np.full(B, 151, np.int32)
    qlens[::16] = rng.integers(100, 151, len(qlens[::16]))  # some trimmed reads
    dlens = rng.integers(494, N + 1, B).astype(np.int32)
    Q = np.full((B, M), 5, np.uint8)
    D = np.full((B, N), 5, np.uint8)
    for b in range(B):
        D[b, : dlens[b]] = rng.integers(0, 4, dlens[b])
        D[b, rng.integers(0, dlens[b], 3)] = 4  # N codes in the window
        if b % 4:  # planted hit with substitutions and an indel-sized shift
            st = int(rng.integers(0, dlens[b] - qlens[b] - 8))
            hit = D[b, st : st + qlens[b] + 8].copy()
            cut = int(rng.integers(20, 120))
            hit = np.concatenate([hit[:cut], hit[cut + (b % 8) :]])[: qlens[b]]
            Q[b, : qlens[b]] = hit
            Q[b, rng.integers(0, qlens[b], 3)] = rng.integers(0, 5, 3)
        else:
            Q[b, : qlens[b]] = rng.integers(0, 4, qlens[b])
    return Q, qlens, D, dlens


def insertion_batch(seed: int, B: int, ins: int = 30, N: int = 576):
    """A realignment window wider than 512 columns: 502 reference bases
    with `ins` inserted bases in the middle (the main path's window for
    151 bp reads, typer/discovery.py:681-687), padded to N. Reads of 151 bp
    (some trimmed) span the insertion point; even reads carry the insertion,
    odd ones are the reference and need a gap of `ins` bases or a clip. A
    few substitutions and N codes in each."""
    rng = np.random.default_rng(seed)
    mid = 251
    dlen = 502 + ins
    if dlen > N:
        raise ValueError(f"insertion_batch: a window of {dlen} bases does not fit N = {N}")
    qlens = np.full(B, 151, np.int32)
    qlens[1::5] = rng.integers(100, 151, len(qlens[1::5]))
    Q = np.full((B, 151), 5, np.uint8)
    D = np.full((B, N), 5, np.uint8)
    for b in range(B):
        ref = rng.integers(0, 4, 502).astype(np.uint8)
        hap = np.concatenate([ref[:mid], rng.integers(0, 4, ins).astype(np.uint8), ref[mid:]])
        D[b, :dlen] = hap
        D[b, rng.integers(0, dlen, 2)] = 4
        src = hap if b % 2 == 0 else ref
        m = int(qlens[b])
        st = int(rng.integers(mid - m + 10, mid - 10))
        Q[b, :m] = src[st : st + m]
        Q[b, rng.integers(0, m, 3)] = rng.integers(0, 5, 3)
    return Q, qlens, D, np.full(B, dlen, np.int32)


def two_band_batch(seed: int, B: int = 6, M: int = 300, N: int = 640):
    """Queries of more than 256 rows, which the wavefront kernel runs in
    two bands: lengths 300, 290, 257 (a second band of one row), 256 (one
    full band) and shorter, against windows of 600-N bases; most are
    planted hits with an indel and substitutions."""
    rng = np.random.default_rng(seed)
    qlens = np.resize(np.array([M, M - 10, 257, 256, 200, M - 1, 280, 130], np.int32), B)
    dlens = rng.integers(600, N + 1, B).astype(np.int32)
    Q = np.full((B, M), 5, np.uint8)
    D = np.full((B, N), 5, np.uint8)
    for b in range(B):
        D[b, : dlens[b]] = rng.integers(0, 4, dlens[b])
        m = int(qlens[b])
        if b % 3 == 2:
            Q[b, :m] = rng.integers(0, 4, m)
            continue
        st = int(rng.integers(0, dlens[b] - m - 12))
        hit = D[b, st : st + m + 12].copy()
        cut = int(rng.integers(30, m - 30))
        gap = 1 + b % 9
        hit = np.concatenate([hit[:cut], hit[cut + gap :]])[:m]
        Q[b, :m] = hit
        Q[b, rng.integers(0, m, 4)] = rng.integers(0, 5, 4)
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


MAKERS = {
    "planted": lambda: planted_batch(1, 40),
    "insertion": lambda: insertion_batch(1, 12),
    "two_bands": lambda: two_band_batch(1, 8),
    "e_ties": lambda: e_tie_batch(1),
}


def test_batches_are_padded_past_their_lengths():
    """Codes 0-5, lengths inside the arrays, pad code 5 past each length
    where the batch pads (e_tie_batch fills its rows)."""
    for name, make in MAKERS.items():
        Q, qlens, D, dlens = make()
        assert Q.dtype == D.dtype == np.uint8 and qlens.dtype == dlens.dtype == np.int32, name
        assert len(Q) == len(qlens) == len(D) == len(dlens), name
        assert Q.max() <= 5 and D.max() <= 5, name
        assert (qlens <= Q.shape[1]).all() and (dlens <= D.shape[1]).all(), name
        for b in range(len(Q)):
            assert (Q[b, qlens[b]:] == 5).all() and (Q[b, : qlens[b]] < 5).all(), (name, b)
            assert (D[b, dlens[b]:] == 5).all() and (D[b, : dlens[b]] < 5).all(), (name, b)


def test_planted_batch_is_the_main_path_shape():
    Q, qlens, D, dlens = planted_batch(2025, 40)
    assert Q.shape == (40, 151) and D.shape == (40, 506)
    assert qlens.max() == 151 and qlens.min() >= 100
    assert dlens.min() >= 494 and dlens.max() <= 506


def test_insertion_batch_window_is_wider_than_512():
    """The row kernel refuses N > 512 (csrc/sw_row.cu); this window is
    502 reference bases plus a 30 bp insertion."""
    Q, qlens, D, dlens = insertion_batch(7, 12)
    assert D.shape[1] == 576 and (dlens == 532).all() and (qlens <= 151).all()


def test_two_band_batch_spans_band_edges():
    """Queries of 257 rows (a second band of one row), 256 (one full band)
    and up to 300."""
    _, qlens, _, dlens = two_band_batch(5, 8)
    assert {256, 257, 300} <= set(qlens.tolist())
    assert (dlens >= 600).all()
