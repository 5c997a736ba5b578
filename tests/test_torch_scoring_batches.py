"""Row batches made with numpy from seeds for the two scoring kernels,
shared by tests/test_torch_scoring_kernels.py, tests/test_torch_ops_cuda.py
and chip_smoke.py (which imports this file, so it imports neither jax nor
the JAX package nor pytest), and checks that each batch holds the cases
its name claims.

`scoring_rows(A, seed)` is a [14, N] int32 observation matrix (OBS_FIELDS
order) of adversarial rows: padding rows, apply_score 0 with bits set, eps
0, 1, 2 and large, explain bits above A, both words' sign bits set,
COV_MULTI_REF/COV_MULTI_ALT/COV_PAD, cov 0 and A - 1, strands 0-3, proper
0/1, negative scalars, and a hot (site, sample) segment whose rows set
every bit. `pileup_rows(seed, n, n_events)` is a [6, n] int64 first-pass
row matrix (ev, dhq, dlq, bits, mapq, dist) with empty events, negative
values and overflow rows (ev == n_events). `flush_matrix(n, A, n_sites,
n_samples)` is a cohort flush's [14, n] matrix with tools/bench_flush.py's
row distributions (one explained allele a read, 6 % multi-allele reads,
eps 4-8), the explain bit in the word of its allele at any A.
`scoring_order` and `pileup_order` put a batch's rows in the orders the
kernels' warp pre-reduction sees differently: as made (random), sorted by
segment or event (runs), reversed, and all in one segment or event."""

import numpy as np

from graphtyper_tpu_torch.ops.site_scoring import COV_MULTI_ALT, COV_MULTI_REF, COV_PAD, OBS_FIELDS

F = {k: i for i, k in enumerate(OBS_FIELDS)}
SCORING_SHAPE = (7, 3)  # n_sites, n_samples of scoring_rows
LARGE_EPS = 65_535


def scoring_rows(A: int, seed: int, n_random: int = 900, n_sites: int = SCORING_SHAPE[0],
                 n_samples: int = SCORING_SHAPE[1]) -> np.ndarray:
    rng = np.random.default_rng(seed * 100 + A)
    blocks = []

    def block(n, **cols):
        m = np.zeros((len(OBS_FIELDS), n), dtype=np.int64)
        for k, v in cols.items():
            m[F[k]] = v
        blocks.append(m)

    words = rng.integers(0, 1 << 32, (2, n_random), dtype=np.uint64)
    words[:, ::5] |= np.uint64(1 << 31)  # both words' sign bits
    block(
        n_random,
        site=rng.integers(0, n_sites, n_random), sample=rng.integers(0, n_samples, n_random),
        eps=rng.choice([0, 1, 2, 4, 7, 60, LARGE_EPS], n_random),
        apply_score=rng.integers(0, 2, n_random),
        bits_lo=words[0].astype(np.int64), bits_hi=words[1].astype(np.int64),
        cov=rng.choice([COV_PAD, COV_MULTI_REF, COV_MULTI_ALT, 0, A - 1, *range(A)], n_random),
        clipped_scaled=rng.integers(-5, 100, n_random), clipped_flag=rng.integers(0, 2, n_random),
        mapq_sq=rng.integers(0, 3601, n_random), mm_scaled=rng.integers(-3, 50, n_random),
        sdiff=rng.integers(-30, 30, n_random), strand=rng.integers(0, 4, n_random),
        proper=rng.integers(0, 2, n_random),
    )
    hot = 150  # one (site, sample) segment, every explain bit set
    block(hot, site=n_sites - 1, sample=n_samples - 1, eps=rng.integers(0, 9, hot), apply_score=1,
          bits_lo=0xFFFFFFFF, bits_hi=0xFFFFFFFF, cov=rng.choice([COV_MULTI_ALT, A - 1], hot),
          mapq_sq=3600, strand=np.arange(hot) % 4, proper=np.arange(hot) % 2)
    block(60, site=rng.integers(0, n_sites, 60), sample=rng.integers(0, n_samples, 60), eps=0,
          apply_score=1, bits_lo=rng.integers(1, 1 << 32, 60), cov=0)  # eps 0, applied
    block(60, site=rng.integers(0, n_sites, 60), sample=rng.integers(0, n_samples, 60), eps=1,
          apply_score=1, bits_lo=rng.integers(1, 1 << 32, 60), cov=COV_MULTI_REF)  # eps 1
    block(100, cov=COV_PAD)  # padding rows: eps 0, bits 0, zero scalars
    mat = np.concatenate(blocks, axis=1)
    mat = mat[:, rng.permutation(mat.shape[1])]
    mat[F["bits_lo"]] = mat[F["bits_lo"]].astype(np.uint32).view(np.int32)
    mat[F["bits_hi"]] = mat[F["bits_hi"]].astype(np.uint32).view(np.int32)
    return np.ascontiguousarray(mat.astype(np.int32))


def flush_matrix(n: int, A: int, n_sites: int, n_samples: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = np.zeros((len(OBS_FIELDS), n), dtype=np.int64)
    m[F["site"]] = rng.integers(0, n_sites, n)
    m[F["sample"]] = rng.integers(0, n_samples, n)
    m[F["eps"]] = rng.integers(4, 9, n)
    m[F["apply_score"]] = rng.random(n) < 0.98
    which = rng.integers(0, A, n)
    multi = rng.random(n) < 0.06
    bits = np.left_shift(np.uint64(1), which.astype(np.uint64)) | multi.astype(np.uint64)
    m[F["bits_lo"]] = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    m[F["bits_hi"]] = (bits >> np.uint64(32)).astype(np.uint32).view(np.int32)
    m[F["cov"]] = np.where(multi, np.where(which > 0, COV_MULTI_ALT, COV_MULTI_REF), which)
    m[F["clipped_scaled"]] = rng.integers(0, 30, n)
    m[F["clipped_flag"]] = rng.random(n) < 0.08
    m[F["mapq_sq"]] = rng.integers(20, 61, n) ** 2
    m[F["mm_scaled"]] = rng.integers(0, 40, n)
    m[F["sdiff"]] = rng.integers(0, 60, n)
    m[F["strand"]] = rng.integers(0, 4, n)
    m[F["proper"]] = rng.random(n) < 0.5
    return np.ascontiguousarray(m.astype(np.int32))


def pileup_rows(seed: int, n: int, n_events: int, n_overflow: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ev = rng.integers(0, n_events, n)
    ev = np.where(ev % 7 == 0, (ev + 1) % n_events, ev)  # events 7k get no row
    mat = np.stack([
        ev,
        rng.integers(-2, 3, n),  # dhq
        rng.integers(-1, 2, n),  # dlq
        rng.integers(0, 16, n),  # bits
        rng.integers(-5, 61, n),  # mapq, some negative
        rng.integers(-20, 151, n),  # dist, some negative
    ]).astype(np.int64)
    over = np.stack([np.full(n_overflow, n_events), np.full(n_overflow, 5), np.full(n_overflow, 5),
                     np.full(n_overflow, 15), np.full(n_overflow, 99), np.full(n_overflow, 999)])
    mat = np.concatenate([mat, over.astype(np.int64)], axis=1)
    return np.ascontiguousarray(mat[:, rng.permutation(mat.shape[1])])


ORDERS = ("random", "sorted", "reversed", "one_segment")


def scoring_order(mat, order, shape=SCORING_SHAPE):
    """The rows of `mat` in `order`: "random" (as made), "sorted" by (site,
    sample), "reversed", or "one_segment" (every row moved to the last site
    and sample)."""
    if order == "random":
        return mat
    if order == "sorted":
        mat = mat[:, np.lexsort((mat[F["sample"]], mat[F["site"]]))]
    elif order == "reversed":
        mat = mat[:, ::-1]
    else:
        mat = mat.copy()
        mat[F["site"]], mat[F["sample"]] = shape[0] - 1, shape[1] - 1
    return np.ascontiguousarray(mat)


def pileup_order(mat, order, n_events):
    """The rows of `mat` in `order`: "random" (as made), "sorted" by ev,
    "reversed", or "one_event" (every row, the overflow rows too, moved to
    event n_events // 2)."""
    if order == "sorted":
        return np.ascontiguousarray(mat[:, np.argsort(mat[0], kind="stable")])
    if order == "reversed":
        return np.ascontiguousarray(mat[:, ::-1])
    if order == "one_event":
        mat = mat.copy()
        mat[0] = n_events // 2
    return mat


def test_scoring_rows_hold_their_cases():
    for A in (2, 64):
        m = scoring_rows(A, 0).astype(np.int64)
        eps, cov, apply = m[F["eps"]], m[F["cov"]], m[F["apply_score"]]
        lo, hi = m[F["bits_lo"]] & 0xFFFFFFFF, m[F["bits_hi"]] & 0xFFFFFFFF
        pad = (cov == COV_PAD) & (eps == 0) & (lo == 0) & (hi == 0)
        assert pad.sum() >= 100 and (m[7:, pad] == 0).all()
        assert ((apply == 0) & (lo != 0)).any() and (hi >> 31).any() and (m[F["bits_hi"]] < 0).any()
        assert {0, 1, 2, LARGE_EPS} <= set(eps.tolist())
        assert {COV_MULTI_REF, COV_MULTI_ALT, COV_PAD, 0, A - 1} <= set(cov.tolist())
        assert set(m[F["strand"]].tolist()) == {0, 1, 2, 3} and set(m[F["proper"]].tolist()) == {0, 1}
        assert (m[F["sdiff"]] < 0).any()
        if A < 64:
            assert ((lo | hi << 32) >> A).any()  # bits above A, which no output may see


def test_flush_matrix_explains_each_allele_in_its_word():
    m = flush_matrix(4096, 64, 8, 3).astype(np.int64)
    bits = (m[F["bits_lo"]] & 0xFFFFFFFF) | (m[F["bits_hi"]] & 0xFFFFFFFF) << 32
    one = m[F["cov"]] >= 0
    assert (bits[one] == np.left_shift(1, m[F["cov"], one])).all() and (m[F["bits_hi"]] < 0).any()
    assert ((bits[~one] & 1) == 1).all() and 0.03 < (~one).mean() < 0.09


def test_pileup_rows_hold_their_cases():
    m = pileup_rows(0, 5000, 300)
    assert (m[0] == 300).sum() == 64 and not np.isin(np.arange(0, 300, 7), m[0]).any()
    assert (m[4] < 0).any() and (m[5] < 0).any()


def test_orders_keep_the_rows():
    m = scoring_rows(4, 0)
    for order in ORDERS:
        o = scoring_order(m, order)
        assert o.shape == m.shape
        real = o[:, o[F["cov"]] != COV_PAD]
        assert real.shape[1] == (m[F["cov"]] != COV_PAD).sum()
    s = scoring_order(m, "sorted")
    key = s[F["site"]].astype(np.int64) * 100 + s[F["sample"]]
    assert (np.diff(key[s[F["cov"]] != COV_PAD]) >= 0).all()
    one = scoring_order(m, "one_segment")
    assert len(set(one[F["site"]].tolist())) == 1 and len(set(one[F["sample"]].tolist())) == 1
    p = pileup_rows(0, 500, 40)
    assert (np.diff(pileup_order(p, "sorted", 40)[0]) >= 0).all()
    assert set(pileup_order(p, "one_event", 40)[0].tolist()) == {20}
