"""Synthetic index tables and read-orientation rows for the verdict and
seed-probe kernels, made with numpy from a seed. The tests and chip_smoke.py
share them; this module imports numpy only and holds no test.

`synthetic_index` is a flat graph and k-mer index in the layout of
typer/native_align.py NativeAligner (keys, offsets, lab_start, lab_end,
lab_var, ref_order, ref_dna_len, ref_dna_start, ref_arena): a random
reference cut into reference nodes, every 32-mer of it as a key, and on top
of that the cases the verdict rules single out: repeated k-mers (one key,
several spans), keys crossing variants (labels of one span with variant
ids, some >= 2^24, one near 2^31), a key with more than 6 labels of one
span, keys at special positions (start >= 0xD0000000, one ending at
0xFFFFFFFF), and tag codes (6) in the arena.

`synthetic_rows` makes rows as the engine's gt_prep_fetch_kmers and
gt_prep_fetch_tails lay them out, from reads taken off that reference with
mismatches, N codes, short lengths (< 32, < 63) and reads over node ends,
plus rows of random keys and of the special keys.

`arena_edge_index` and `arena_edge_rows` are a batch whose tails' arena
bytes run past the start and the end of the arena, where the verdicts
clamp each byte's index.
"""

import numpy as np

K = 32
INVALID = 0xFFFFFFFF  # lab_var of a label that crosses no variant
SPECIAL_START = 0xD0000000
TAIL_PAD = 32


def _keys_of(codes: np.ndarray) -> np.ndarray:
    """uint64 key of every 32-mer of `codes` (all < 4), in position order."""
    n = len(codes) - K + 1
    keys = np.zeros(n, np.uint64)
    for j in range(K):
        keys = (keys << np.uint64(2)) | codes[j : j + n].astype(np.uint64)
    return keys


def synthetic_index(seed: int = 0, ref_len: int = 6000) -> dict:
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    ref[2500:2700] = ref[600:800]  # a repeat: the keys of 600..768 get two spans
    ref[4000:4080] = 0  # poly-A: one key, 49 spans

    labels: dict[int, list[tuple[int, int, int]]] = {}
    for p, key in enumerate(_keys_of(ref).tolist()):
        labels.setdefault(key, []).append((p, p + K - 1, INVALID))

    ref_keys = _keys_of(ref)
    variant_id = iter(range(1, 1 << 20))
    crossing = rng.choice(np.arange(100, 2400), 40, replace=False)
    for n_var, p in zip([1, 2, 3] * 12 + [7, 7, 8, 9], crossing.tolist()):
        # a key that crosses n_var variants: one span, n_var labels
        key = int(ref_keys[p])
        labels[key] = [(p, p + K - 1, next(variant_id)) for _ in range(n_var)]
    big = rng.choice(np.arange(3000, 3900), 6, replace=False)
    for p, var in zip(big.tolist(), [1 << 24, (1 << 24) + 5, 0x7FFFFFF0, 0x7FFFFFFF, (1 << 24) - 1, 0]):
        key = int(ref_keys[p])
        labels[key] = [(p, p + K - 1, var), (p, p + K - 1, next(variant_id))]

    # special positions: keys that no reference 32-mer has
    special = rng.integers(0, 1 << 62, 12, dtype=np.uint64).tolist()
    for i, key in enumerate(special[:-1]):
        start = SPECIAL_START + 31 * i
        labels[key] = [(start, start + K - 1, INVALID if i % 2 else next(variant_id))]
    labels[special[-1]] = [(0xFFFFFFFF - 31, 0xFFFFFFFF, INVALID)]

    keys = np.array(sorted(labels), np.uint64)
    offsets = np.zeros(len(keys) + 1, np.int64)
    offsets[1:] = np.cumsum([len(labels[k]) for k in keys.tolist()])
    flat = [lab for k in keys.tolist() for lab in labels[k]]
    lab_start, lab_end, lab_var = (np.array(c, np.int64) for c in zip(*flat))

    # reference nodes of 8 to 400 bases tiling the reference; the arena
    # holds them in order, with a few tag codes
    cuts = np.unique(np.concatenate([[0], np.cumsum(rng.integers(8, 400, ref_len // 8))]))
    cuts = cuts[cuts < ref_len]
    ref_order = cuts.astype(np.int64)
    ref_dna_len = np.diff(np.append(cuts, ref_len)).astype(np.int64)
    arena = ref.copy()
    arena[rng.choice(ref_len, 8, replace=False)] = 6
    return dict(
        keys=keys, offsets=offsets, lab_start=lab_start, lab_end=lab_end, lab_var=lab_var,
        ref_order=ref_order, ref_dna_len=ref_dna_len, ref_dna_start=ref_order.copy(),
        ref_arena=arena, ref_codes=ref, special_keys=np.array(special, np.uint64),
        crossing=np.concatenate([crossing, big]),
    )


def rows_from_reads(reads: list[np.ndarray], nk: int):
    """(hi, lo, valid, tails, lens) of read-orientation rows in the layout
    of gt_prep_fetch_kmers / gt_prep_fetch_tails: kmer i starts at base
    31 i and is valid when it fits the read and has no code >= 4; the tail
    is the bases after the last full kmer of the read, padded with 15."""
    n = len(reads)
    hi = np.zeros((n, nk), np.uint32)
    lo = np.zeros((n, nk), np.uint32)
    valid = np.zeros((n, nk), np.uint8)
    tails = np.full((n, TAIL_PAD), 15, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for row, codes in enumerate(reads):
        for i in range(nk):
            p = (K - 1) * i
            if p + K > len(codes) or (codes[p : p + K] >= 4).any():
                continue
            key = int(_keys_of(codes[p : p + K])[0])
            hi[row, i], lo[row, i], valid[row, i] = key >> 32, key & 0xFFFFFFFF, 1
        if len(codes) >= K:
            start = 31 * (1 + (len(codes) - K) // (K - 1)) + 1
            t = codes[start : start + TAIL_PAD]
            tails[row, : len(t)] = t
    return hi, lo, valid, tails, lens


def synthetic_rows(index: dict, nk: int, seed: int = 1, n: int = 600):
    """Rows against `synthetic_index`: reads of the reference (most of
    them clean), with edits, and rows of keys the reference lacks."""
    rng = np.random.default_rng(seed)
    ref = index["ref_codes"]
    max_len = 31 * nk + 31
    lengths = [0, 1, 20, 31, 32, 40, 62, 63, 64, 93, 94, 100, 124, 125, 151, max_len]
    # reads whose kmer j is a variant key, and reads over node ends
    starts = [c - 31 * j for j in range(3) for c in index["crossing"]]
    starts += list(index["ref_order"][1:] - 40)
    reads = []
    for i in range(n):
        L = int(rng.choice(lengths)) if i % 3 else min(151, max_len)
        p = int(starts[i % len(starts)]) if i % 4 == 0 else int(rng.integers(0, len(ref) - L + 1))
        p = max(0, min(p, len(ref) - L))
        codes = ref[p : p + L].copy()
        edit = i % 9
        if L and edit == 1:  # mismatches in the tail
            for q in rng.choice(np.arange(max(0, L - 30), L), int(rng.integers(1, 4))):
                codes[q] = (codes[q] + 1) % 4
        elif L and edit == 2:  # an N in the tail or in a kmer
            codes[int(rng.integers(0, L))] = 4
        elif L and edit == 3:  # a mismatch inside a kmer
            codes[int(rng.integers(0, L))] ^= 2
        reads.append(codes)
    hi, lo, valid, tails, lens = rows_from_reads(reads, nk)

    # rows of random keys (mostly not found) and of the special keys
    m = n // 6
    extra_hi = rng.integers(0, 1 << 32, (m, nk), dtype=np.uint64).astype(np.uint32)
    extra_lo = rng.integers(0, 1 << 32, (m, nk), dtype=np.uint64).astype(np.uint32)
    sk = index["special_keys"]
    for r in range(0, m, 2):
        k = sk[rng.integers(0, len(sk), nk)]
        extra_hi[r], extra_lo[r] = k >> np.uint64(32), k & np.uint64(0xFFFFFFFF)
    extra_hi[1, 0], extra_lo[1, 0] = 0xFFFFFFFF, 0xFFFFFFFF  # past every key
    extra_hi[3, 0], extra_lo[3, 0] = 0, 0  # the poly-A key
    extra_valid = (rng.random((m, nk)) < 0.9).astype(np.uint8)
    extra_tails = rng.integers(0, 7, (m, TAIL_PAD)).astype(np.uint8)
    extra_tails[rng.random((m, TAIL_PAD)) < 0.2] = 15
    extra_lens = rng.choice(np.array(lengths, np.int32), m)
    return (np.concatenate([hi, extra_hi]), np.concatenate([lo, extra_lo]),
            np.concatenate([valid, extra_valid]), np.concatenate([tails, extra_tails]),
            np.concatenate([lens, extra_lens]))


def sample_rows(rows, n: int, seed: int = 5):
    """n rows drawn with replacement from `rows` (hi, lo, valid, tails, lens)."""
    pick = np.random.default_rng(seed).integers(0, len(rows[-1]), n)
    return tuple(np.ascontiguousarray(a[pick]) for a in rows)


EDGE_SHIFT = 96  # bytes the arena offsets of the first and last nodes move


def arena_edge_index(seed: int = 0) -> dict:
    """`synthetic_index` with the arena offsets of the nodes that start in
    the reference's first and last 200 bases moved EDGE_SHIFT bytes back and
    forth: the tail of a read whose chain ends within about EDGE_SHIFT bases
    of either end of the reference reads arena bytes before index 0 or past
    the arena's last byte."""
    idx = synthetic_index(seed)
    order, start = idx["ref_order"], idx["ref_dna_start"].copy()
    start[order < 200] -= EDGE_SHIFT
    start[order >= len(idx["ref_codes"]) - 200] += EDGE_SHIFT
    idx["ref_dna_start"] = start
    return idx


def arena_edge_rows(index: dict, nk: int, seed: int = 0, n: int = 360):
    """Reads of 1 to min(nk, 3) kmers and every tail length from 1 to 30,
    half of them starting in the reference's first 40 bases and half ending
    0 to 118 bases before its last base, some with tail mismatches."""
    rng = np.random.default_rng(seed)
    ref = index["ref_codes"]
    reads = []
    for i in range(n):
        nk_r = 1 + (i // 2) % min(nk, 3)
        L = 31 * nk_r + 1 + 1 + (i // 6) % 30
        p = (i // 2) % 40 if i % 2 == 0 else len(ref) - L - 2 * ((i // 2) % 60)
        codes = ref[p : p + L].copy()
        if i % 5 == 0:  # mismatches in the tail
            q = rng.integers(31 * nk_r + 1, L, 2)
            codes[q] = (codes[q] + 1) % 4
        reads.append(codes)
    return rows_from_reads(reads, nk)
