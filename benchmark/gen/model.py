"""The benchmark's model of sequencing data, in NumPy.

The generative model of the port's `utils/simulate.py` (an iid
reference, SNPs and short indels at uniform places, diploid genotypes
(or, for a cohort, a population's sites under the neutral spectrum),
paired 151 bp reads from the two haplotypes at uniform fragment starts,
substitution errors at a flat rate), rewritten on arrays: reads, errors
and cigars are made for all reads of a sample at once. The counts of
sites, indels, genotypes, reads and errors follow the rates exactly and
only the places are drawn, so every seed makes the same amount of work.
Nothing here imports the port.

Coordinates are 0-based. A variant is (pos, ref, alt) with ref/alt as
bytes; an insertion keeps its anchor base (ref = 1 base, alt = anchor +
inserted bases) and a deletion likewise (ref = anchor + deleted bases).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# base -> code 0..3 (N and anything else -> 0; the model makes no N)
CODE = np.zeros(256, dtype=np.uint8)
CODE[BASES] = np.arange(4, dtype=np.uint8)

# cigar operation codes of the BAM spec
OP_M, OP_I, OP_D = 0, 1, 2

FLAG_R1 = 99   # paired, proper pair, mate reverse, first in pair
FLAG_R2 = 147  # paired, proper pair, reverse, second in pair


@dataclass
class Variants:
    pos: np.ndarray        # [V] int64, 0-based, sorted
    ref: list              # [V] bytes
    alt: list              # [V] bytes

    def __len__(self) -> int:
        return len(self.pos)

    @property
    def is_snp(self) -> np.ndarray:
        return np.array([len(r) == 1 and len(a) == 1 for r, a in zip(self.ref, self.alt)], dtype=bool)

    @property
    def ref_end(self) -> np.ndarray:
        """Exclusive end of each variant's reference span."""
        return self.pos + np.array([len(r) for r in self.ref], dtype=np.int64)


@dataclass
class Reads:
    """One sample's reads, sorted by position. `cigars[i]` is an int32
    array of BAM cigar words (length << 4 | op)."""

    pos: np.ndarray        # [n] int64
    end: np.ndarray        # [n] int64, exclusive reference end
    flag: np.ndarray       # [n] uint16
    mate_pos: np.ndarray   # [n] int64
    tlen: np.ndarray       # [n] int64
    pair: np.ndarray       # [n] int64, the pair number (the name)
    seq: np.ndarray        # [n, L] uint8 ASCII bases
    qual: np.ndarray       # [n, L] uint8 phred
    cigars: list           # [n] of int32 arrays
    # per read where reads differ (an SV region's reads; benchmark/gen/sv.py):
    # MAPQ, and the contig of the read and of its mate (-1: no place)
    mapq: np.ndarray | None = None
    ref_id: np.ndarray | None = None
    next_ref_id: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.pos)


def random_reference(rng: np.random.Generator, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=n)]


def make_variants(rng: np.random.Generator, seq: np.ndarray, n_sites: int, n_indels: int,
                  max_indel_len: int, blocked: list | None = None) -> Variants:
    """`n_sites` sites at uniform places 100 bp or more from each end (a
    SNP at least 2 bp before the next site, an indel its reference span
    and 2 bp more), `n_indels` of them indels, half deletions and half
    insertions of 1..max_indel_len bases, the others SNPs to one of the
    three other bases. The counts are fixed, so that every seed gives the
    same amount of work; the places and kinds are drawn.

    `blocked` (sorted, disjoint [start, end) zones, each wider than an
    indel) takes stretches out: the places are drawn on the sequence with
    the zones cut out, and each zone is put back before the first place
    at or after its start, so no site starts inside one. With no zones
    the draws and places are those without the argument."""
    indel = np.zeros(n_sites, dtype=bool)
    indel[rng.choice(n_sites, size=n_indels, replace=False)] = True
    ilen = rng.integers(1, max_indel_len + 1, size=n_sites)
    dele = indel & (rng.random(n_sites) < 0.5)
    span = np.where(dele, 1 + ilen, 1)
    spacing = np.where(indel, span + 2, 2)
    zones = np.array(blocked or [], dtype=np.int64).reshape(-1, 2)
    widths = zones[:, 1] - zones[:, 0]
    lo, hi = 100, len(seq) - 100 - int(widths.sum())
    slack = hi - lo - int(spacing.sum())
    if slack < 0:
        raise ValueError(f"{n_sites} sites do not fit in {len(seq)} bp")
    pos = lo + np.concatenate([[0], np.cumsum(spacing)[:-1]]) + np.sort(rng.integers(0, slack + 1, size=n_sites))
    if len(zones):
        before = np.concatenate([[0], np.cumsum(widths)])
        pos = pos + before[np.searchsorted(zones[:, 0] - before[:-1], pos, side="right")]
    shift = rng.integers(1, 4, size=n_sites)
    ref_l, alt_l = [], []
    for p, i, d, n, k in zip(pos.tolist(), indel.tolist(), dele.tolist(), ilen.tolist(), shift.tolist()):
        if d:
            ref_l.append(seq[p : p + 1 + n].tobytes())
            alt_l.append(seq[p : p + 1].tobytes())
        elif i:
            ref_l.append(seq[p : p + 1].tobytes())
            alt_l.append(ref_l[-1] + random_reference(rng, n).tobytes())
        else:
            ref_l.append(seq[p : p + 1].tobytes())
            alt_l.append(bytes([int(BASES[(int(CODE[seq[p]]) + k) % 4])]))
    return Variants(pos.astype(np.int64), ref_l, alt_l)


def own_site_genotypes(rng: np.random.Generator, n_variants: int, n_samples: int) -> np.ndarray:
    """[V, n_samples, 2] uint8 haplotype alleles of a genome's own variant
    sites: every sample carries every site, each of the three
    non-reference genotypes at a third of them, the sites drawn."""
    pick = rng.permuted(np.tile(np.arange(n_variants) % 3, (n_samples, 1)), axis=1).T
    table = np.array([[0, 1], [1, 0], [1, 1]], dtype=np.uint8)
    return table[pick]


def neutral_site_rate(theta: float, n_haplotypes: int) -> float:
    """Watterson's density of segregating sites among `n_haplotypes`
    haplotypes: theta times the sum of 1/i for i < n."""
    return theta * float(np.sum(1.0 / np.arange(1, n_haplotypes)))


def neutral_genotypes(rng: np.random.Generator, n_variants: int, n_samples: int) -> np.ndarray:
    """[V, n_samples, 2] uint8 haplotype alleles of a population's
    segregating sites under the neutral frequency spectrum: a site's alt
    is on i of the 2n haplotypes with probability proportional to 1/i
    (i = 1 .. 2n - 1), those i drawn uniformly. The V counts are the
    spectrum's quantiles at (j + 1/2) / V, dealt to the sites at random,
    so every seed carries the same alleles in all."""
    n_hap = 2 * n_samples
    i = np.arange(1, n_hap)
    cdf = np.cumsum(1.0 / i) / np.sum(1.0 / i)
    count = i[np.searchsorted(cdf, (np.arange(n_variants) + 0.5) / n_variants)]
    count = rng.permutation(count)
    rank = np.argsort(np.argsort(rng.random((n_variants, n_hap)), axis=1), axis=1)
    return (rank < count[:, None]).astype(np.uint8).reshape(n_variants, n_samples, 2)


def haplotype(seq: np.ndarray, variants: Variants, alleles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The haplotype with `alleles` applied, and the reference position of
    each of its bases (inserted bases repeat the anchor's position)."""
    chunks, positions = [], []
    cur = 0
    for v in np.flatnonzero(alleles).tolist():
        pos, ref, alt = int(variants.pos[v]), variants.ref[v], variants.alt[v]
        chunks.append(seq[cur:pos])
        positions.append(np.arange(cur, pos, dtype=np.int64))
        chosen = np.frombuffer(alt, dtype=np.uint8)
        chunks.append(chosen)
        if len(alt) > len(ref):
            positions.append(np.full(len(chosen), pos, dtype=np.int64))
        else:
            positions.append(pos + np.arange(len(chosen), dtype=np.int64))
        cur = pos + len(ref)
    chunks.append(seq[cur:])
    positions.append(np.arange(cur, len(seq), dtype=np.int64))
    return np.concatenate(chunks), np.concatenate(positions)


def _cigars(pos: np.ndarray) -> tuple[list, np.ndarray]:
    """Aligner-style cigars from the reference positions of each read's
    bases (a repeat is an inserted base, a jump of d > 1 a deletion of d - 1
    bases), for all reads at once. Returns the cigar word arrays and each
    read's reference span."""
    m, L = pos.shape
    if m == 0:
        return [], np.zeros(0, dtype=np.int64)
    dm = np.diff(pos, axis=1)
    # op of each base: base 0 is M, base k >= 1 is I where it repeats the
    # position before it; a run starts where the op changes or a deletion
    # (a jump past one) comes before the base
    ops = np.zeros((m, L), dtype=np.int64)
    ops[:, 1:] = np.where(dm == 0, OP_I, OP_M)
    dele = np.zeros((m, L), dtype=np.int64)
    dele[:, 1:] = np.where(dm > 1, dm - 1, 0)
    brk = np.ones((m, L), dtype=bool)
    brk[:, 1:] = (ops[:, 1:] != ops[:, :-1]) | (dele[:, 1:] > 0)
    r, k = np.nonzero(brk)                      # run starts, row-major
    nxt = np.append(k[1:], L)
    nxt[np.append(r[1:] != r[:-1], True)] = L   # a row's last run ends at L
    run_words = ((nxt - k) << 4) | ops[r, k]
    has_d = dele[r, k] > 0
    # each run start emits [D word if a deletion precedes it] + run word
    n_words = 1 + has_d.astype(np.int64)
    words = np.empty(int(n_words.sum()), dtype=np.int64)
    at = np.cumsum(n_words) - 1                 # slot of each run word
    words[at] = run_words
    words[at[has_d] - 1] = (dele[r[has_d], k[has_d]] << 4) | OP_D
    per_row = np.bincount(r, weights=n_words, minlength=m).astype(np.int64)
    out = np.split(words.astype(np.int32), np.cumsum(per_row)[:-1])
    return out, pos[:, -1] - pos[:, 0] + 1


def simulate_reads(rng: np.random.Generator, haps: list, n_pairs: int, read_length: int, insert_mean: float,
                   insert_sd: float, error_rate: float, qual: int) -> Reads:
    """`n_pairs` pairs, pair i from haplotype i % 2: a fragment length
    from N(insert_mean, insert_sd) clamped to [L + 10, len - 1], a uniform
    start, read 1 forward at the start and read 2 reverse at the far end;
    Binomial(bases, error_rate) substitution errors at uniform places, each
    to one of the three other bases."""
    L = read_length
    hap_of = np.arange(n_pairs) % 2
    frag = rng.normal(insert_mean, insert_sd, size=n_pairs).astype(np.int64)
    hap_len = np.array([len(h[0]) for h in haps], dtype=np.int64)[hap_of]
    frag = np.clip(frag, L + 10, hap_len - 1)
    start = (rng.random(n_pairs) * (hap_len - frag)).astype(np.int64)
    n = 2 * n_pairs
    seq = np.empty((n, L), dtype=np.uint8)
    pos = np.empty(n, dtype=np.int64)
    span = np.full(n, L, dtype=np.int64)
    cigars = [None] * n
    plain_word = np.array([(L << 4) | OP_M], dtype=np.int32)
    for h, (hseq, hpos) in enumerate(haps):
        sel = np.flatnonzero(hap_of == h)
        # bases [s, s + L) of the haplotype are plain when no step between
        # neighbouring bases' reference positions differs from 1
        steps = np.zeros(len(hpos), dtype=np.int64)
        np.cumsum(np.diff(hpos) != 1, out=steps[1:])
        seq_win = np.lib.stride_tricks.sliding_window_view(hseq, L)
        pos_win = np.lib.stride_tricks.sliding_window_view(hpos, L)
        for rows, s in ((2 * sel, start[sel]), (2 * sel + 1, start[sel] + frag[sel] - L)):
            seq[rows] = seq_win[s]
            pos[rows] = hpos[s]
            plain = steps[s + L - 1] == steps[s]
            for i in rows[plain]:
                cigars[i] = plain_word
            odd = ~plain
            words, sp = _cigars(pos_win[s[odd]])
            for i, w in zip(rows[odd], words):
                cigars[i] = w
            span[rows[odd]] = sp
    n_err = round(n * L * error_rate)
    at = rng.integers(0, n * L, size=n_err)
    flat = seq.reshape(-1)
    flat[at] = BASES[(CODE[flat[at]] + rng.integers(1, 4, size=n_err, dtype=np.uint8)) % 4]
    end = pos + span
    p1, p2 = pos[0::2], pos[1::2]
    mate = np.empty_like(pos)
    mate[0::2], mate[1::2] = p2, p1
    tl = end[1::2] - p1
    tlen = np.empty_like(pos)
    tlen[0::2], tlen[1::2] = tl, -tl
    flag = np.tile(np.array([FLAG_R1, FLAG_R2], dtype=np.uint16), n_pairs)
    pair = np.repeat(np.arange(n_pairs, dtype=np.int64), 2)
    order = np.argsort(pos, kind="stable")
    return Reads(
        pos=pos[order], end=end[order], flag=flag[order], mate_pos=mate[order], tlen=tlen[order],
        pair=pair[order], seq=seq[order], qual=np.full(seq.shape, qual, dtype=np.uint8),
        cigars=[cigars[i] for i in order],
    )
