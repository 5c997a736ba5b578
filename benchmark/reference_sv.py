"""The plain reference of a `genotype_sv` cell: each placed SV genotyped
in each sample from the reads that span its junctions, and the comparison
of a job's AGGREGATED records with those calls.

Independent of the program: it reads the reads and the SVs that the
generator made (regenerated from the seed; benchmark/gen/sv.py), never
the program's files or state, and imports nothing of the program.

A junction is the meeting of two stretches: a reference junction at each
breakpoint of the reference (x1 and x2; x1 alone for an insertion), an
alternate junction where the carrying haplotype joins what the reference
does not:

    DEL  ref[:x1] | ref[x2:]
    DUP  ref[:x2] | ref[x1:]                 (the second copy's start)
    INV  ref[:x1] | revcomp(ref[x1:x2]) | ref[x2:]   (two joins)
    INS  ref[:x1] | inserted | ref[x1:]             (two joins)

A read spans a junction when its bases, on either strand, hold the
junction's FLANK bp on each side with at most MAX_MISMATCH mismatches in
those 2 * FLANK bp. A read that spans a reference junction explains the
reference allele; one that spans an alternate junction, the alternate;
one that spans both, either. Only reads with a place in the file are
read (a pair wholly inside an insertion has none, and no region query
reaches it).

Genotypes follow graphtyper's integer likelihood model, as
benchmark/reference.py uses it: a read that explains one allele adds eps
to the genotypes that hold only that allele and eps - 1 to the
heterozygote, eps = 8 less its mismatches in the window; PL = rint((max -
score) * 10 log10 2) capped at 255, GT the least PL, no call where every
genotype scores alike. A tandem duplication leaves both reference
junctions on the carrying haplotype too, so no read speaks against it;
there the share of alternate spans decides, as in graphtyper's
duplication model: a haplotype without it holds the two reference
junctions, one with it those two and the alternate one, so of the spans
of the three junctions (a read counts once for each junction it spans,
as one of a short duplication may span two) the alternate ones are 0,
1/5 and 1/3 under 0/0, 0/1 and 1/1 (phred 25 an alternate span under
0/0, the rest -10 log10 of each span's share); beside them the depth: the
mapped reads that start in (x1, x2 - L] (those clipped at the second
copy's start lie at x1), Poisson with the sample's mean rate of read
starts a bp times (2 + GT) / 2 (phred -10 log10 of each genotype's
probability).

What the program derives in its own way is compared by shares over many
(SV, sample) pairs, with limits set from measured readings (PERF.md).
"""

from __future__ import annotations

import gzip

import numpy as np

from benchmark.gen.model import CODE, Reads
from benchmark.gen.sv import COMP, SVs

FLANK = 20
MAX_MISMATCH = 1
EDGE = 1000          # SVs this close to a job's ends are not compared
NEAR = 1000          # an unmapped read lies this close to its mate, which is near the junction
LOG10_2_TIMES_10 = 3.0102999566398120
POW = 4 ** np.arange(FLANK - 1, -1, -1, dtype=np.int64)
# phred of a read at a duplication under 0/1 (alternate reads 1/5) and 1/1 (1/3)
DUP_ALT_1, DUP_REF_1 = -10 * np.log10(1 / 5), -10 * np.log10(4 / 5)
DUP_ALT_2, DUP_REF_2 = -10 * np.log10(1 / 3), -10 * np.log10(2 / 3)
PHRED_PER_NAT = 10 / np.log(10)


def junctions(seq: np.ndarray, svs: SVs, j: int) -> tuple[list, list]:
    """The reference and alternate junctions of SV j, each its 2 * FLANK
    bases (uint8 ASCII)."""
    F = FLANK
    a, b = int(svs.x1[j]), int(svs.x2[j])
    kind = svs.kind[j]
    at = lambda x: seq[x - F : x + F]
    rc = lambda s: COMP[s[::-1]]
    ins = np.frombuffer(svs.inserted[j], dtype=np.uint8)
    if kind == "DEL":
        return [at(a), at(b)], [np.concatenate([seq[a - F : a], seq[b : b + F]])]
    if kind == "DUP":
        return [at(a), at(b)], [np.concatenate([seq[b - F : b], seq[a : a + F]])]
    if kind == "INV":
        return [at(a), at(b)], [np.concatenate([seq[a - F : a], rc(seq[b - F : b])]),
                                np.concatenate([rc(seq[a : a + F]), seq[b : b + F]])]
    return [at(a)], [np.concatenate([seq[a - F : a], ins[:F]]), np.concatenate([ins[-F:], seq[a : a + F]])]


def _kmers(codes: np.ndarray) -> np.ndarray:
    """[R, L - FLANK + 1] codes of every FLANK-mer of each row."""
    return np.lib.stride_tricks.sliding_window_view(codes, FLANK, axis=1).astype(np.int64) @ POW


def _support(codes: np.ndarray, kmers: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Per read, its fewest mismatches against `window` at any place where
    it holds the whole window (MAX_MISMATCH + 1 where none is within
    MAX_MISMATCH). A read within MAX_MISMATCH (< 2) of the window matches
    one of its halves exactly, so only those places are tried."""
    R, L = codes.shape
    w = CODE[window]
    best = np.full(R, MAX_MISMATCH + 1, dtype=np.int64)
    left, right = int(w[:FLANK].astype(np.int64) @ POW), int(w[FLANK:].astype(np.int64) @ POW)
    r1, t1 = np.nonzero(kmers == left)
    r2, t2 = np.nonzero(kmers == right)
    r, t = np.concatenate([r1, r2]), np.concatenate([t1, t2 - FLANK])
    ok = (t >= 0) & (t <= L - 2 * FLANK)
    r, t = r[ok], t[ok]
    if len(r):
        mism = (codes[r[:, None], t[:, None] + np.arange(2 * FLANK)] != w).sum(axis=1)
        np.minimum.at(best, r, mism)
    return best


def sample_counts(seq: np.ndarray, svs: SVs, j: int, reads: Reads) -> tuple[np.ndarray, np.ndarray]:
    """[reads, junctions] mismatches of each read near SV j that spans
    one of its junctions against each of them (MAX_MISMATCH + 1 where it
    does not span it), the reference junctions first; and how many of
    those are reference junctions."""
    L = reads.seq.shape[1]
    placed = int((reads.pos >= 0).sum())
    pos = reads.pos[:placed]
    a, b = int(svs.x1[j]), int(svs.x2[j])
    lo, hi = np.searchsorted(pos, [a - L - NEAR, b + NEAR + 1])
    idx = np.arange(lo, hi)
    unmapped = (reads.flag[idx] & 0x4) > 0
    near = np.zeros(len(idx), dtype=bool)
    for x in {a, b}:
        near |= (pos[idx] >= x - L - FLANK) & (pos[idx] <= x + FLANK)
    idx = idx[near | unmapped]
    ref_w, alt_w = junctions(seq, svs, j)
    if not len(idx):
        return np.zeros((0, len(ref_w) + len(alt_w)), np.int64), len(ref_w)
    fwd = CODE[reads.seq[idx]]
    codes = np.concatenate([fwd, 3 - fwd[:, ::-1]])
    kmers = _kmers(codes)
    n = len(idx)
    mism = np.stack([_support(codes, kmers, w).reshape(2, n).min(axis=0) for w in ref_w + alt_w], axis=1)
    return mism[(mism <= MAX_MISMATCH).any(axis=1)], len(ref_w)


def genotype(kind: str, mism: np.ndarray, n_ref_junctions: int, depth: tuple | None = None) -> int:
    """GT as an alt-allele count (-1: no call) from the reads that span the
    SV's junctions (`sample_counts`), and at a duplication the depth inside
    it (`dup_depth`)."""
    spans = mism <= MAX_MISMATCH
    on_ref, on_alt = spans[:, :n_ref_junctions], spans[:, n_ref_junctions:]
    if kind == "DUP":
        n_ref, n_alt = int(on_ref.sum()), int(on_alt.sum())
        if n_ref + n_alt == 0:
            return -1
        cost = np.array([25.0 * n_alt, DUP_ALT_1 * n_alt + DUP_REF_1 * n_ref, DUP_ALT_2 * n_alt + DUP_REF_2 * n_ref])
        if depth is not None:
            k, lam = depth
            lam = lam * np.array([1.0, 1.5, 2.0])
            cost = cost - PHRED_PER_NAT * (k * np.log(lam) - lam)
        return int(np.argmin(cost))
    explains = on_ref.any(axis=1) * 1 + on_alt.any(axis=1) * 2
    mismatches = np.where(spans, mism, MAX_MISMATCH + 1).min(axis=1)
    eps = 8 - mismatches
    has0, has1 = (explains & 1) > 0, (explains & 2) > 0
    score = np.array([np.where(has0, eps, 0).sum(), np.where(has0 & has1, eps, np.where(has0 | has1, eps - 1, 0)).sum(),
                      np.where(has1, eps, 0).sum()], dtype=np.int64)
    if (score == score.max()).all():
        return -1
    raw = np.minimum(np.rint((score.max() - score) * LOG10_2_TIMES_10).astype(np.int64), 255)
    return int(np.argmin(raw))


def dup_depth(seq: np.ndarray, svs: SVs, j: int, reads: Reads) -> tuple[int, float] | None:
    """(mapped reads that start in (x1, x2 - L], their expected number
    without the duplication), or None where no read fits inside it."""
    L = reads.seq.shape[1]
    a, b = int(svs.x1[j]) + 1, int(svs.x2[j]) - L
    if b < a:
        return None
    mapped = reads.pos[(reads.flag & 0x4) == 0]
    k = int(np.searchsorted(mapped, b, side="right") - np.searchsorted(mapped, a))
    return k, len(mapped) / len(seq) * (b - a + 1)


def call_svs(seq: np.ndarray, svs: SVs, reads: list) -> np.ndarray:
    """[N, n_samples] GT of every SV in every sample."""
    gt = np.full((len(svs), len(reads)), -1, dtype=np.int64)
    for s, r in enumerate(reads):
        for j in range(len(svs)):
            depth = dup_depth(seq, svs, j, r) if svs.kind[j] == "DUP" else None
            gt[j, s] = genotype(svs.kind[j], *sample_counts(seq, svs, j, r), depth)
    return gt


def read_sv_vcfs(paths: list, n_samples: int) -> dict:
    """The program's AGGREGATED records of one job: panel ID (the record's
    OLD_VARIANT_ID) -> per sample GT as an alt-allele count (-1 missing)."""
    out = {}
    for path in paths:
        with gzip.open(path, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                col = line.rstrip("\n").split("\t")
                info = dict(kv.split("=", 1) if "=" in kv else (kv, "") for kv in col[7].split(";"))
                if info.get("SVMODEL") != "AGGREGATED" or "OLD_VARIANT_ID" not in info:
                    continue
                keys = col[8].split(":")
                gt = np.full(n_samples, -1, dtype=np.int64)
                for s, c in enumerate(col[9 : 9 + n_samples]):
                    a = dict(zip(keys, c.split(":"))).get("GT", "./.").replace("|", "/").split("/")
                    if "." not in a:
                        gt[s] = sum(int(x) > 0 for x in a)
                out[info["OLD_VARIANT_ID"]] = gt
    return out


def compare(job: dict, svs: SVs, length: int, ref_gt: np.ndarray) -> dict:
    """The sums behind the numbers compared for one job; the harness adds
    them over the window's jobs. Over the SVs whole inside the job and EDGE
    bp or more from its ends:

    sv_mismatch_pairs / sv_pairs   (SV, sample) pairs where either side
        calls an alternate allele (a missing record calls none) whose GT
        differ
    sv_missed / sv_carried         SVs that the reference calls in some
        sample with no AGGREGATED record
    """
    inner = (svs.x1 - 1 >= EDGE) & (svs.x2 <= length - EDGE)
    S = ref_gt.shape[1]
    got = np.stack([job.get(i, np.zeros(S, dtype=np.int64)) for i in svs.ids]) if len(svs) else ref_gt
    pairs = inner[:, None] & ((ref_gt > 0) | (got > 0))
    carried = inner & (ref_gt > 0).any(axis=1)
    missed = carried & np.array([i not in job for i in svs.ids], dtype=bool)
    return dict(sv_pairs=int(pairs.sum()), sv_mismatch_pairs=int((pairs & (got != ref_gt)).sum()),
                sv_carried=int(carried.sum()), sv_missed=int(missed.sum()))


def control_calls(svs: SVs, gt: np.ndarray) -> dict:
    """`gt` as the program's records would hold them: a record for every
    SV that some sample carries."""
    return {i: gt[j] for j, i in enumerate(svs.ids) if (gt[j] > 0).any()}
