"""The plain reference: a pileup genotyper over the benchmark's own reads,
and the comparison of a job's VCF records with it.

Independent of the program: it reads the reads and the truth that the
generator made (regenerated from the seed), never the program's files
or state, and imports nothing of the program. It genotypes every site
that the generator placed, with graphtyper's integer likelihood model
(haplotype.cpp explain_to_score: a read that explains both alleles of a
genotype adds eps, one that explains one of them eps - 1; eps = max(12 -
mismatches - 1 if the read ends within 3 bp of the site, 8) - 4; PL =
rint((max - score) * 10 log10 2), capped at 255 and binned as
graphtyper writes it), where a read explains
the allele its bases show at the site: for a SNP the base at the site,
for an indel the indel in its cigar. A read whose base at a SNP is
neither allele, or that does not span an indel with 3 bp to spare on
each side, explains both.

What the program derives in its own way is compared by shares over many
sites, with limits set from measured readings (PERF.md): the genotype of
every (site, sample), and the depths and likelihoods at isolated SNPs,
where graphtyper's graph holds the site alone.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from benchmark.gen.model import OP_D, OP_I, OP_M, Reads, Variants

LOG10_2_TIMES_10 = 3.0102999566398120
EDGE = 3           # a read must reach this far past a site on both sides
ISOLATION = 300    # an isolated SNP has no other site this close
FLANK = 200        # sites this close to a job's ends are not compared
# graphtyper quantizes PL before output (binned_pl.hpp): PL p is written
# as BINNED_PL[min(p, 255)]
BINS = np.array([0, 1, 3, 6, 9, 12, 15, 20, 25, 30, 35, 40, 50, 60, 75, 99, 125, 150, 200, 255])
BINNED_PL = np.repeat(BINS, [1, 2, 2, 3, 3, 3, 4, 5, 5, 5, 5, 7, 10, 13, 12, 33, 25, 37, 53, 28])


@dataclass
class SiteCalls:
    """Per (site, sample): GT as an alt-allele count (-1: no coverage),
    AD [ref, alt], and PL [3]."""

    gt: np.ndarray     # [V, S] int64
    ad: np.ndarray     # [V, S, 2] int64
    pl: np.ndarray     # [V, S, 3] int64


def _cigar_refpos(pos: int, cigar: np.ndarray) -> tuple[np.ndarray, list]:
    """Reference position of each read base (-1 inside an insertion) and
    the read's indels as (anchor, op, length)."""
    out, indels = [], []
    r = pos
    for w in cigar.tolist():
        op, n = w & 0xF, w >> 4
        if op == OP_M:
            out.append(np.arange(r, r + n))
            r += n
        elif op == OP_I:
            out.append(np.full(n, -1))
            indels.append((r - 1, OP_I, n))
        elif op == OP_D:
            indels.append((r - 1, OP_D, n))
            r += n
    return np.concatenate(out), indels


def call_sample(seq: np.ndarray, variants: Variants, reads: Reads, keep: np.ndarray | None = None) -> tuple:
    """(GT, AD, PL) of one sample at every site, from its reads (or from
    the reads where `keep` is true)."""
    if keep is not None:
        sel = np.flatnonzero(keep)
        reads = Reads(reads.pos[sel], reads.end[sel], reads.flag[sel], reads.mate_pos[sel], reads.tlen[sel],
                      reads.pair[sel], reads.seq[sel], reads.qual[sel], [reads.cigars[i] for i in sel])
    n, L = reads.seq.shape
    V = len(variants)
    vpos, vend = variants.pos, variants.ref_end
    snp = variants.is_snp
    plain = np.array([len(c) == 1 for c in reads.cigars], dtype=bool)
    # mismatches of each read against the reference along its cigar
    mism = np.zeros(n, dtype=np.int64)
    idx = np.flatnonzero(plain)
    win = np.lib.stride_tricks.sliding_window_view(np.concatenate([seq, np.zeros(L, np.uint8)]), L)
    mism[idx] = (reads.seq[idx] != win[reads.pos[idx]]).sum(axis=1)
    odd_map = {}
    for i in np.flatnonzero(~plain).tolist():
        rp, indels = _cigar_refpos(int(reads.pos[i]), reads.cigars[i])
        m = rp >= 0
        mism[i] = int((reads.seq[i][m] != seq[rp[m]]).sum())
        odd_map[i] = (rp, indels)
    # the (site, read) pairs: reads whose span touches the site
    first = np.searchsorted(reads.pos, vpos - 2 * L, side="left")
    last = np.searchsorted(reads.pos, vend, side="left")
    counts = last - first
    pv = np.repeat(np.arange(V), counts)
    pr = (np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)) + np.repeat(first, counts)
    touch = (reads.pos[pr] <= vpos[pv]) & (reads.end[pr] > vpos[pv])
    pv, pr = pv[touch], pr[touch]
    # what each read explains at each site: 1 ref, 2 alt, 3 both
    expl = np.full(len(pv), 3, dtype=np.int64)
    s_pair = snp[pv]
    ref_b = np.array([r[0] for r in variants.ref], dtype=np.uint8)
    alt_b = np.array([a[0] for a in variants.alt], dtype=np.uint8)
    base = np.zeros(len(pv), dtype=np.uint8)
    k = np.flatnonzero(s_pair & plain[pr])
    base[k] = reads.seq[pr[k], vpos[pv[k]] - reads.pos[pr[k]]]
    for k in np.flatnonzero(s_pair & ~plain[pr]).tolist():
        at = np.flatnonzero(odd_map[int(pr[k])][0] == vpos[pv[k]])
        if len(at):
            base[k] = reads.seq[pr[k], int(at[0])]
    expl[s_pair & (base == alt_b[pv])] = 2
    expl[s_pair & (base == ref_b[pv])] = 1
    for k in np.flatnonzero(~s_pair).tolist():
        v, r = int(pv[k]), int(pr[k])
        p, e = int(vpos[v]), int(vend[v])
        if not (reads.pos[r] + EDGE <= p and reads.end[r] - EDGE > e):
            continue
        lr, la = len(variants.ref[v]), len(variants.alt[v])
        want = (p, OP_I, la - lr) if la > lr else (p, OP_D, lr - la)
        expl[k] = 2 if (not plain[r] and want in odd_map[r][1]) else 1
    # a read that shows the alt of a SNP follows it in the graph: no mismatch
    alt_snp = s_pair & (expl == 2)
    np.subtract.at(mism, pr[alt_snp], 1)
    overlapping = (reads.pos[pr] + EDGE <= vpos[pv]) & (reads.end[pr] - EDGE > vpos[pv])
    eps = np.maximum(12 - np.maximum(mism[pr], 0) - (~overlapping), 8) - 4
    # the likelihood triangle of genotypes 0/0, 0/1, 1/1
    has0, has1 = (expl & 1) > 0, (expl & 2) > 0
    score = np.zeros((V, 3), dtype=np.int64)
    np.add.at(score[:, 0], pv, np.where(has0, eps, 0))
    np.add.at(score[:, 1], pv, np.where(has0 & has1, eps, np.where(has0 | has1, eps - 1, 0)))
    np.add.at(score[:, 2], pv, np.where(has1, eps, 0))
    ad = np.zeros((V, 2), dtype=np.int64)
    np.add.at(ad[:, 0], pv, expl == 1)
    np.add.at(ad[:, 1], pv, expl == 2)
    best = score.max(axis=1, keepdims=True)
    raw = np.minimum(np.rint((best - score) * LOG10_2_TIMES_10).astype(np.int64), 255)
    flat = (score == best).all(axis=1)
    raw[flat] = 0
    gt = np.argmin(raw, axis=1)
    pl = BINNED_PL[raw]
    gt[flat] = -1
    return gt, ad, pl


def call_region(seq: np.ndarray, variants: Variants, reads: list[Reads], keep: list | None = None) -> SiteCalls:
    per = [call_sample(seq, variants, r, None if keep is None else keep[s]) for s, r in enumerate(reads)]
    return SiteCalls(np.stack([p[0] for p in per], axis=1), np.stack([p[1] for p in per], axis=1),
                     np.stack([p[2] for p in per], axis=1))


def isolated(variants: Variants, length: int) -> np.ndarray:
    """SNPs with no other site within ISOLATION bp and FLANK bp from the ends."""
    pos = variants.pos
    gap_l = np.diff(np.concatenate([[-10 ** 9], pos]))
    gap_r = np.diff(np.concatenate([pos, [10 ** 9]]))
    return variants.is_snp & (gap_l > ISOLATION) & (gap_r > ISOLATION) & (pos >= FLANK) & (pos < length - FLANK)


def normalize(pos: int, ref: bytes, alt: bytes, seq: np.ndarray) -> tuple[int, bytes, bytes]:
    """Left-aligned, minimal representation of a biallelic variant."""
    while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
        ref, alt = ref[:-1], alt[:-1]
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt, pos = ref[1:], alt[1:], pos + 1
    if len(ref) != len(alt):
        while pos > 0 and ref[-1] == alt[-1]:
            b = bytes([int(seq[pos - 1])])
            ref, alt, pos = b + ref[:-1], b + alt[:-1], pos - 1
    return pos, ref, alt


def read_vcfs(paths: list[str], seq: np.ndarray, n_samples: int) -> dict:
    """The program's calls of one job, by normalized (pos, ref, alt), each
    ALT of a record apart: per sample GT as an alt-allele count (-1
    missing), AD [ref, alt], and the PL of that allele's biallelic
    triangle."""
    out = {}
    for path in paths:
        with gzip.open(path, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                col = line.rstrip("\n").split("\t")
                pos0, ref, alts = int(col[1]) - 1, col[3].encode(), col[4].split(",")
                keys = col[8].split(":")
                fields = [dict(zip(keys, c.split(":"))) for c in col[9 : 9 + n_samples]]
                for ai, alt in enumerate(alts, start=1):
                    if alt.startswith("<") or alt == "*":
                        continue
                    key = normalize(pos0, ref, alt.encode(), seq)
                    gt = np.full(n_samples, -1, dtype=np.int64)
                    ad = np.zeros((n_samples, 2), dtype=np.int64)
                    pl = np.zeros((n_samples, 3), dtype=np.int64)
                    for s, fd in enumerate(fields):
                        a = fd.get("GT", "./.").replace("|", "/").split("/")
                        if "." not in a:
                            gt[s] = sum(int(x) == ai for x in a)
                        d = [int(x) if x != "." else 0 for x in fd.get("AD", "0").split(",")]
                        if len(d) > ai:
                            ad[s] = (d[0], d[ai])
                        p = [int(x) if x != "." else 0 for x in fd.get("PL", "0").split(",")]
                        tri = (0, ai * (ai + 1) // 2, ai * (ai + 1) // 2 + ai)
                        if len(p) > tri[2]:
                            pl[s] = [p[t] for t in tri]
                    out[key] = (gt, ad, pl)
    return out


def compare(job: dict, truth_seq: np.ndarray, variants: Variants, ref: SiteCalls) -> dict:
    """The sums behind the numbers compared for one job; the harness adds
    them over the window's jobs:

    pl_mismatch_pairs / pairs   (site, sample) pairs, over every site the
        generator placed (away from the job's ends) and every sample the
        reference genotypes there, whose binned PL differ from the
        reference's; a site the program does not report has PL 0,0,0
    ad_abs / ad_ref             over isolated SNPs that the program
        reports: sum |AD - AD_ref| over sum AD_ref
    pl_steps                    over the same: the largest distance between
        a PL and the reference's, in steps of graphtyper's PL bins
    false_sites / called_sites  over the program's alleles (away from the
        job's ends) that some sample's GT carries: those at no site the
        generator placed
    """
    V, S = ref.gt.shape
    length = len(truth_seq)
    inner = (variants.pos >= FLANK) & (variants.pos < length - FLANK)
    ad = np.zeros((V, S, 2), dtype=np.int64)
    pl = np.zeros((V, S, 3), dtype=np.int64)
    found = np.zeros(V, dtype=bool)
    placed = set()
    for v in range(V):
        key = normalize(int(variants.pos[v]), variants.ref[v], variants.alt[v], truth_seq)
        placed.add(key)
        hit = job.get(key)
        if hit is not None:
            found[v] = True
            ad[v], pl[v] = hit[1], hit[2]
    called = ref.gt >= 0
    pairs = inner[:, None] & called
    pl_mismatch = (pl != ref.pl).any(axis=2) & pairs
    iso = isolated(variants, length)[:, None] & called & found[:, None]
    ad_abs = int((np.abs(ad - ref.ad).sum(axis=2) * iso).sum())
    ad_ref = int((ref.ad.sum(axis=2) * iso).sum())
    steps = np.abs(np.searchsorted(BINS, pl) - np.searchsorted(BINS, ref.pl)).max(axis=2)
    pl_steps = int((steps * iso).max()) if iso.any() else 0
    carried = [key for key, (gt, _, _) in job.items() if FLANK <= key[0] < length - FLANK and (gt > 0).any()]
    return dict(pairs=int(pairs.sum()), pl_mismatch_pairs=int(pl_mismatch.sum()), ad_abs=ad_abs, ad_ref=ad_ref,
                pl_steps=pl_steps, isolated_pairs=int(iso.sum()), called_sites=len(carried),
                false_sites=sum(key not in placed for key in carried))


def control_calls(region, calls: SiteCalls) -> dict:
    """`calls` as the program's records would hold them: a record for
    every site that some sample carries."""
    out = {}
    for v in range(len(region.variants)):
        if (calls.gt[v] > 0).any():
            key = normalize(int(region.variants.pos[v]), region.variants.ref[v], region.variants.alt[v], region.seq)
            out[key] = (calls.gt[v], calls.ad[v], calls.pl[v])
    return out
