"""Structural variants in the benchmark's model, the sites-only panel VCF
that lists them, and reads mapped as a short-read aligner maps them.

A configuration's optional `svs` block:

    rate            SVs a bp: a region of n bp holds round(n * rate)
    shares          {"DEL": .., "DUP": .., "INV": .., "INS": ..}: each kind's
                    count, rounded by largest remainder so that they sum to
                    the whole
    min_bp, max_bp  sizes: the quantiles (j + 1/2) / N of a log-uniform law
                    between the two, dealt to the SVs at random
    genotypes       "neutral": carriers as a cohort's sites
                    (model.neutral_genotypes)

So every count, and the sizes in all, follow from the block; only kinds,
places and carriers are drawn. An SV lies EDGE bp or more from each end
of its region, in a zone of MARGIN bp on each side of its breakpoints
that no SNP or indel enters, the zones a read length apart.

Coordinates are 0-based: x1 is the first base the SV changes, x2 = x1 +
size (DEL, DUP, INV) or x1 (INS). On the haplotype that carries it:

    DEL  ref[:x1] + ref[x2:]
    DUP  ref[:x2] + ref[x1:x2] + ref[x2:]        (tandem)
    INV  ref[:x1] + revcomp(ref[x1:x2]) + ref[x2:]
    INS  ref[:x1] + inserted + ref[x1:]

The panel VCF (graphtyper's SV input) writes each as POS x1 (its anchor,
1-based), REF the anchor base, ALT <KIND>, INFO SVTYPE, SVLEN (negative
for a deletion), END (the span's last base, 1-based: x2; POS for an
insertion) and, for an insertion, SEQ. Nothing here imports the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.gen.model import BASES, CODE, OP_M, Reads, Variants, _cigars, haplotype, neutral_genotypes, \
    random_reference

KINDS = ("DEL", "DUP", "INV", "INS")
EDGE = 1000      # an SV lies this far or more from each end of its region
MARGIN = 50      # no SNP or indel this close to an SV's breakpoints
OP_S = 4         # soft clip
FLAG_PAIRED, FLAG_PROPER, FLAG_UNMAPPED, FLAG_MATE_UNMAPPED = 0x1, 0x2, 0x4, 0x8
FLAG_REVERSE, FLAG_MATE_REVERSE, FLAG_FIRST, FLAG_SECOND = 0x10, 0x20, 0x40, 0x80
COMP = np.zeros(256, dtype=np.uint8)
COMP[BASES] = BASES[::-1]


@dataclass
class SVs:
    kind: list            # [N] one of KINDS
    x1: np.ndarray        # [N] int64, sorted
    size: np.ndarray      # [N] int64
    inserted: list        # [N] bytes: an insertion's sequence, b"" otherwise
    ids: list             # [N] the panel's ID of each

    def __len__(self) -> int:
        return len(self.x1)

    @property
    def x2(self) -> np.ndarray:
        return self.x1 + np.where(np.array(self.kind) == "INS", 0, self.size)

    def zones(self) -> list:
        """[start, end) of each SV's zone that no SNP or indel enters."""
        return [(a - MARGIN, b + MARGIN) for a, b in zip(self.x1.tolist(), self.x2.tolist())]


def make_svs(rng: np.random.Generator, seq: np.ndarray, spec: dict, read_length: int) -> SVs:
    """The SVs of a region of `len(seq)` bp under an `svs` block."""
    length = len(seq)
    n = round(length * spec["rate"])
    share = np.array([spec["shares"].get(k, 0.0) for k in KINDS], dtype=np.float64)
    raw = n * share / share.sum()
    count = np.floor(raw).astype(np.int64)
    count[np.argsort(-(raw - count), kind="stable")[: n - int(count.sum())]] += 1
    kind = rng.permutation(np.repeat(np.arange(len(KINDS)), count))
    lo, hi = np.log(spec["min_bp"]), np.log(spec["max_bp"])
    size = rng.permutation(np.rint(np.exp(lo + (np.arange(n) + 0.5) / n * (hi - lo))).astype(np.int64))
    span = np.where(kind == KINDS.index("INS"), 0, size)
    width = span + 2 * MARGIN + read_length
    slack = length - 2 * EDGE - int(width.sum()) + read_length
    if slack < 0:
        raise ValueError(f"{n} SVs do not fit in {length} bp")
    x1 = EDGE + MARGIN + np.concatenate([[0], np.cumsum(width)[:-1]]) + np.sort(rng.integers(0, slack + 1, size=n))
    kinds = [KINDS[k] for k in kind.tolist()]
    inserted = [random_reference(rng, int(s)).tobytes() if k == "INS" else b"" for k, s in zip(kinds, size.tolist())]
    return SVs(kinds, x1.astype(np.int64), size, inserted, [f"sv{j:04d}" for j in range(n)])


def sv_genotypes(rng: np.random.Generator, spec: dict, n_svs: int, n_samples: int) -> np.ndarray:
    """[N, n_samples, 2] uint8 haplotype alleles of the SVs."""
    if spec.get("genotypes", "neutral") != "neutral":
        raise ValueError(f"SV genotypes {spec['genotypes']!r}: only 'neutral' is modelled")
    return neutral_genotypes(rng, n_svs, n_samples)


def write_panel(path: str, contig: str, seq: np.ndarray, svs: SVs) -> None:
    """The region's sites-only SV panel, in the form graphtyper reads."""
    lines = ["##fileformat=VCFv4.2", f"##contig=<ID={contig},length={len(seq)}>"]
    lines += [f"##ALT=<ID={k},Description=\"{k}\">" for k in KINDS]
    lines += ['##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
              '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length of the structural variant">',
              '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the structural variant">',
              '##INFO=<ID=SEQ,Number=1,Type=String,Description="Inserted sequence">',
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for k, a, b, s, ins, sv_id in zip(svs.kind, svs.x1.tolist(), svs.x2.tolist(), svs.size.tolist(), svs.inserted,
                                      svs.ids):
        svlen = -s if k == "DEL" else s
        info = f"SVTYPE={k};SVLEN={svlen};END={b if k != 'INS' else a}" + (f";SEQ={ins.decode()}" if ins else "")
        lines.append(f"{contig}\t{a}\t{sv_id}\t{chr(seq[a - 1])}\t<{k}>\t.\t.\t{info}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@dataclass
class Haplotype:
    """A haplotype with its SVs: each base's reference position and piece.
    Pieces are cut at every SV junction; a piece's positions run forward
    (with the small indels, as model.haplotype gives them), backward (an
    inversion) or not at all (inserted sequence, position -1), as
    `orient[piece]` says: 1, -1 or 0."""

    seq: np.ndarray
    pos: np.ndarray
    piece: np.ndarray
    orient: np.ndarray


def sv_haplotype(seq: np.ndarray, variants: Variants, alleles: np.ndarray, svs: SVs,
                 carried: np.ndarray) -> Haplotype:
    hseq, hpos = haplotype(seq, variants, alleles)
    parts, orient = [], [1]

    def add(s, p, o=None):
        if o is not None:
            orient.append(o)
        parts.append((s, p, np.full(len(s), len(orient) - 1, dtype=np.int32)))

    cur = 0
    for j in np.flatnonzero(carried).tolist():
        kind = svs.kind[j]
        # no small variant lies in an SV's zone, so positions step by one there
        i1, i2 = np.searchsorted(hpos, [svs.x1[j], svs.x2[j]])
        if kind == "DEL":
            add(hseq[cur:i1], hpos[cur:i1])
            cur = i2
        elif kind == "DUP":
            add(hseq[cur:i2], hpos[cur:i2])
            cur = i1
        elif kind == "INV":
            add(hseq[cur:i1], hpos[cur:i1])
            add(COMP[hseq[i1:i2][::-1]], hpos[i1:i2][::-1], -1)
            cur = i2
        else:
            add(hseq[cur:i1], hpos[cur:i1])
            add(np.frombuffer(svs.inserted[j], dtype=np.uint8), np.full(len(svs.inserted[j]), -1, np.int64), 0)
            cur = i1
        orient.append(1)
    add(hseq[cur:], hpos[cur:])
    return Haplotype(np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
                     np.concatenate([p[2] for p in parts]), np.array(orient, dtype=np.int64))


def simulate_sv_reads(rng: np.random.Generator, haps: list, n_pairs: int, read_length: int, insert_mean: float,
                      insert_sd: float, error_rate: float, qual: int, mapq: int) -> Reads:
    """model.simulate_reads's fragments, reads and errors over haplotypes
    with SVs (`Haplotype`s), mapped as a short-read aligner maps them:

    - a read inside one forward piece is aligned there, with the small
      indels in its cigar, as without SVs;
    - a read across a junction is aligned on its longest piece (the first
      of equal ones) and soft-clipped on the rest;
    - a read aligned in an inversion is on the other strand at the
      inverted place (its SEQ reverse-complemented, its strand flag
      flipped);
    - a read in a duplication's second copy is aligned at the first copy
      (the copy's positions are the first copy's);
    - a read whose longest piece is inserted sequence (every read wholly
      inside an insertion) is unmapped, MAPQ 0, with no cigar, its SEQ as
      sequenced, placed at its mate; where the mate is unmapped too, the
      pair has no place and comes after every placed read, where no region
      query reaches;
    - a pair is proper where both reads are mapped, on opposite strands,
      the forward read leftmost, and the template is at most
      insert_mean + 10 insert_sd long; TLEN is the template's length,
      positive on the leftmost read (read 1 where both start alike) and 0
      where a read is unmapped."""
    L = read_length
    hap_of = np.arange(n_pairs) % 2
    frag = rng.normal(insert_mean, insert_sd, size=n_pairs).astype(np.int64)
    hap_len = np.array([len(h.seq) for h in haps], dtype=np.int64)[hap_of]
    frag = np.clip(frag, L + 10, hap_len - 1)
    start = (rng.random(n_pairs) * (hap_len - frag)).astype(np.int64)
    n = 2 * n_pairs
    seq = np.empty((n, L), dtype=np.uint8)
    pos = np.full(n, -1, dtype=np.int64)
    span = np.full(n, L, dtype=np.int64)
    mapped = np.ones(n, dtype=bool)
    flip = np.zeros(n, dtype=bool)      # SEQ is the reverse complement of the haplotype's bases
    reverse = np.zeros(n, dtype=bool)
    cigars = [np.zeros(0, dtype=np.int32)] * n
    plain_word = np.array([(L << 4) | OP_M], dtype=np.int32)
    for h, hap in enumerate(haps):
        sel = np.flatnonzero(hap_of == h)
        steps = np.zeros(len(hap.pos), dtype=np.int64)
        np.cumsum(np.diff(hap.pos) != 1, out=steps[1:])
        seq_win = np.lib.stride_tricks.sliding_window_view(hap.seq, L)
        pos_win = np.lib.stride_tricks.sliding_window_view(hap.pos, L)
        for second, rows, s in ((False, 2 * sel, start[sel]), (True, 2 * sel + 1, start[sel] + frag[sel] - L)):
            seq[rows] = seq_win[s]
            first_piece = hap.piece[s]
            one = first_piece == hap.piece[s + L - 1]
            o = hap.orient[first_piece]
            fwd, inv = one & (o == 1), one & (o == -1)
            f_rows, f_s = rows[fwd], s[fwd]
            pos[f_rows] = hap.pos[f_s]
            reverse[f_rows] = second
            plain = steps[f_s + L - 1] == steps[f_s]
            for i in f_rows[plain]:
                cigars[i] = plain_word
            words, sp = _cigars(pos_win[f_s[~plain]])
            for i, w in zip(f_rows[~plain], words):
                cigars[i] = w
            span[f_rows[~plain]] = sp
            i_rows = rows[inv]
            pos[i_rows] = hap.pos[s[inv] + L - 1]
            reverse[i_rows] = not second
            flip[i_rows] = True
            for i in i_rows:
                cigars[i] = plain_word
            mapped[rows[one & (o == 0)]] = False
            for i, si in zip(rows[~one].tolist(), s[~one].tolist()):
                pc = hap.piece[si : si + L]
                bounds = np.concatenate([[0], np.flatnonzero(np.diff(pc)) + 1, [L]])
                k = int(np.argmax(np.diff(bounds)))
                a, b = int(bounds[k]), int(bounds[k + 1])
                o_run = int(hap.orient[pc[a]])
                if o_run == 0:
                    mapped[i] = False
                    continue
                if o_run == 1:
                    w, sp = _cigars(hap.pos[si + a : si + b][None])
                    body, left, right = w[0], a, L - b
                    pos[i], span[i], reverse[i] = hap.pos[si + a], sp[0], second
                else:
                    body, left, right = np.array([((b - a) << 4) | OP_M], dtype=np.int32), L - b, a
                    pos[i], span[i], reverse[i], flip[i] = hap.pos[si + b - 1], b - a, not second, True
                clips = [np.array([(left << 4) | OP_S], dtype=np.int32)] if left else []
                clips_r = [np.array([(right << 4) | OP_S], dtype=np.int32)] if right else []
                cigars[i] = np.concatenate(clips + [body] + clips_r).astype(np.int32)
    n_err = round(n * L * error_rate)
    at = rng.integers(0, n * L, size=n_err)
    flat = seq.reshape(-1)
    flat[at] = BASES[(CODE[flat[at]] + rng.integers(1, 4, size=n_err, dtype=np.uint8)) % 4]
    # an unmapped read keeps its bases as sequenced: read 2 is the reverse strand's
    second_read = np.tile(np.array([False, True]), n_pairs)
    flip = np.where(mapped, flip, second_read)
    reverse &= mapped
    seq[flip] = COMP[seq[flip][:, ::-1]]
    for i in np.flatnonzero(~mapped):
        cigars[i] = np.zeros(0, dtype=np.int32)
    # places: an unmapped read takes its mate's; a pair with neither read mapped has none
    mate = np.arange(n) ^ 1
    pos = np.where(mapped, pos, np.where(mapped[mate], pos[mate], -1))
    end = np.where(mapped, pos + span, pos + 1)
    both = mapped & mapped[mate]
    left = np.minimum(pos, pos[mate])
    tl = np.maximum(end, end[mate]) - left
    lead = (pos < pos[mate]) | ((pos == pos[mate]) & ~second_read)
    tlen = np.where(both, np.where(lead, tl, -tl), 0)
    fwd_pos = np.where(reverse, pos[mate], pos)
    rev_pos = np.where(reverse, pos, pos[mate])
    proper = both & (reverse != reverse[mate]) & (fwd_pos <= rev_pos) & (tl <= insert_mean + 10 * insert_sd)
    flag = (FLAG_PAIRED | np.where(second_read, FLAG_SECOND, FLAG_FIRST) | FLAG_PROPER * proper
            | FLAG_UNMAPPED * ~mapped | FLAG_MATE_UNMAPPED * ~mapped[mate] | FLAG_REVERSE * reverse
            | FLAG_MATE_REVERSE * reverse[mate]).astype(np.uint16)
    ref_id = np.where(pos >= 0, 0, -1)
    pair = np.repeat(np.arange(n_pairs, dtype=np.int64), 2)
    order = np.lexsort((pos, pos < 0))
    return Reads(
        pos=pos[order], end=end[order], flag=flag[order], mate_pos=pos[mate][order], tlen=tlen[order],
        pair=pair[order], seq=seq[order], qual=np.full(seq.shape, qual, dtype=np.uint8),
        cigars=[cigars[i] for i in order], mapq=np.where(mapped, mapq, 0)[order], ref_id=ref_id[order],
        next_ref_id=ref_id[mate][order],
    )

