"""Extract variant candidates from a gapped read-vs-reference alignment.

Port of the live parts of the reference's haplotype extractor
(haplotype_extractor.cpp:94-325): semi-global affine alignment of a read
against its local reference window (match 2 / mismatch -4 / gap open 6 /
extend 1, reference end-gaps free, haplotype_extractor.cpp:100-118), gapped
variant extraction (make_variant_of_gapped_strings,
haplotype_extractor.cpp:120-217), and splitting on >=SPLIT_VAR_THRESHOLD
matching bases (extract_sequences_from_aligned_variant, variant.cpp:1715-1826
with find_variant_sequences variant.cpp:1880 in its calls-free form).

This is the producer for the legacy VariantMap discovery store
(genotype_paths.cpp:801); the live streamlined discovery path is
typer/discovery.py.
"""

from __future__ import annotations

import numpy as np

from graphtyper_tpu_torch.constants import IS_LOW_BASE_QUAL, SPLIT_VAR_THRESHOLD
from graphtyper_tpu_torch.typer.variant_map import VariantCandidate

_MATCH = 2
_MISMATCH = -4
_GAP_OPEN = 6  # cost of the first gap base
_GAP_EXTEND = 1
_MIN_SCORE = 42  # haplotype_extractor.cpp:112


def get_gapped_strings(ref: bytes, seq: bytes) -> tuple[str, str] | None:
    """Align seq globally against ref with free reference end-gaps; return
    (gapped_ref, gapped_seq) including the free end-gap regions, or None when
    the alignment is a perfect match or scores < 42
    (haplotype_extractor.cpp:96-118)."""
    n, m = len(seq), len(ref)
    if n == 0 or m == 0:
        return None
    s = np.frombuffer(seq, dtype=np.uint8)
    r = np.frombuffer(ref, dtype=np.uint8)
    NEG = -(10**9)
    # H[i][j]: seq[:i] vs ref[:j]; ref prefix gaps free -> H[0][:] = 0
    H = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap in seq (consume ref)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # gap in ref (consume seq)
    H[0, :] = 0
    # tb codes: 0 diag, 1 up (F, consume seq), 2 left (E, consume ref)
    TB = np.zeros((n + 1, m + 1), dtype=np.uint8)
    TE = np.zeros((n + 1, m + 1), dtype=np.uint8)  # 1 if E came from E (extend)
    TF = np.zeros((n + 1, m + 1), dtype=np.uint8)
    for i in range(1, n + 1):
        F[i, :] = np.maximum(H[i - 1, :] - _GAP_OPEN, F[i - 1, :] - _GAP_EXTEND)
        TF[i, :] = (F[i - 1, :] - _GAP_EXTEND) > (H[i - 1, :] - _GAP_OPEN)
        sub = np.where(s[i - 1] == r, _MATCH, _MISMATCH)
        diag = H[i - 1, :-1] + sub
        # E needs a serial scan: E[j] = max(H[j-1]-open, E[j-1]-ext)
        h_row = np.maximum(diag, F[i, 1:])
        tb_row = np.where(F[i, 1:] > diag, 1, 0).astype(np.uint8)
        e = NEG
        for j in range(1, m + 1):
            e_open = H[i, j - 1] - _GAP_OPEN
            e_ext = e - _GAP_EXTEND
            e = max(e_open, e_ext)
            E[i, j] = e
            TE[i, j] = 1 if e_ext > e_open else 0
            h = h_row[j - 1]
            t = tb_row[j - 1]
            if e > h:
                h, t = e, 2
            H[i, j] = h
            TB[i, j] = t
        H[i, 0] = NEG if i > 0 else 0
    # free ref suffix: best over last row
    j_end = int(np.argmax(H[n, :]))
    score = int(H[n, j_end])
    if score == _MATCH * n:
        return None  # perfect match
    if score < _MIN_SCORE:
        return None
    # traceback
    g_ref: list[str] = []
    g_seq: list[str] = []
    # trailing free ref gap
    for j in range(m, j_end, -1):
        g_ref.append(chr(r[j - 1]))
        g_seq.append("-")
    i, j = n, j_end
    state = 0  # 0 = H, 1 = F chain, 2 = E chain
    while i > 0:
        if state == 0:
            t = TB[i, j]
            if t == 0:
                g_ref.append(chr(r[j - 1]))
                g_seq.append(chr(s[i - 1]))
                i -= 1
                j -= 1
                continue
            state = t
            continue
        if state == 1:  # gap in ref: consume seq
            g_ref.append("-")
            g_seq.append(chr(s[i - 1]))
            ext = TF[i, j]
            i -= 1
            state = 1 if ext else 0
            continue
        # state == 2, gap in seq: consume ref
        g_ref.append(chr(r[j - 1]))
        g_seq.append("-")
        ext = TE[i, j]
        j -= 1
        state = 2 if ext else 0
    # leading free ref gap
    for jj in range(j, 0, -1):
        g_ref.append(chr(r[jj - 1]))
        g_seq.append("-")
    return "".join(reversed(g_ref)), "".join(reversed(g_seq))


def make_variant_of_gapped_strings(
    gapped_ref: str, gapped_alt: str, pos: int
) -> tuple[int, bytes, bytes, int] | None:
    """Trim clipping/common prefix and gap suffix from gapped strings and
    return (abs_pos, ref, alt, ref_to_seq_offset) with a shared first base, or
    None when no variant remains (haplotype_extractor.cpp:120-217)."""
    ref_to_seq_offset = pos
    i, end = 0, len(gapped_ref)
    # remove clipping prefix: seq gap or mismatch
    while i < end and (gapped_alt[i] == "-" or gapped_alt[i] != gapped_ref[i]):
        if gapped_ref[i] != "-":
            pos += 1
        i += 1
    # remove common prefix
    while i < end and gapped_alt[i] == gapped_ref[i]:
        if gapped_ref[i] != "-":
            pos += 1
        i += 1
    if i >= end:
        return None
    # move one back to keep a shared base
    i -= 1
    pos -= 1
    if i < 0:
        return None
    # remove gap suffix of the seq
    while end > i + 1 and gapped_alt[end - 1] == "-":
        end -= 1
    if end <= i:
        return None
    first_base = gapped_ref[i]
    if first_base == "-":
        return None
    ref = first_base + gapped_ref[i + 1 : end].replace("-", "")
    alt = first_base + gapped_alt[i + 1 : end].replace("-", "")
    if len(ref) == 1 or ref == alt:
        return None
    return pos, ref.encode(), alt.encode(), ref_to_seq_offset


def extract_sequences_from_aligned_variant(
    abs_pos: int, gapped_seqs: list[str], threshold: int = SPLIT_VAR_THRESHOLD
) -> list[tuple[int, list[bytes]]]:
    """Split a gapped multi-sequence variant on runs of >= threshold matching
    bases; per split, dedup alt sequences and trim keeping one matching base
    (variant.cpp:1715-1826 + calls-free find_variant_sequences
    variant.cpp:1880). gapped_seqs[0] is the gapped reference; all strings are
    equal length. Returns [(abs_pos, [ref, alt...]), ...]."""
    assert len(gapped_seqs) >= 2
    reference = gapped_seqs[0]
    n_seqs = len(gapped_seqs)
    first_base = reference[0]
    out: list[tuple[int, list[bytes]]] = []

    def finish(pos0: int, parts: list[list[str]]) -> None:
        seqs = ["".join(p) for p in parts]
        # drop alts containing N; bail if ref has N or no alts remain
        ref_s = seqs[0]
        alts = [s for s in seqs[1:] if "N" not in s and s]
        if "N" in ref_s or not ref_s:
            return
        # dedup alts, drop alts equal to ref (find_variant_sequences)
        uniq: list[str] = []
        for a in alts:
            if a != ref_s and a not in uniq:
                uniq.append(a)
        if not uniq:
            return
        # trim common suffix, then common prefix (keep_one_match=False,
        # variant.cpp remove_common_prefix)
        group = [ref_s] + uniq
        while all(len(s) > 1 for s in group) and len({s[-1] for s in group}) == 1:
            group = [s[:-1] for s in group]
        pos = pos0
        while all(len(s) > 1 for s in group) and len({s[0] for s in group}) == 1:
            group = [s[1:] for s in group]
            pos += 1
        out.append((pos, [s.encode() for s in group]))

    parts: list[list[str]] = [[first_base] for _ in range(n_seqs)]
    pos0 = abs_pos
    match_length = -1
    ref_gaps = 0
    for i in range(1, len(reference)):
        if reference[i] == "-":
            ref_gaps += 1
        else:
            parts[0].append(reference[i])
        all_match = True
        for a in range(1, n_seqs):
            if gapped_seqs[a][i] != "-":
                parts[a].append(gapped_seqs[a][i])
            if gapped_seqs[a][i] != reference[i]:
                all_match = False
        if all_match:
            if match_length >= 0:
                match_length += 1
        else:
            match_length = 0
        if match_length >= threshold:
            finish(pos0, parts)
            match_length = -1
            parts = [[] for _ in range(n_seqs)]
            pos0 = abs_pos + i - ref_gaps + 1
    if parts[0]:
        finish(pos0, parts)
    return out


def find_variants_in_alignment(
    graph, pos: int, ref: bytes, seq: bytes, qual: bytes | None = None
) -> list[VariantCandidate]:
    """Extract VariantCandidates from a read aligned at contig-local position
    `pos` against reference window `ref` (haplotype_extractor.cpp:219-325).
    Flags candidates IS_LOW_BASE_QUAL when the max base quality across the alt
    span is <= 25."""
    gapped = get_gapped_strings(ref, seq)
    if gapped is None:
        return []
    gapped_ref, gapped_alt = gapped
    abs_pos0 = graph.abs_pos.get_absolute_position(graph.genomic_region.chr, pos)
    var = make_variant_of_gapped_strings(gapped_ref, gapped_alt, abs_pos0)
    if var is None:
        return []
    v_pos, v_ref, v_alt, ref_to_seq_offset = var
    # re-gap the trimmed pair for splitting: both already share structure via
    # the gapped strings; rebuild gapped forms by a trivial re-alignment of
    # equal-position characters (they came from the same gapped columns)
    new_vars = _split_trimmed(v_pos, v_ref, v_alt, gapped_ref, gapped_alt, abs_pos0)
    out: list[VariantCandidate] = []
    for n_pos, seqs in new_vars:
        # Left-normalize against the graph reference so the same event found
        # through different gap placements dedups to one candidate (the
        # reference instead asserts producers emit normalized variants and
        # drops the rest, haplotype_extractor.cpp:287-295)
        from graphtyper_tpu_torch.typer.variant import Variant

        v = Variant(abs_pos=n_pos, seqs=list(seqs))
        try:
            v.normalize(graph)
            n_pos, seqs = v.abs_pos, v.seqs
        except Exception:
            pass
        cand = VariantCandidate(abs_pos=n_pos, seqs=seqs)
        if not cand.is_normalized():
            continue
        if qual:
            r = max(0, n_pos - ref_to_seq_offset - 50)
            r_end = r + len(seqs[1])
            window = qual[r : min(r_end, len(qual))]
            if window:
                max_qual = max(window) - 33
                if max_qual <= 25:
                    cand.flags |= IS_LOW_BASE_QUAL
        ref_to_seq_offset += len(seqs[0]) - len(seqs[1])
        cand.original_pos = n_pos
        out.append(cand)
    return out


def _split_trimmed(
    v_pos: int, v_ref: bytes, v_alt: bytes, gapped_ref: str, gapped_alt: str, abs_pos0: int
) -> list[tuple[int, list[bytes]]]:
    """Locate the trimmed variant span back inside the gapped strings and run
    the threshold splitter on that span."""
    # walk gapped columns to find the column where ungapped-ref position
    # reaches v_pos
    pos = abs_pos0
    start_col = None
    for col in range(len(gapped_ref)):
        if pos == v_pos and gapped_ref[col] != "-":
            start_col = col
            break
        if gapped_ref[col] != "-":
            pos += 1
    if start_col is None:
        return [(v_pos, [v_ref, v_alt])]
    # find end column: consume len(v_ref) ungapped ref chars
    need = len(v_ref)
    end_col = start_col
    got = 0
    while end_col < len(gapped_ref) and got < need:
        if gapped_ref[end_col] != "-":
            got += 1
        end_col += 1
    # include trailing insertion columns (ref gaps) belonging to the span
    while end_col < len(gapped_ref) and gapped_ref[end_col] == "-":
        end_col += 1
    g_ref = gapped_ref[start_col:end_col]
    g_alt = gapped_alt[start_col:end_col]
    if g_ref.replace("-", "") != v_ref.decode():
        return [(v_pos, [v_ref, v_alt])]
    return extract_sequences_from_aligned_variant(v_pos, [g_ref, g_alt])
