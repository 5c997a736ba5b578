"""Multi-allele edit extraction: decompose a complex variant's alleles into
primitive events (SNPs/indels) via pairwise global alignment.

Replaces the reference's paw::Skyr MSA usage (variant.cpp:2149-2160
break_down_skyr): each alt aligns to the ref, edits are extracted and
left-normalized, equal edits across alleles merge, and overlapping-deletion
positions get '*' alleles. Host numpy implementation (decomposition runs once
per output variant, not in the hot path).
"""

from __future__ import annotations

import numpy as np


def _nw_edits_native(ref: bytes, alt: bytes):
    """C++ twin of the numpy DP below (gt_sw.cpp gt_nw_edits, same tie
    rules); returns None to fall back (size cap)."""
    from graphtyper_tpu_torch.io.native import get_lib

    lib = get_lib()
    import ctypes

    if not getattr(lib, "_nw_ready", False):
        lib.gt_nw_edits.restype = ctypes.c_int64
        lib.gt_nw_edits.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._nw_ready = True
    n, m = len(ref), len(alt)
    cap = n + m
    e_pos = np.empty(cap, dtype=np.int64)
    e_rl = np.empty(cap, dtype=np.int64)
    e_al = np.empty(cap, dtype=np.int64)
    r_out = np.empty(max(1, n), dtype=np.uint8)
    a_out = np.empty(max(1, m), dtype=np.uint8)
    k = lib.gt_nw_edits(
        ref, n, alt, m,
        e_pos.ctypes.data_as(ctypes.c_void_p), e_rl.ctypes.data_as(ctypes.c_void_p),
        e_al.ctypes.data_as(ctypes.c_void_p),
        r_out.ctypes.data_as(ctypes.c_void_p), a_out.ctypes.data_as(ctypes.c_void_p),
    )
    if k < 0:
        return None
    edits = []
    ro = ao = 0
    rb = r_out.tobytes()
    ab = a_out.tobytes()
    for i in range(k):
        rl, al = int(e_rl[i]), int(e_al[i])
        edits.append((int(e_pos[i]), rb[ro : ro + rl], ab[ao : ao + al]))
        ro += rl
        ao += al
    return edits


def _needleman_wunsch_edits(ref: bytes, alt: bytes) -> list[tuple[int, bytes, bytes]]:
    """Global alignment; returns edits as (ref_pos, ref_piece, alt_piece)
    with no anchor bases (one side may be empty for pure indels). Native
    C++ by default; the numpy DP below is the oracle
    (tests/utils/test_msa_native.py asserts equality)."""
    if len(ref) == 0 or len(alt) == 0:
        return [(0, ref, alt)] if ref != alt else []
    native = _nw_edits_native(ref, alt)
    if native is not None:
        return native
    return _needleman_wunsch_edits_numpy(ref, alt)


def _needleman_wunsch_edits_numpy(ref: bytes, alt: bytes) -> list[tuple[int, bytes, bytes]]:
    """The numpy oracle DP (same scores and traceback tie rules)."""
    n, m = len(ref), len(alt)
    if n == 0 or m == 0:
        return [(0, ref, alt)] if ref != alt else []
    MATCH, MISMATCH, GAP = 1, -1, -1
    a = np.frombuffer(ref, dtype=np.uint8)
    b = np.frombuffer(alt, dtype=np.uint8)
    score = np.zeros((n + 1, m + 1), dtype=np.int32)
    score[:, 0] = GAP * np.arange(n + 1)
    score[0, :] = GAP * np.arange(m + 1)
    for i in range(1, n + 1):
        sub = score[i - 1, :-1] + np.where(b == a[i - 1], MATCH, MISMATCH)
        up = score[i - 1, 1:] + GAP
        best = np.maximum(sub, up)
        # resolve left-gap dependency with prefix-max scan
        idx = np.arange(1, m + 1, dtype=np.int32)
        run = np.maximum.accumulate(best + idx)
        score[i, 1:] = np.maximum(run - idx, score[i, 0] - idx)
        # note: scan assumes gap = -1 per column which matches GAP
    # traceback; sticky gaps: on score ties prefer continuing the current gap
    # direction so indels stay contiguous blocks (linear gap costs make
    # 1+3 vs 4 splits equal-score otherwise)
    i, j = n, m
    ops: list[tuple[str, int, int]] = []  # (op, ref_idx, alt_idx)
    last_op = ""
    while i > 0 or j > 0:
        can_diag = i > 0 and j > 0 and score[i, j] == score[i - 1, j - 1] + (
            MATCH if a[i - 1] == b[j - 1] else MISMATCH
        )
        can_del = i > 0 and score[i, j] == score[i - 1, j] + GAP
        can_ins = j > 0 and score[i, j] == score[i, j - 1] + GAP
        if last_op == "D" and can_del:
            op = "D"
        elif last_op == "I" and can_ins:
            op = "I"
        elif can_diag:
            op = "M" if a[i - 1] == b[j - 1] else "X"
        elif can_del:
            op = "D"
        else:
            op = "I"
        if op in ("M", "X"):
            ops.append((op, i - 1, j - 1))
            i -= 1
            j -= 1
        elif op == "D":
            ops.append(("D", i - 1, j))
            i -= 1
        else:
            ops.append(("I", i, j - 1))
            j -= 1
        last_op = op if op in ("D", "I") else ""
    ops.reverse()
    # collapse runs of non-matches into edits
    edits: list[tuple[int, bytes, bytes]] = []
    cur_ref: list[int] = []
    cur_alt: list[int] = []
    cur_pos = -1
    for op, ri, ai in ops:
        if op == "M":
            if cur_pos >= 0:
                edits.append((cur_pos, bytes(cur_ref), bytes(cur_alt)))
                cur_ref, cur_alt, cur_pos = [], [], -1
            continue
        if cur_pos < 0:
            cur_pos = ri
        if op in ("X", "D"):
            cur_ref.append(a[ri])
        if op in ("X", "I"):
            cur_alt.append(b[ai])
    if cur_pos >= 0:
        edits.append((cur_pos, bytes(cur_ref), bytes(cur_alt)))
    return edits


def _left_normalize(ref: bytes, pos: int, ref_piece: bytes, alt_piece: bytes) -> tuple[int, bytes, bytes]:
    """Left-shift pure indels through repeats (VCF normalization)."""
    if ref_piece and alt_piece:
        return pos, ref_piece, alt_piece  # substitution block: stays
    piece = ref_piece or alt_piece
    while pos > 0 and piece and ref[pos - 1] == piece[-1]:
        piece = ref[pos - 1 : pos] + piece[:-1]
        pos -= 1
    if ref_piece:
        return pos, piece, b""
    return pos, b"", piece


def _edit_set_score(ref: bytes, edits: list[tuple[int, bytes, bytes]]) -> int:
    """NW score (MATCH 1, MISMATCH/GAP -1) of the alignment a disjoint edit
    set induces: positions outside edits match; an edit block (r, a) with no
    internal matches costs -max(|r|, |a|)."""
    covered = sum(len(r) for _p, r, _a in edits)
    penalty = sum(max(len(r), len(a)) for _p, r, a in edits)
    return (len(ref) - covered) - penalty


def _apply_edits(ref: bytes, edits: list[tuple[int, bytes, bytes]]) -> bytes | None:
    """ref with a pos-sorted disjoint edit set applied; None when edits
    overlap or run off the end."""
    out = bytearray()
    cur = 0
    for p, r, a in sorted(edits):
        if p < cur or p + len(r) > len(ref):
            return None
        out += ref[cur:p]
        out += a
        cur = p + len(r)
    out += ref[cur:]
    return bytes(out)


def _explain_with_union(
    ref: bytes, alt: bytes, union: list[tuple[int, bytes, bytes]], own_score: int,
    max_edits: int = 16,
) -> list[tuple[int, bytes, bytes]] | None:
    """Star-alignment convergence step (paw::Skyr find_all_edits iteration,
    variant.cpp:2149-2160 semantics): can `alt` be expressed as `ref` plus a
    disjoint subset of the ALREADY-KNOWN union edits at equal alignment
    score? When yes, that representation wins — equal-score ties then
    resolve identically across alleles, so shared physical edits merge into
    one emitted event instead of splitting on traceback context.

    Exhaustive over subsets of the (small) union set, smallest subset first;
    None when no equal-score subset reconstructs `alt` exactly."""
    cand = [e for e in union if e[0] + len(e[1]) <= len(ref)]
    if not cand or len(cand) > max_edits:
        return None
    cand.sort()
    best: list[tuple[int, bytes, bytes]] | None = None
    # depth-first over disjoint pos-sorted subsets with score pruning: every
    # edit costs at least 1 vs all-match, so partial scores bound the rest
    def rec(idx: int, chosen: list, cur_end: int) -> None:
        nonlocal best
        if best is not None and len(chosen) >= len(best):
            return
        if chosen:
            score = _edit_set_score(ref, chosen)
            if score == own_score and _apply_edits(ref, chosen) == alt:
                if best is None or len(chosen) < len(best):
                    best = list(chosen)
                return
        for k in range(idx, len(cand)):
            p, r, a = cand[k]
            if p < cur_end:
                continue
            chosen.append(cand[k])
            rec(k + 1, chosen, p + len(r))
            chosen.pop()

    rec(0, [], 0)
    return best


def extract_variants_from_alignment(seqs: list[bytes]) -> list[tuple[int, list[bytes], list[int]]]:
    """Decompose alleles into primitive variants.

    Returns a list of (pos_offset, variant_seqs, old2new) where variant_seqs
    is [ref_piece, alt_piece...] (may contain b"*" for overlapping
    deletions) and old2new maps each original allele index to its allele in
    variant_seqs.

    Tie-break semantics (paw::Skyr star alignment, variant.cpp:2149-2160):
    after the per-allele pairwise pass, alleles that can be expressed at
    EQUAL alignment score by a subset of the union edit set adopt that
    representation and the union iterates to a fixed point — cross-allele
    ties resolve consistently, so a physical edit shared by several alts is
    emitted once. Residual ambiguity (documented, exercised by
    tests/utils/test_msa_adversarial.py): distinct equal-score edit SETS
    none of which is a subset of the others' union remain at the pairwise
    tie-break's fixed precedence (sticky-gap, diag-first), which is
    deterministic and allele-order invariant."""
    ref = seqs[0]
    n = len(seqs)
    per_allele: list[list[tuple[int, bytes, bytes]]] = [[]]
    own_scores: list[int] = [0]
    for i in range(1, n):
        if seqs[i] == ref:
            per_allele.append([])
            own_scores.append(0)
            continue
        edits = _needleman_wunsch_edits(ref, seqs[i])
        edits = [_left_normalize(ref, p, r, a) for p, r, a in edits]
        per_allele.append(edits)
        own_scores.append(_edit_set_score(ref, edits))

    # star-alignment convergence: iterate until the union edit set is stable
    for _round in range(4):
        changed = False
        for i in range(1, n):
            if not per_allele[i]:
                continue
            others = sorted({e for j, ed in enumerate(per_allele) if j != i for e in ed})
            if not others:
                continue
            # already consistent? every edit shared or allele has no
            # equal-score union representation
            if all(e in others for e in per_allele[i]):
                continue
            alt_candidates = sorted(set(others) | set(per_allele[i]))
            better = _explain_with_union(ref, seqs[i], others, own_scores[i])
            if better is None and alt_candidates != others:
                better = _explain_with_union(ref, seqs[i], alt_candidates, own_scores[i])
                # only adopt when it strictly increases sharing
                if better is not None and not any(e in others for e in better):
                    better = None
            if better is not None and better != per_allele[i]:
                per_allele[i] = better
                changed = True
        if not changed:
            break

    # deletion spans per allele (for '*' placement)
    del_spans: list[list[tuple[int, int]]] = [[]]
    for i in range(1, n):
        spans = []
        for p, r, a in per_allele[i]:
            if len(r) > len(a):
                spans.append((p, p + len(r)))
        del_spans.append(spans)

    # group edits by (pos, ref_len)
    groups: dict[tuple[int, int], dict[bytes, list[int]]] = {}
    for i in range(1, n):
        for p, r, a in per_allele[i]:
            groups.setdefault((p, len(r)), {}).setdefault(a, []).append(i)

    out: list[tuple[int, list[bytes], list[int]]] = []
    for (pos, ref_len) in sorted(groups):
        alts = groups[(pos, ref_len)]
        var_seqs: list[bytes] = [ref[pos : pos + ref_len]]
        old2new = [0] * n
        for alt_piece, alleles in sorted(alts.items()):
            var_seqs.append(alt_piece)
            for al in alleles:
                old2new[al] = len(var_seqs) - 1
        # alleles whose deletions overlap this position (but have no edit
        # here) get a '*' allele
        star_idx = -1
        for i in range(1, n):
            if old2new[i] != 0:
                continue
            for s, e in del_spans[i]:
                if s <= pos < e and not (s == pos and e == pos + ref_len):
                    if star_idx < 0:
                        var_seqs.append(b"*")
                        star_idx = len(var_seqs) - 1
                    old2new[i] = star_idx
                    break
        out.append((pos, var_seqs, old2new))
    return out
