"""Batched native variant finisher: scan_calls + generate_infos + the VCF
record columns for non-SV variants in one C++ pass (native/gt_variant.cpp).

The Python implementations in typer/variant.py + typer/vcf_out.py remain the
parity oracle — tests/typer/test_native_finisher.py fuzzes record-identical
output across both paths. Reference semantics: src/typer/variant.cpp:237-1096
(scan_calls/generate_infos), src/typer/vcf.cpp:767-1155 (write_record).
"""

from __future__ import annotations

import ctypes

import numpy as np

from graphtyper_tpu_torch.io.native import get_lib

# column order must match native/gt_variant.cpp PA_*/SC_* enums
PA_FIELDS = (
    "clipped_bp", "mapq_squared", "score_diff", "mismatches", "qd_qual", "qd_depth",
    "total_depth", "ac", "pass_ac", "n_ref_ref", "n_ref_alt", "n_alt_alt",
    "maximum_alt_support",
)
PA_N = len(PA_FIELDS) + 4  # + het0 het1 hom0 hom1 tuples
SC_N = 11
RS_N = 4

_p64 = ctypes.POINTER(ctypes.c_int64)


def _setup(lib) -> None:
    if getattr(lib, "_finish_ready", False):
        return
    lib.gt_finish_variants.restype = ctypes.c_void_p
    lib.gt_finish_variants.argtypes = (
        [ctypes.c_int64, ctypes.c_int32]
        + [ctypes.c_void_p] * 2  # A, seq arena... (A ptr, arena)
        + [ctypes.c_void_p]  # seq_off
        + [ctypes.c_void_p] * 2  # phred, phred_off
        + [ctypes.c_void_p] * 2  # cov, cov_off
        + [ctypes.c_void_p] * 3  # amb, app, filt_memo
        + [ctypes.c_void_p] * 5  # has_pa, pa_vals, pa_ratio, rs_vals, sc_vals
        + [ctypes.c_int32]
        + [_p64] * 3
    )
    lib.gt_finish_fetch.restype = ctypes.c_int32
    lib.gt_finish_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 9
    lib.gt_finish_fetch_stats.restype = ctypes.c_int32
    lib.gt_finish_fetch_stats.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.gt_finish_free.restype = None
    lib.gt_finish_free.argtypes = [ctypes.c_void_p]
    lib._finish_ready = True


def available() -> bool:
    from graphtyper_tpu_torch.config import current_options

    o = current_options()
    if getattr(o, "native_caller", "auto") == "off":
        return False
    # modes with special FILTER/GQ semantics stay on the Python path
    # (vcf.cpp:860 "." FILTER; variant.cpp:334 LR GQ bump)
    return not (o.ploidy > 2 or o.is_segment_calling or o.is_lr_calling)


def _eligible(var, n_samples: int) -> bool:
    if var.infos:
        return False
    if var.is_sv():
        return False
    A = len(var.seqs)
    if A < 1:
        return False
    if len(var.calls) != n_samples:
        return False
    P = A * (A + 1) // 2
    for c in var.calls:
        if len(c.phred) != P or len(c.coverage) != A:
            return False
    pa = var.stats.per_allele
    if len(pa) not in (0, A):
        return False
    if len(var.stats.read_strand) != len(pa):
        return False
    return True


def finish_variants(variants: list, n_samples: int, want_strings: bool = True) -> None:
    """Run the native finisher over every eligible variant in `variants`.

    Eligible variants get `_fin = (good, qual, vartype, info, filter, fmt)`
    (strings empty when want_strings=False) attached; ineligible ones are
    left untouched (callers fall back to Variant.generate_infos)."""
    lib = get_lib()
    _setup(lib)

    todo = [v for v in variants if _eligible(v, n_samples)]
    if todo:
        _fetch_strings(lib, todo, n_samples, _marshal(todo, n_samples), want_strings)


def _marshal(todo: list, S: int) -> dict:
    """Flatten the variants' calls + stats into the gt_finish_variants
    argument arrays."""
    V = len(todo)
    A = np.array([len(v.seqs) for v in todo], dtype=np.int64)
    sumA = int(A.sum())
    seq_off = np.zeros(sumA + 1, dtype=np.int64)
    np.cumsum([len(s) for v in todo for s in v.seqs], out=seq_off[1:])
    seq_arena = np.frombuffer(
        b"".join(s for v in todo for s in v.seqs), dtype=np.uint8
    ) if seq_off[-1] else np.zeros(1, dtype=np.uint8)

    P = A * (A + 1) // 2
    phred_off = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(P * S, out=phred_off[1:])
    cov_off = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(A * S, out=cov_off[1:])
    if S:
        phred = np.concatenate(
            [np.asarray(c.phred, dtype=np.int64) for v in todo for c in v.calls]
        ).astype(np.int32) if V else np.zeros(0, np.int32)
        cov = np.concatenate(
            [np.asarray(c.coverage, dtype=np.int64) for v in todo for c in v.calls]
        ).astype(np.int32) if V else np.zeros(0, np.int32)
        amb = np.array([c.ambiguous_depth for v in todo for c in v.calls], dtype=np.int32)
        app = np.array(
            [c.alt_proper_pair_depth for v in todo for c in v.calls], dtype=np.int32
        )
        filt = np.array([c.filter for v in todo for c in v.calls], dtype=np.int32)
    else:
        phred = np.zeros(0, np.int32)
        cov = np.zeros(0, np.int32)
        amb = np.zeros(0, np.int32)
        app = np.zeros(0, np.int32)
        filt = np.zeros(0, np.int32)

    has_pa = np.array([1 if v.stats.per_allele else 0 for v in todo], dtype=np.uint8)
    pa_vals = np.zeros(sumA * PA_N, dtype=np.int64)
    pa_ratio = np.zeros(sumA, dtype=np.float64)
    rs_vals = np.zeros(sumA * RS_N, dtype=np.int64)
    sc_vals = np.zeros(V * SC_N, dtype=np.int64)
    a_base = 0
    for i, v in enumerate(todo):
        st = v.stats
        if st.per_allele:
            for a, p in enumerate(st.per_allele):
                o = (a_base + a) * PA_N
                pa_vals[o + 0] = p.clipped_bp
                pa_vals[o + 1] = p.mapq_squared
                pa_vals[o + 2] = p.score_diff
                pa_vals[o + 3] = p.mismatches
                pa_vals[o + 4] = p.qd_qual
                pa_vals[o + 5] = p.qd_depth
                pa_vals[o + 6] = p.total_depth
                pa_vals[o + 7] = p.ac
                pa_vals[o + 8] = p.pass_ac
                pa_vals[o + 9] = p.n_ref_ref
                pa_vals[o + 10] = p.n_ref_alt
                pa_vals[o + 11] = p.n_alt_alt
                pa_vals[o + 12] = p.maximum_alt_support
                pa_vals[o + 13] = p.het_multi_allele_depth[0]
                pa_vals[o + 14] = p.het_multi_allele_depth[1]
                pa_vals[o + 15] = p.hom_multi_allele_depth[0]
                pa_vals[o + 16] = p.hom_multi_allele_depth[1]
                pa_ratio[a_base + a] = p.maximum_alt_support_ratio
            for a, r in enumerate(st.read_strand):
                o = (a_base + a) * RS_N
                rs_vals[o + 0] = r.r1_forward
                rs_vals[o + 1] = r.r1_reverse
                rs_vals[o + 2] = r.r2_forward
                rs_vals[o + 3] = r.r2_reverse
        o = i * SC_N
        sc_vals[o + 0] = st.clipped_reads
        sc_vals[o + 1] = st.mapq_squared
        sc_vals[o + 2] = st.n_genotyped
        sc_vals[o + 3] = st.n_calls
        sc_vals[o + 4] = st.n_passed_calls
        sc_vals[o + 5] = st.n_max_alt_proper_pairs
        sc_vals[o + 6] = st.seqdepth
        sc_vals[o + 7] = st.het_allele_depth[0]
        sc_vals[o + 8] = st.het_allele_depth[1]
        sc_vals[o + 9] = st.hom_allele_depth[0]
        sc_vals[o + 10] = st.hom_allele_depth[1]
        a_base += int(A[i])

    return dict(
        V=V, S=S, A=A, seq_arena=seq_arena, seq_off=seq_off,
        phred=phred, phred_off=phred_off, cov=cov, cov_off=cov_off,
        amb=amb, app=app, filt=filt,
        has_pa=has_pa, pa_vals=pa_vals, pa_ratio=pa_ratio, rs_vals=rs_vals,
        sc_vals=sc_vals, sumA=sumA,
    )


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _invoke(lib, m: dict, want_strings: bool):
    """Run gt_finish_variants over marshaled arrays; returns (handle, sizes)."""
    n_info = ctypes.c_int64()
    n_fmt = ctypes.c_int64()
    n_filter = ctypes.c_int64()
    handle = lib.gt_finish_variants(
        m["V"], m["S"],
        _ptr(m["A"]), _ptr(m["seq_arena"]), _ptr(m["seq_off"]),
        _ptr(m["phred"]), _ptr(m["phred_off"]),
        _ptr(m["cov"]), _ptr(m["cov_off"]),
        _ptr(m["amb"]), _ptr(m["app"]), _ptr(m["filt"]),
        _ptr(m["has_pa"]), _ptr(m["pa_vals"]), _ptr(m["pa_ratio"]), _ptr(m["rs_vals"]),
        _ptr(m["sc_vals"]),
        1 if want_strings else 0,
        ctypes.byref(n_info), ctypes.byref(n_fmt), ctypes.byref(n_filter),
    )
    return handle, n_info, n_fmt, n_filter


def _fetch_strings(lib, todo: list, S: int, m: dict, want_strings: bool) -> None:
    handle, n_info, n_fmt, n_filter = _invoke(lib, m, want_strings)
    V = m["V"]
    A = m["A"]

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    n_good = int((A - 1).sum())
    good = np.zeros(max(1, n_good), dtype=np.uint8)
    qual = np.zeros(V, dtype=np.int64)
    vartype = np.zeros(V * 2, dtype=np.uint8)
    info_arena = np.zeros(max(1, n_info.value), dtype=np.uint8)
    info_off = np.zeros(V + 1, dtype=np.int64)
    fmt_arena = np.zeros(max(1, n_fmt.value), dtype=np.uint8)
    fmt_off = np.zeros(V + 1, dtype=np.int64)
    filter_arena = np.zeros(max(1, n_filter.value), dtype=np.uint8)
    filter_off = np.zeros(V + 1, dtype=np.int64)
    try:
        lib.gt_finish_fetch(
            handle,
            ptr(good), ptr(qual), ptr(vartype),
            ptr(info_arena), ptr(info_off),
            ptr(fmt_arena), ptr(fmt_off),
            ptr(filter_arena), ptr(filter_off),
        )
    finally:
        lib.gt_finish_free(handle)

    info_b = info_arena.tobytes()
    fmt_b = fmt_arena.tobytes()
    filter_b = filter_arena.tobytes()
    vt = vartype.tobytes()
    gi = 0
    for i, v in enumerate(todo):
        na = int(A[i]) - 1
        v._fin = (
            [int(g) for g in good[gi : gi + na]],
            int(qual[i]),
            vt[i * 2 : i * 2 + 2].decode(),
            info_b[info_off[i] : info_off[i + 1]].decode(),
            filter_b[filter_off[i] : filter_off[i + 1]].decode(),
            fmt_b[fmt_off[i] : fmt_off[i + 1]].decode(),
        )
        gi += na


def scan_variants(variants: list, n_samples: int) -> list:
    """Run the scan_calls accumulation natively for every eligible variant
    (the pool-save scan, hts_parallel_reader.cpp:1022-1026) and write the
    post-scan stats + filter memos back into the Python objects. Returns the
    variants the native path did NOT handle (caller runs var.scan_calls()
    on those). Parity: tests/typer/test_native_finisher.py
    test_scan_writeback."""
    lib = get_lib()
    _setup(lib)
    todo, rest = [], []
    for v in variants:
        (todo if _eligible(v, n_samples) else rest).append(v)
    if not todo:
        return rest
    m = _marshal(todo, n_samples)
    handle, _ni, _nf, _nl = _invoke(lib, m, want_strings=False)
    sumA = m["sumA"]
    V = m["V"]
    pa_out = np.zeros(max(1, sumA * PA_N), dtype=np.int64)
    ratio_out = np.zeros(max(1, sumA), dtype=np.float64)
    sc_out = np.zeros(max(1, V * SC_N), dtype=np.int64)
    try:
        lib.gt_finish_fetch_stats(handle, _ptr(pa_out), _ptr(ratio_out), _ptr(sc_out))
    finally:
        lib.gt_finish_free(handle)

    from graphtyper_tpu_torch.models.genotype_model import VarStats

    filt = m["filt"]  # mutated in place by the native check_filter memo
    S = n_samples
    a_base = 0
    pa_l = pa_out.tolist()
    sc_l = sc_out.tolist()
    ratio_l = ratio_out.tolist()
    for i, v in enumerate(todo):
        st = v.stats
        Ai = len(v.seqs)
        if not st.per_allele:
            sized = VarStats.sized(Ai)
            st.per_allele = sized.per_allele
            st.read_strand = sized.read_strand
        for a, p in enumerate(st.per_allele):
            o = (a_base + a) * PA_N
            p.clipped_bp = pa_l[o + 0]
            p.mapq_squared = pa_l[o + 1]
            p.score_diff = pa_l[o + 2]
            p.mismatches = pa_l[o + 3]
            p.qd_qual = pa_l[o + 4]
            p.qd_depth = pa_l[o + 5]
            p.total_depth = pa_l[o + 6]
            p.ac = pa_l[o + 7]
            p.pass_ac = pa_l[o + 8]
            p.n_ref_ref = pa_l[o + 9]
            p.n_ref_alt = pa_l[o + 10]
            p.n_alt_alt = pa_l[o + 11]
            p.maximum_alt_support = pa_l[o + 12]
            p.het_multi_allele_depth = (pa_l[o + 13], pa_l[o + 14])
            p.hom_multi_allele_depth = (pa_l[o + 15], pa_l[o + 16])
            p.maximum_alt_support_ratio = ratio_l[a_base + a]
        o = i * SC_N
        st.clipped_reads = sc_l[o + 0]
        st.mapq_squared = sc_l[o + 1]
        st.n_genotyped = sc_l[o + 2]
        st.n_calls = sc_l[o + 3]
        st.n_passed_calls = sc_l[o + 4]
        st.n_max_alt_proper_pairs = sc_l[o + 5]
        st.seqdepth = sc_l[o + 6]
        st.het_allele_depth = [sc_l[o + 7], sc_l[o + 8]]
        st.hom_allele_depth = [sc_l[o + 9], sc_l[o + 10]]
        for s, c in enumerate(v.calls):
            c.filter = int(filt[i * S + s])
        a_base += Ai
    return rest
