"""ctypes wrapper for the native discovery first pass (gt_first_pass):
the per-sample CIGAR pileup, SNP/indel support gates, and phase analysis
run in C++ on BAM bytes; the surviving events are rebuilt as the Python
Event/EventSupport structures the rest of discovery consumes.

Port of graphtyper_tpu/typer/native_discovery.py: the wrappers of the C++
engine are copied; the two callers of aggregate_rows (:590
run_first_pass_rows, :607 aggregate_cohort) run the first-pass
aggregation through the port's device pileup.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graphtyper_tpu_torch.io.native import get_lib
from graphtyper_tpu_torch.ops.discovery_pileup import aggregate_rows

_p64 = ctypes.POINTER(ctypes.c_int64)


def _setup(lib) -> None:
    if getattr(lib, "_fp_ready", False):
        return
    lib.gt_first_pass.restype = ctypes.c_void_p
    lib.gt_first_pass.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        + [_p64] * 6
    )
    lib.gt_first_pass_fetch.restype = ctypes.c_int32
    lib.gt_first_pass_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 17
    lib.gt_first_pass_free.restype = None
    lib.gt_first_pass_free.argtypes = [ctypes.c_void_p]
    lib._fp_ready = True


def run_first_pass_native(bam_bytes: bytes, target_ref: int, region_begin: int, reference: bytes, opts):
    """Returns (buckets, sample_haplotypes) like discovery.run_first_pass, or
    None to fall back."""
    lib = get_lib()
    _setup(lib)
    from graphtyper_tpu_torch.typer.discovery import BUCKET_SIZE, BucketFirstPass, HaplotypeInfo
    from graphtyper_tpu_torch.typer.events import Event, EventSupport

    opt_ints = np.array(
        [
            1 if getattr(opts, "filter_on_proper_pairs", True) else 0,
            1 if getattr(opts, "no_filter_on_begin_pos", False) else 0,
            1 if getattr(opts, "filter_on_read_bias", True) else 0,
            1 if getattr(opts, "filter_on_strand_bias", True) else 0,
        ],
        dtype=np.int64,
    )
    data = np.frombuffer(bam_bytes, dtype=np.uint8)
    ref = np.frombuffer(reference, dtype=np.uint8)
    n_events = ctypes.c_int64()
    n_seq = ctypes.c_int64()
    n_ever = ctypes.c_int64()
    n_always = ctypes.c_int64()
    n_phase = ctypes.c_int64()
    n_buckets = ctypes.c_int64()

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    handle = lib.gt_first_pass(
        ptr(data), len(bam_bytes), target_ref, region_begin,
        ptr(ref), len(reference), ptr(opt_ints),
        ctypes.byref(n_events), ctypes.byref(n_seq), ctypes.byref(n_ever),
        ctypes.byref(n_always), ctypes.byref(n_phase), ctypes.byref(n_buckets),
    )
    try:
        N = n_events.value
        pos = np.zeros(N, dtype=np.int64)
        typ = np.zeros(N, dtype=np.uint8)
        seq = np.zeros(n_seq.value, dtype=np.uint8)
        seq_off = np.zeros(N + 1, dtype=np.int64)
        counts = np.zeros(N * 11, dtype=np.int64)
        span = np.zeros(N, dtype=np.int64)
        maxlq = np.zeros(N, dtype=np.int64)
        in_bucket = np.zeros(N, dtype=np.uint8)
        has_good = np.zeros(N, dtype=np.uint8)
        has_realn = np.zeros(N, dtype=np.uint8)
        ever = np.zeros(n_ever.value, dtype=np.int64)
        ever_off = np.zeros(N + 1, dtype=np.int64)
        always = np.zeros(n_always.value, dtype=np.int64)
        always_off = np.zeros(N + 1, dtype=np.int64)
        phase_idx = np.zeros(n_phase.value, dtype=np.int64)
        phase_cnt = np.zeros(n_phase.value, dtype=np.int64)
        phase_off = np.zeros(N + 1, dtype=np.int64)
        rc = lib.gt_first_pass_fetch(
            handle,
            ptr(pos), ptr(typ), ptr(seq), ptr(seq_off),
            ptr(counts), ptr(span), ptr(maxlq),
            ptr(in_bucket), ptr(has_good), ptr(has_realn),
            ptr(ever), ptr(ever_off), ptr(always), ptr(always_off),
            ptr(phase_idx), ptr(phase_cnt), ptr(phase_off),
        )
        if rc != 0:
            return None
    finally:
        lib.gt_first_pass_free(handle)

    type_chars = ("I", "D", "X")
    seq_b = seq.tobytes()
    events: list[Event] = []
    infos: list[EventSupport] = []
    c = counts.reshape(N, 11)
    for i in range(N):
        ev = Event(int(pos[i]), type_chars[typ[i]], seq_b[seq_off[i] : seq_off[i + 1]])
        info = EventSupport(
            hq_count=int(c[i, 0]),
            lq_count=int(c[i, 1]),
            proper_pairs=int(c[i, 2]),
            first_in_pairs=int(c[i, 3]),
            sequence_reversed=int(c[i, 4]),
            clipped=int(c[i, 5]),
            max_mapq=int(c[i, 6]),
            max_distance=int(c[i, 7]),
            uniq_pos1=int(c[i, 8]),
            uniq_pos2=int(c[i, 9]),
            uniq_pos3=int(c[i, 10]),
            span=int(span[i]),
            max_log_qual=int(maxlq[i]),
            has_indel_good_support=bool(has_good[i]),
            has_realignment_support=bool(has_realn[i]),
        )
        events.append(ev)
        infos.append(info)
    for i in range(N):
        ph = {}
        for k in range(int(phase_off[i]), int(phase_off[i + 1])):
            ph[events[int(phase_idx[k])]] = int(phase_cnt[k])
        infos[i].phase = ph

    buckets = [BucketFirstPass() for _ in range(int(n_buckets.value))]
    sample_haps: dict = {}
    for i in range(N):
        hap = HaplotypeInfo()
        hap.ever_together = {events[int(ever[k])] for k in range(int(ever_off[i]), int(ever_off[i + 1]))}
        hap.always_together = {
            events[int(always[k])] for k in range(int(always_off[i]), int(always_off[i + 1]))
        }
        sample_haps[events[i]] = hap
        if in_bucket[i]:
            b = (events[i].pos - region_begin) // BUCKET_SIZE
            if 0 <= b < len(buckets):
                buckets[b].events[events[i]] = infos[i]
    return buckets, sample_haps


def _setup_sp(lib) -> None:
    if getattr(lib, "_sp_ready", False):
        return
    lib.gt_second_pass.restype = ctypes.c_void_p
    lib.gt_second_pass.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
        + [_p64] * 6
    )
    lib.gt_second_pass_fetch.restype = ctypes.c_int32
    lib.gt_second_pass_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 16
    lib.gt_second_pass_free.restype = None
    lib.gt_second_pass_free.argtypes = [ctypes.c_void_p]
    lib._sp_ready = True


def read_reads_into_buckets_native(
    bam_bytes: bytes, target_ref: int, events_map: dict, num_buckets: int,
    region_begin: int, reference: bytes, realign_events=None,
):
    """Native twin of discovery.read_reads_into_buckets straight from BAM
    bytes: C++ parses + scores every read's CIGAR against the reference and
    emits flat arrays; Python replays the sparse event registrations into
    the shared EventSupport state and builds the Bucket2/Read2 structures
    that realign_to_indels consumes. Returns (buckets, max_read_size) or
    None to fall back (reference semantics: caller.cpp:2232-2510).

    `realign_events` (the indels this file will realign to, discovery.py's
    indel_to_realign list): when given, Read2 objects materialize only for
    buckets realign_to_indels can actually scan — its candidate window per
    indel plus the 60bp nearby-event margin — and for bookkeeping the
    per-bucket max_pos_end/global_max_pos_end derive from the flat arrays.
    Event support replay is array-driven either way, so the shared
    EventSupport state is identical; buckets outside every window keep
    empty read lists that realign_to_indels never touches."""
    lib = get_lib()
    _setup_sp(lib)
    from graphtyper_tpu_torch.typer.discovery import (
        BUCKET_SIZE,
        Alignment2,
        Bucket2,
        Read2,
        ReadIndelEvent,
        _add_indel_support,
        _bucket_for_event,
    )
    from graphtyper_tpu_torch.typer.events import Event, EventSupport, compute_indel_span

    # existing event table (insertion order is irrelevant: lookups by key)
    ev_list = [e for e in events_map.keys() if e.type in ("I", "D")]
    ev_pos = np.array([e.pos for e in ev_list], dtype=np.int64)
    ev_type = np.array([0 if e.type == "I" else 1 for e in ev_list], dtype=np.uint8)
    seqs = [e.sequence for e in ev_list]
    ev_seq_off = np.zeros(len(ev_list) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=ev_seq_off[1:])
    ev_seq = np.frombuffer(b"".join(seqs), dtype=np.uint8) if ev_list else np.zeros(0, np.uint8)
    ev_realign = np.array(
        [1 if events_map[e].has_realignment_support else 0 for e in ev_list], dtype=np.uint8
    )

    data = np.frombuffer(bam_bytes, dtype=np.uint8)
    ref_arr = np.frombuffer(reference, dtype=np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    n_reads = ctypes.c_int64()
    seq_bytes = ctypes.c_int64()
    n_regs = ctypes.c_int64()
    n_new = ctypes.c_int64()
    new_seq_bytes = ctypes.c_int64()
    max_read_size = ctypes.c_int64()
    handle = lib.gt_second_pass(
        ptr(data), len(data), target_ref, region_begin, ptr(ref_arr), len(ref_arr),
        ptr(ev_pos), ptr(ev_type), ptr(ev_seq), ptr(ev_seq_off), len(ev_list), ptr(ev_realign),
        ctypes.byref(n_reads), ctypes.byref(seq_bytes), ctypes.byref(n_regs),
        ctypes.byref(n_new), ctypes.byref(new_seq_bytes), ctypes.byref(max_read_size),
    )
    try:
        N = n_reads.value
        r_pos = np.zeros(N, np.int64)
        r_pos_end = np.zeros(N, np.int64)
        r_score = np.zeros(N, np.int32)
        r_clip_b = np.zeros(N, np.int32)
        r_clip_e = np.zeros(N, np.int32)
        r_flags = np.zeros(N, np.int32)
        r_mapq = np.zeros(N, np.int32)
        r_seq = np.zeros(seq_bytes.value, np.uint8)
        r_seq_off = np.zeros(N + 1, np.int64)
        reg_read = np.zeros(n_regs.value, np.int64)
        reg_ev = np.zeros(n_regs.value, np.int64)
        reg_off = np.zeros(n_regs.value, np.int64)
        nev_pos = np.zeros(n_new.value, np.int64)
        nev_type = np.zeros(n_new.value, np.uint8)
        nev_seq = np.zeros(new_seq_bytes.value, np.uint8)
        nev_seq_off = np.zeros(n_new.value + 1, np.int64)
        rc = lib.gt_second_pass_fetch(
            handle,
            ptr(r_pos), ptr(r_pos_end), ptr(r_score), ptr(r_clip_b), ptr(r_clip_e),
            ptr(r_flags), ptr(r_mapq), ptr(r_seq), ptr(r_seq_off),
            ptr(reg_read), ptr(reg_ev), ptr(reg_off),
            ptr(nev_pos), ptr(nev_type), ptr(nev_seq), ptr(nev_seq_off),
        )
        if rc != 0:
            return None
    finally:
        lib.gt_second_pass_free(handle)

    # event id -> Event object (existing + new)
    all_events = list(ev_list)
    for i in range(n_new.value):
        seq = nev_seq[nev_seq_off[i] : nev_seq_off[i + 1]].tobytes()
        all_events.append(Event(int(nev_pos[i]), "I" if nev_type[i] == 0 else "D", seq))

    # per-bucket bookkeeping from the flat arrays (reads arrive
    # coordinate-sorted, so bucket indices are nondecreasing and each
    # bucket's final max/global values equal the order-faithful walk's)
    pos_l = r_pos.tolist()
    pos_end_l = r_pos_end.tolist()
    ce_l = r_clip_e.tolist()
    fl_l = r_flags.tolist()
    mq_l = r_mapq.tolist()
    b_idx = (r_pos - region_begin) // BUCKET_SIZE
    ewc = r_pos_end + r_clip_e
    nb = max(num_buckets, int(b_idx.max()) + 1 if N else 0)
    bmax = np.full(nb, -1, dtype=np.int64)
    if N:
        np.maximum.at(bmax, b_idx, ewc)
    gmax_run = np.maximum.accumulate(np.maximum(bmax, 0)) if nb else bmax
    buckets = [Bucket2() for _ in range(nb)]
    has_reads = np.zeros(nb, dtype=bool)
    if N:
        has_reads[b_idx] = True
    for b in range(nb):
        if has_reads[b]:
            buckets[b].max_pos_end = int(bmax[b])
            buckets[b].global_max_pos_end = int(gmax_run[b])

    # which buckets can realign_to_indels scan? (discovery.py
    # realign_to_indels: walk left while global_max_pos_end > pos - PAD,
    # right bound end_padded // BUCKET_SIZE; widened by the 60bp
    # nearby-event margin)
    if realign_events is None:
        need = np.ones(nb, dtype=bool)
    else:
        need = np.zeros(nb, dtype=bool)
        PAD = 50
        NEARBY_BP = 60
        mrs = int(max_read_size.value)
        for ev in realign_events:
            begin_padded = max(0, ev.pos - NEARBY_BP - mrs - 2 * PAD - region_begin)
            end_padded = ev.pos + NEARBY_BP + mrs + 2 * PAD - region_begin
            b = begin_padded // BUCKET_SIZE
            while b > 0 and b < nb and buckets[b].global_max_pos_end > (ev.pos - NEARBY_BP - PAD):
                b -= 1
            b_end = min(nb - 1, end_padded // BUCKET_SIZE)
            if b < nb:
                need[b : b_end + 1] = True

    # Read2 objects only where needed; event support replays from arrays
    seq_all = r_seq.tobytes()
    seq_off_l = r_seq_off.tolist()
    score_l = r_score.tolist()
    cb_l = r_clip_b.tolist()
    reads: dict[int, Read2] = {}
    if N:
        for i in np.nonzero(need[b_idx])[0].tolist():
            a = Alignment2(
                pos=pos_l[i], pos_end=pos_end_l[i], score=score_l[i],
                num_clipped_begin=cb_l[i], num_clipped_end=ce_l[i],
            )
            reads[i] = Read2(
                flags=fl_l[i], mapq=mq_l[i],
                sequence=seq_all[seq_off_l[i] : seq_off_l[i + 1]], alignment=a,
            )

    # replay registrations: event creation/support + per-read indel lists
    for i in range(n_regs.value):
        ev = all_events[int(reg_ev[i])]
        info = events_map.get(ev)
        if info is None:
            info = EventSupport()
            info.span = compute_indel_span(ev, reference, ev.pos - region_begin)
            events_map[ev] = info
        _bucket_for_event(buckets, ev, region_begin).events[ev] = info
        ri = int(reg_read[i])
        _add_indel_support(info, int(reg_off[i]), fl_l[ri], mq_l[ri])
        read = reads.get(ri)
        if read is not None:
            read.alignment.indel_events.append(ReadIndelEvent(int(reg_off[i]), ev))

    # bucket read lists (order preserved; only scannable buckets filled)
    for i, r in reads.items():
        buckets[int(b_idx[i])].reads.append(r)

    return buckets, int(max_read_size.value)


def _setup_fx(lib) -> None:
    if getattr(lib, "_fx_ready", False):
        return
    # the gates result rides the gt_first_pass_fetch/free ABI — their ctypes
    # signatures must exist even when run_first_pass_native never ran (a bare
    # Python int handle would otherwise truncate to 32 bits)
    _setup(lib)
    lib.gt_fp_extract.restype = ctypes.c_void_p
    lib.gt_fp_extract.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_int64]
        + [_p64] * 5
    )
    lib.gt_fp_extract_fetch.restype = ctypes.c_int32
    lib.gt_fp_extract_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 16
    lib.gt_fp_extract_free.restype = None
    lib.gt_fp_extract_free.argtypes = [ctypes.c_void_p]
    lib.gt_fp_gates.restype = ctypes.c_void_p
    lib.gt_fp_gates.argtypes = (
        [ctypes.c_int64] + [ctypes.c_void_p] * 5
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        + [_p64] * 6
    )
    lib._fx_ready = True


def fp_extract(bam_bytes: bytes, target_ref: int, region_begin: int, reference: bytes):
    """Run the native extraction walk; returns a dict of flat arrays or None."""
    lib = get_lib()
    _setup_fx(lib)
    data = np.frombuffer(bam_bytes, dtype=np.uint8)
    ref = np.frombuffer(reference, dtype=np.uint8)
    n_events = ctypes.c_int64()
    n_seq = ctypes.c_int64()
    n_rows = ctypes.c_int64()
    n_pairs = ctypes.c_int64()
    n_bucket_reads = ctypes.c_int64()

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    handle = lib.gt_fp_extract(
        ptr(data), len(bam_bytes), target_ref, region_begin, ptr(ref), len(reference),
        ctypes.byref(n_events), ctypes.byref(n_seq), ctypes.byref(n_rows),
        ctypes.byref(n_pairs), ctypes.byref(n_bucket_reads),
    )
    if not handle:
        return None
    try:
        N, R, P = n_events.value, n_rows.value, n_pairs.value
        out = dict(
            ev_pos=np.zeros(N, np.int64), ev_type=np.zeros(N, np.uint8),
            ev_seq=np.zeros(n_seq.value, np.uint8), ev_seq_off=np.zeros(N + 1, np.int64),
            ev_span=np.zeros(N, np.int64),
            r_ev=np.zeros(R, np.int32), r_dhq=np.zeros(R, np.int8),
            r_dlq=np.zeros(R, np.int8), r_bits=np.zeros(R, np.uint8),
            r_mapq=np.zeros(R, np.uint8), r_dist=np.zeros(R, np.int32),
            r_readpos=np.zeros(R, np.int64),
            p_a=np.zeros(P, np.int32), p_b=np.zeros(P, np.int32),
            cov_up=np.zeros(len(reference), np.int64),
            cov_down=np.zeros(len(reference), np.int64),
        )
        rc = lib.gt_fp_extract_fetch(
            handle,
            ptr(out["ev_pos"]), ptr(out["ev_type"]), ptr(out["ev_seq"]),
            ptr(out["ev_seq_off"]), ptr(out["ev_span"]),
            ptr(out["r_ev"]), ptr(out["r_dhq"]), ptr(out["r_dlq"]), ptr(out["r_bits"]),
            ptr(out["r_mapq"]), ptr(out["r_dist"]), ptr(out["r_readpos"]),
            ptr(out["p_a"]), ptr(out["p_b"]),
            ptr(out["cov_up"]), ptr(out["cov_down"]),
        )
        if rc != 0:
            return None
    finally:
        lib.gt_fp_extract_free(handle)
    out["n_bucket_reads"] = int(n_bucket_reads.value)
    return out


def fp_gates(extract: dict, counters: np.ndarray, region_begin: int, reference: bytes, opts):
    """Run the native gates + phase analysis over aggregated counters;
    returns (buckets, sample_haplotypes) like run_first_pass_native."""
    lib = get_lib()
    _setup_fx(lib)
    from graphtyper_tpu_torch.ops.discovery_pileup import count_pairs

    N = len(extract["ev_pos"])
    pa, pb, pc = count_pairs(extract["p_a"], extract["p_b"], max(N, 1))
    opt_ints = np.array(
        [
            1 if getattr(opts, "filter_on_proper_pairs", True) else 0,
            1 if getattr(opts, "no_filter_on_begin_pos", False) else 0,
            1 if getattr(opts, "filter_on_read_bias", True) else 0,
            1 if getattr(opts, "filter_on_strand_bias", True) else 0,
        ],
        dtype=np.int64,
    )

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    counters = np.ascontiguousarray(counters, dtype=np.int64)
    n_events = ctypes.c_int64()
    n_seq = ctypes.c_int64()
    n_ever = ctypes.c_int64()
    n_always = ctypes.c_int64()
    n_phase = ctypes.c_int64()
    n_buckets = ctypes.c_int64()
    handle = lib.gt_fp_gates(
        N, ptr(extract["ev_pos"]), ptr(extract["ev_type"]), ptr(extract["ev_seq"]),
        ptr(extract["ev_seq_off"]), ptr(extract["ev_span"]),
        ptr(counters), ptr(pa), ptr(pb), ptr(pc), len(pa),
        ptr(extract["cov_up"]), ptr(extract["cov_down"]),
        extract["n_bucket_reads"], region_begin, len(reference), ptr(opt_ints),
        ctypes.byref(n_events), ctypes.byref(n_seq), ctypes.byref(n_ever),
        ctypes.byref(n_always), ctypes.byref(n_phase), ctypes.byref(n_buckets),
    )
    if not handle:
        return None
    return _fetch_fp_result(
        lib, handle, n_events, n_seq, n_ever, n_always, n_phase, n_buckets, region_begin
    )


def _fetch_fp_result(lib, handle, n_events, n_seq, n_ever, n_always, n_phase, n_buckets,
                     region_begin: int):
    """Shared FpResult unmarshalling (gt_first_pass_fetch ABI) -> the Python
    (buckets, sample_haplotypes) structures."""
    from graphtyper_tpu_torch.typer.discovery import BUCKET_SIZE, BucketFirstPass, HaplotypeInfo
    from graphtyper_tpu_torch.typer.events import Event, EventSupport

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    try:
        N = n_events.value
        pos = np.zeros(N, dtype=np.int64)
        typ = np.zeros(N, dtype=np.uint8)
        seq = np.zeros(n_seq.value, dtype=np.uint8)
        seq_off = np.zeros(N + 1, dtype=np.int64)
        counts = np.zeros(N * 11, dtype=np.int64)
        span = np.zeros(N, dtype=np.int64)
        maxlq = np.zeros(N, dtype=np.int64)
        in_bucket = np.zeros(N, dtype=np.uint8)
        has_good = np.zeros(N, dtype=np.uint8)
        has_realn = np.zeros(N, dtype=np.uint8)
        ever = np.zeros(n_ever.value, dtype=np.int64)
        ever_off = np.zeros(N + 1, dtype=np.int64)
        always = np.zeros(n_always.value, dtype=np.int64)
        always_off = np.zeros(N + 1, dtype=np.int64)
        phase_idx = np.zeros(n_phase.value, dtype=np.int64)
        phase_cnt = np.zeros(n_phase.value, dtype=np.int64)
        phase_off = np.zeros(N + 1, dtype=np.int64)
        rc = lib.gt_first_pass_fetch(
            handle,
            ptr(pos), ptr(typ), ptr(seq), ptr(seq_off),
            ptr(counts), ptr(span), ptr(maxlq),
            ptr(in_bucket), ptr(has_good), ptr(has_realn),
            ptr(ever), ptr(ever_off), ptr(always), ptr(always_off),
            ptr(phase_idx), ptr(phase_cnt), ptr(phase_off),
        )
        if rc != 0:
            return None
    finally:
        lib.gt_first_pass_free(handle)

    type_chars = ("I", "D", "X")
    seq_b = seq.tobytes()
    events = []
    infos = []
    c = counts.reshape(N, 11)
    for i in range(N):
        ev = Event(int(pos[i]), type_chars[typ[i]], seq_b[seq_off[i] : seq_off[i + 1]])
        info = EventSupport(
            hq_count=int(c[i, 0]),
            lq_count=int(c[i, 1]),
            proper_pairs=int(c[i, 2]),
            first_in_pairs=int(c[i, 3]),
            sequence_reversed=int(c[i, 4]),
            clipped=int(c[i, 5]),
            max_mapq=int(c[i, 6]),
            max_distance=int(c[i, 7]),
            uniq_pos1=int(c[i, 8]),
            uniq_pos2=int(c[i, 9]),
            uniq_pos3=int(c[i, 10]),
            span=int(span[i]),
            max_log_qual=int(maxlq[i]),
            has_indel_good_support=bool(has_good[i]),
            has_realignment_support=bool(has_realn[i]),
        )
        events.append(ev)
        infos.append(info)
    for i in range(N):
        ph = {}
        for k in range(int(phase_off[i]), int(phase_off[i + 1])):
            ph[events[int(phase_idx[k])]] = int(phase_cnt[k])
        infos[i].phase = ph

    buckets = [BucketFirstPass() for _ in range(int(n_buckets.value))]
    sample_haps = {}
    for i in range(N):
        hap = HaplotypeInfo()
        hap.ever_together = {events[int(ever[k])] for k in range(int(ever_off[i]), int(ever_off[i + 1]))}
        hap.always_together = {
            events[int(always[k])] for k in range(int(always_off[i]), int(always_off[i + 1]))
        }
        sample_haps[events[i]] = hap
        if in_bucket[i]:
            b = (events[i].pos - region_begin) // BUCKET_SIZE
            if 0 <= b < len(buckets):
                buckets[b].events[events[i]] = infos[i]
    return buckets, sample_haps


def run_first_pass_rows(bam_bytes: bytes, target_ref: int, region_begin: int,
                        reference: bytes, opts, device: torch.device | str):
    """Single-file extract -> device aggregate -> gates; (buckets,
    sample_haplotypes) like run_first_pass_native, or None. Fork of
    graphtyper_tpu/typer/native_discovery.py:590."""
    x = fp_extract(bam_bytes, target_ref, region_begin, reference)
    if x is None:
        return None
    counters = aggregate_rows(
        x["r_ev"], x["r_dhq"], x["r_dlq"], x["r_bits"], x["r_mapq"],
        x["r_dist"], x["r_readpos"], len(x["ev_pos"]), device,
    )
    return fp_gates(x, counters, region_begin, reference, opts)


def aggregate_cohort(extracts: list, device: torch.device | str) -> list:
    """Every file's rows in ONE aggregation call (event ids offset per
    file); returns the per-file counter matrices. Fork of
    graphtyper_tpu/typer/native_discovery.py:607."""
    sizes = [len(x["ev_pos"]) for x in extracts]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    total = int(offsets[-1])
    if total == 0:
        return [np.zeros((0, 11), dtype=np.int64) for _ in extracts]
    r_ev = np.concatenate(
        [x["r_ev"].astype(np.int64) + offsets[i] for i, x in enumerate(extracts)]
    )

    def cat(k):
        return np.concatenate([x[k] for x in extracts])

    counters = aggregate_rows(
        r_ev, cat("r_dhq"), cat("r_dlq"), cat("r_bits"), cat("r_mapq"),
        cat("r_dist"), cat("r_readpos"), total, device,
    )
    return [counters[offsets[i] : offsets[i + 1]] for i in range(len(extracts))]
