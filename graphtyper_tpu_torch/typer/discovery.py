"""Reference-based variant discovery (iteration 1 of `genotype`).

Reference semantics: src/typer/caller.cpp — run_first_pass (:488-1365,
50bp-bucket CIGAR pileups with SNP has_good_support and indel
realignment-support gates, phase counts), merge_haplotypes2 (:64-165),
read_hts_and_return_realignment_indels (:2232-2510), realign_to_indels
(:1855-2230, SW realignment with anti/multi support), streamlined_discovery
(:2753-3095, the driver + VCF emission with GT_ID/GT_HAPLOTYPE/
GT_ANTI_HAPLOTYPE).

Port of graphtyper_tpu/typer/discovery.py. The first pass, the bucket
structures and the read replay are the JAX module's host code, copied. Two
functions that call the device layer are forks: `realign_to_indels` (:655)
runs its SW batches through the port's `align_batch`, and
`streamlined_discovery` (:788) runs the first-pass aggregation through the
port's pileup and calls the forked realignment; its multi-host `dist`
argument takes the port's parallel/distributed.py DiscoveryDist.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from graphtyper_tpu_torch.constants import (
    IS_CLIPPED,
    IS_FIRST_IN_PAIR,
    IS_PROPER_PAIR,
    IS_REVERSED,
    SCORE_CLIP,
    SCORE_GAP_EXTEND,
    SCORE_GAP_OPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
)
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.io.bam import AlignedRead, read_alignments_cached
from graphtyper_tpu_torch.typer.events import (
    READ_ANTI_SUPPORT,
    READ_MULTI_SUPPORT,
    Event,
    EventSupport,
    apply_indel_event,
    compute_indel_span,
    get_log_qual_double,
)
from graphtyper_tpu_torch.typer.variant import Variant
from graphtyper_tpu_torch.typer.vcf_out import VcfOutput

BUCKET_SIZE = 50


ACGT = frozenset(b"ACGT")


@dataclass
class HaplotypeInfo:
    ever_together: set = field(default_factory=set)
    always_together: set = field(default_factory=set)


@dataclass(slots=True)
class BucketFirstPass:
    global_max_pos_end: int = -1
    max_pos_end: int = -1
    events: dict = field(default_factory=dict)  # Event -> EventSupport


@dataclass(slots=True)
class ReadIndelEvent:
    read_pos: int
    event: Event


@dataclass(slots=True)
class Alignment2:
    pos: int = -1
    pos_end: int = -1
    score: int = -(2**31)
    num_clipped_begin: int = 0
    num_clipped_end: int = 0
    num_ins_begin: int = 0
    indel_events: list = field(default_factory=list)

    def has_indel_event(self, event: Event) -> bool:
        for e in self.indel_events:
            if e.event == event:
                return e.read_pos != READ_ANTI_SUPPORT
        return False


@dataclass(slots=True)
class Read2:
    name: str = ""
    mate_pos: int = -1
    flags: int = 0
    mapq: int = 255
    sequence: bytes = b""
    qual: np.ndarray = None
    alignment: Alignment2 = field(default_factory=Alignment2)


@dataclass(slots=True)
class Bucket2:
    global_max_pos_end: int = -1
    max_pos_end: int = -1
    events: dict = field(default_factory=dict)  # Event -> EventSupport (shared refs)
    reads: list = field(default_factory=list)


def _sorted_events(d: dict) -> list:
    return sorted(d.keys(), key=lambda e: e.sort_key())


def _is_clipped(cigar, min_count: int = 1) -> bool:
    if not cigar:
        return False
    if cigar[0][0] == 4 and cigar[0][1] >= min_count:
        return True
    if cigar[-1][0] == 4 and cigar[-1][1] >= min_count:
        return True
    return False


def _add_event_to_bucket(buckets: list, event: Event, region_begin: int, reference: bytes, ref_offset: int, is_indel: bool):
    idx = (event.pos - region_begin) // BUCKET_SIZE
    while idx >= len(buckets):
        buckets.append(BucketFirstPass())
    b = buckets[idx]
    info = b.events.get(event)
    if info is None:
        info = EventSupport()
        if is_indel:
            info.span = compute_indel_span(event, reference, ref_offset)
        b.events[event] = info
    return info


def run_first_pass(
    reads: list[AlignedRead],
    region_begin: int,
    reference: bytes,
    opts=None,
) -> tuple[list[BucketFirstPass], dict]:
    """caller.cpp:488-1365 for one sample. Returns (buckets, sample_haplotypes)."""
    REF_SIZE = len(reference)
    buckets: list[BucketFirstPass] = []
    cov_up = np.zeros(REF_SIZE, dtype=np.int64)
    cov_down = np.zeros(REF_SIZE, dtype=np.int64)
    sample_haplotypes: dict = {}
    global_max_pos_end = 0
    HIGH_EVENT_COUNT = 12
    VHIGH_EVENT_COUNT = 18

    # vectorized per-base mismatch scan support: validity masks computed once
    ref_arr = np.frombuffer(reference, dtype=np.uint8)
    is_acgt = np.zeros(256, dtype=bool)
    for _c in b"ACGT":
        is_acgt[_c] = True
    ref_ok = is_acgt[ref_arr]

    # bulk prepass: mismatch offsets of all pure-M reads found in one matrix
    # compare per read length (the dominant case); other cigars fall back to
    # the per-op compare below
    bulk_hits: dict[int, np.ndarray] = {}
    by_len: dict[int, list[int]] = {}
    for ri, read in enumerate(reads):
        if (
            len(read.cigar) == 1
            and read.cigar[0][0] in (0, 7, 8)
            and read.pos >= region_begin
            and read.pos - region_begin + len(read.seq) <= REF_SIZE
            and read.cigar[0][1] == len(read.seq)
        ):
            by_len.setdefault(len(read.seq), []).append(ri)
    for L_r, idxs in by_len.items():
        if len(idxs) < 8:
            continue
        mat = np.frombuffer(b"".join(reads[ri].seq for ri in idxs), dtype=np.uint8).reshape(
            len(idxs), L_r
        )
        starts = np.array([reads[ri].pos - region_begin for ri in idxs])
        refs = ref_arr[starts[:, None] + np.arange(L_r)[None, :]]
        mism = (mat != refs) & is_acgt[mat] & is_acgt[refs]
        rows, cols = np.nonzero(mism)
        split = np.searchsorted(rows, np.arange(len(idxs) + 1))
        for k, ri in enumerate(idxs):
            bulk_hits[ri] = cols[split[k] : split[k + 1]]

    # bulk coverage + bucket bookkeeping for EVERY read (order-faithful:
    # cov_up/cov_down are order-free sums; bucket.max_pos_end is the max of
    # its reads' alignment ends; global_max_pos_end at a bucket is the
    # running max as of its last read, reads being position-sorted)
    valid_ri: list[int] = []
    valid_ends: list[int] = []
    for ri, read in enumerate(reads):
        if not read.cigar or read.pos < region_begin:
            continue
        off = read.pos - region_begin
        if off >= REF_SIZE:
            break
        span = sum(c for opc, c in read.cigar if opc in (0, 2, 3, 7, 8))
        valid_ri.append(ri)
        valid_ends.append(min(off + span, REF_SIZE - 1))
    if valid_ri:
        starts_v = np.array([reads[ri].pos - region_begin for ri in valid_ri])
        ends_v = np.array(valid_ends)
        np.add.at(cov_up, starts_v, 1)
        np.add.at(cov_down, ends_v, 1)
        b_idx = starts_v // BUCKET_SIZE
        n_b = int(b_idx.max()) + 1
        while len(buckets) < n_b:
            buckets.append(BucketFirstPass())
        ends_abs = ends_v + region_begin
        bucket_max = np.full(n_b, -1, dtype=np.int64)
        np.maximum.at(bucket_max, b_idx, ends_abs)
        run_max = np.maximum.accumulate(ends_abs)
        global_max_pos_end = int(run_max[-1])
        for b in np.unique(b_idx):
            buckets[b].max_pos_end = int(bucket_max[b])
            last = int(np.searchsorted(b_idx, b, side="right")) - 1
            buckets[b].global_max_pos_end = int(run_max[last])

    for ri, read in enumerate(reads):
        if not read.cigar or read.pos < region_begin:
            continue
        ref_offset = read.pos - region_begin
        if ref_offset >= REF_SIZE:
            break
        # pure-M reads without mismatches produce no events; their coverage
        # and bucket state were handled in the bulk pass above
        pre_hits = bulk_hits.get(ri)
        if pre_hits is not None and len(pre_hits) == 0:
            continue

        read_offset = 0
        seq = read.seq
        seq_arr = np.frombuffer(seq, dtype=np.uint8)
        qual = read.qual
        is_read_clipped = _is_clipped(read.cigar)
        cigar_events: list[tuple[Event, EventSupport]] = []

        for op, cnt in read.cigar:
            if ref_offset >= REF_SIZE:
                break
            if op in (0, 7, 8):  # M, =, X
                pre = bulk_hits.get(ri)
                if pre is not None:
                    hits = pre
                else:
                    # mismatch positions in one vector compare (bounded by
                    # both the reference end and the read end)
                    n_cmp = min(cnt, REF_SIZE - ref_offset, len(seq) - read_offset)
                    if n_cmp > 0:
                        a = seq_arr[read_offset : read_offset + n_cmp]
                        b_ = ref_arr[ref_offset : ref_offset + n_cmp]
                        mism = (a != b_) & ref_ok[ref_offset : ref_offset + n_cmp] & is_acgt[a]
                        hits = np.nonzero(mism)[0]
                    else:
                        hits = ()
                for r in map(int, hits):
                    ref_pos = ref_offset + r
                    read_pos = read_offset + r
                    read_b = seq[read_pos]
                    ev = Event(ref_pos + region_begin, "X", bytes([read_b]))
                    info = _add_event_to_bucket(buckets, ev, region_begin, reference, ref_pos, False)
                    if qual[read_pos] >= 25:
                        info.hq_count += 1
                    else:
                        info.lq_count += 1
                    if read.mapq != 255 and read.mapq > info.max_mapq:
                        info.max_mapq = read.mapq
                    info.proper_pairs += (read.flag & IS_PROPER_PAIR) != 0
                    info.first_in_pairs += (read.flag & IS_FIRST_IN_PAIR) != 0
                    info.sequence_reversed += (read.flag & IS_REVERSED) != 0
                    info.clipped += is_read_clipped
                    if info.uniq_pos1 == -1:
                        info.uniq_pos1 = read.pos
                    elif info.uniq_pos2 == -1:
                        if info.uniq_pos1 != read.pos:
                            info.uniq_pos2 = read.pos
                    elif info.uniq_pos3 == -1 and info.uniq_pos2 != read.pos:
                        info.uniq_pos3 = read.pos
                    max_distance = min(read_pos, len(seq) - 1 - read_pos)
                    if max_distance > info.max_distance:
                        info.max_distance = max_distance
                    cigar_events.append((ev, info))
                read_offset += cnt
                ref_offset += cnt
            elif op == 1:  # I
                piece = seq[read_offset : read_offset + cnt]
                if piece and all(c in ACGT for c in piece):
                    ev = Event(region_begin + ref_offset, "I", bytes(piece))
                    info = _add_event_to_bucket(buckets, ev, region_begin, reference, ref_offset, True)
                    info.hq_count += 1
                    if read.mapq != 255 and read.mapq > info.max_mapq:
                        info.max_mapq = read.mapq
                    info.proper_pairs += (read.flag & IS_PROPER_PAIR) != 0
                    info.sequence_reversed += (read.flag & IS_REVERSED) != 0
                    info.clipped += is_read_clipped
                    cigar_events.append((ev, info))
                read_offset += cnt
            elif op == 2:  # D
                if ref_offset + cnt >= REF_SIZE:
                    ref_offset += cnt
                    continue
                del_seq = reference[ref_offset : ref_offset + cnt]
                if all(c in ACGT for c in del_seq):
                    ev = Event(region_begin + ref_offset, "D", del_seq)
                    info = _add_event_to_bucket(buckets, ev, region_begin, reference, ref_offset, True)
                    info.hq_count += 1
                    if read.mapq != 255 and read.mapq > info.max_mapq:
                        info.max_mapq = read.mapq
                    info.proper_pairs += (read.flag & IS_PROPER_PAIR) != 0
                    info.sequence_reversed += (read.flag & IS_REVERSED) != 0
                    info.clipped += is_read_clipped
                    cigar_events.append((ev, info))
                ref_offset += cnt
            elif op == 4:  # S
                read_offset += cnt
            # H/P: nothing

        # demote event support on messy reads (caller.cpp:1114-1146)
        if len(cigar_events) >= HIGH_EVENT_COUNT:
            for _, info in cigar_events:
                if len(cigar_events) >= VHIGH_EVENT_COUNT:
                    if info.hq_count > 0:
                        info.hq_count -= 1
                    elif info.lq_count > 0:
                        info.lq_count -= 1
                else:
                    if info.hq_count > 0:
                        info.hq_count -= 1
                        info.lq_count += 1

        if len(cigar_events) < VHIGH_EVENT_COUNT:
            for e in range(1, len(cigar_events)):
                ev = cigar_events[e][0]
                for prev in range(e):
                    prev_info = cigar_events[prev][1]
                    prev_info.phase[ev] = prev_info.phase.get(ev, 0) + 1

    # trim excess buckets
    if (len(buckets) - 1) * BUCKET_SIZE >= REF_SIZE:
        buckets = buckets[: (REF_SIZE - 1) // BUCKET_SIZE + 1]
    NUM_BUCKETS = len(buckets)
    net_cov = cov_up - cov_down
    cum = np.concatenate([[0], np.cumsum(net_cov)])  # cum[i] = depth entering pos i

    def cov_at(pos: int) -> int:
        """Reads overlapping position pos (depth after processing pos)."""
        return int(cum[min(pos + 1, REF_SIZE)])

    # SNP filter (caller.cpp:915-990)
    for b in range(NUM_BUCKETS):
        bucket = buckets[b]
        for ev in _sorted_events(bucket.events):
            if ev.type != "X":
                continue
            info = bucket.events[ev]
            begin = max(0, ev.pos - region_begin)
            cov = cov_at(begin)
            gate_kw = {}
            if opts is not None:
                gate_kw = dict(
                    filter_on_proper_pairs=getattr(opts, "filter_on_proper_pairs", True),
                    no_filter_on_begin_pos=getattr(opts, "no_filter_on_begin_pos", False),
                    filter_on_read_bias=getattr(opts, "filter_on_read_bias", True),
                    filter_on_strand_bias=getattr(opts, "filter_on_strand_bias", True),
                )
            if not info.has_good_support(cov, **gate_kw):
                del bucket.events[ev]

    # indel realignment-support gates (caller.cpp:993-1190)
    for b in range(NUM_BUCKETS):
        bucket = buckets[b]
        for ev in _sorted_events(bucket.events):
            if ev.type == "X":
                continue
            info = bucket.events[ev]
            naive_pad = int(4.0 + len(ev.sequence) / 3.0)
            naive_begin = max(0, ev.pos - naive_pad - region_begin)
            naive_end = min(REF_SIZE, ev.pos + info.span + naive_pad - region_begin)
            correction = (
                (len(ev.sequence) / 2.0 + 8.0) / 8.0 if ev.type == "I" else (len(ev.sequence) / 3.0 + 10.0) / 10.0
            )
            count = correction * (info.hq_count + info.lq_count)
            # coverage of reads spanning the whole naive interval
            # (caller.cpp:1050-1081): depth entering naive_begin, minus reads
            # ending within [max(bucket_start, naive_begin), naive_end]
            cov = int(cum[naive_begin])
            s = max(b * BUCKET_SIZE, naive_begin)
            end_limit = min(naive_end, REF_SIZE - 1)
            if s <= end_limit:
                cov -= int(cov_down[s : end_limit + 1].sum())
            corrected_cov = max(float(cov), count)
            anti_count_d = corrected_cov - count
            log_qual = get_log_qual_double(count, anti_count_d, 10.0)
            if (
                info.hq_count >= 6
                and count >= 8.0
                and log_qual >= 60
                and info.sequence_reversed > 0
                and info.sequence_reversed < info.hq_count
                and info.proper_pairs >= 3
                and info.max_mapq >= 20
                and (info.clipped == 0 or (info.clipped + 3) <= info.hq_count)
            ):
                info.has_indel_good_support = True
                info.has_realignment_support = True
                info.max_log_qual = log_qual
                info.max_log_qual_file_i = 0
            elif (
                count >= 3.0
                and log_qual > 0
                and info.proper_pairs >= 1
                and (info.hq_count >= 5 or info.max_mapq >= 25)
                and info.max_mapq >= 10
                and info.clipped < info.hq_count
            ):
                info.has_realignment_support = True
                info.max_log_qual = log_qual
                info.max_log_qual_file_i = 0
            else:
                del bucket.events[ev]

    # SNP haplotype phase analysis (caller.cpp:1193-1360)
    for b in range(NUM_BUCKETS):
        bucket = buckets[b]
        for ev in _sorted_events(bucket.events):
            if ev not in bucket.events:
                continue
            info = bucket.events[ev]
            begin = max(0, ev.pos - region_begin)
            cov = cov_at(begin)
            hap = sample_haplotypes.setdefault(ev, HaplotypeInfo())
            support_ratio = max(0.3, info.get_raw_support() / max(cov, 1))

            def is_good_support(ev2: Event) -> int:
                is_indel = ev.type != "X" or ev2.type != "X"
                support = info.phase.get(ev2, 0)
                if is_indel:
                    if support == 0:
                        return 2  # anti
                    return 3  # both
                end = max(0, ev2.pos - region_begin)
                local_cov = cov - int(cov_down[begin + 1 : min(end, REF_SIZE - 1) + 1].sum())
                if local_cov <= 2:
                    return 0
                r = support / local_cov / support_ratio
                if r < 0.22:
                    return 2
                if r > 0.78:
                    return 1
                return 3

            def scan(other_events):
                for ev2 in other_events:
                    if ev2.pos == ev.pos and ev2.type == ev.type:
                        continue
                    if ev2.pos <= ev.pos:
                        continue
                    if ev2.pos >= ev.pos + 2 * BUCKET_SIZE:
                        continue
                    flags = is_good_support(ev2)
                    if flags & 1:
                        hap.ever_together.add(ev2)
                        if ev2.pos <= ev.pos + 10:
                            hap.always_together.add(ev2)

            # this bucket: events after ev
            evs = _sorted_events(bucket.events)
            scan([e for e in evs if e.sort_key() > ev.sort_key()])
            if b + 1 < NUM_BUCKETS:
                scan(_sorted_events(buckets[b + 1].events))
            if b + 2 < NUM_BUCKETS:
                scan(_sorted_events(buckets[b + 2].events))

            if ev.type == "X":
                del bucket.events[ev]

    return buckets, sample_haplotypes


def merge_haplotypes2(into: dict, from_: dict) -> None:
    """caller.cpp:64-165 — cross-sample intersection of always_together,
    union of ever_together."""
    if not into:
        into.update(from_)
        from_.clear()
        return
    for ev in sorted(from_.keys(), key=lambda e: e.sort_key()):
        from_hap = from_[ev]
        if ev not in into:
            into[ev] = from_hap
            # drop always-links to events already known in `into` (they were
            # not always-together in the other samples)
            from_hap.always_together = {e for e in from_hap.always_together if e not in into}
        else:
            into_hap = into[ev]
            into_hap.ever_together |= from_hap.ever_together
            into_hap.always_together &= from_hap.always_together
    from_.clear()


def _add_indel_support(info: EventSupport, read_pos: int, flags: int, mapq: int) -> None:
    """read.cpp Alignment::add_indel_event (:29-55)."""
    if read_pos == READ_ANTI_SUPPORT:
        info.anti_count += 1
    elif read_pos == READ_MULTI_SUPPORT:
        info.multi_count += 1
    else:
        info.hq_count += 1
        if flags & IS_REVERSED:
            info.sequence_reversed += 1
        if flags & IS_PROPER_PAIR:
            info.proper_pairs += 1
        if mapq < 255 and mapq > info.max_mapq:
            info.max_mapq = mapq


def _replace_indel_events(read: Read2, events_map: dict, new_events: list) -> None:
    """read.cpp:57-115."""
    for e in read.alignment.indel_events:
        info = events_map[e.event]
        if e.read_pos == READ_ANTI_SUPPORT:
            info.anti_count -= 1
        elif e.read_pos == READ_MULTI_SUPPORT:
            info.multi_count -= 1
        else:
            info.hq_count -= 1
            if (read.flags & IS_REVERSED) and info.sequence_reversed > 0:
                info.sequence_reversed -= 1
            if (read.flags & IS_PROPER_PAIR) and info.proper_pairs > 0:
                info.proper_pairs -= 1
    for e in new_events:
        info = events_map[e.event]
        _add_indel_support(info, e.read_pos, read.flags, read.mapq)
    read.alignment.indel_events = new_events


def read_reads_into_buckets(
    reads: list[AlignedRead],
    events_map: dict,
    num_buckets: int,
    region_begin: int,
    reference: bytes,
) -> tuple[list[Bucket2], int]:
    """caller.cpp:2232-2510 — re-read the sample, score reads against the
    reference, register indel events from CIGARs."""
    REF_SIZE = len(reference)
    buckets = [Bucket2() for _ in range(num_buckets)]
    max_read_size = 100
    global_max_pos_end = 0

    for r in reads:
        if not r.cigar or r.pos < region_begin:
            continue
        ref_offset = r.pos - region_begin
        if ref_offset < 0 or ref_offset >= REF_SIZE:
            continue
        bucket_index = ref_offset // BUCKET_SIZE
        if bucket_index >= len(buckets):
            buckets.extend(Bucket2() for _ in range(bucket_index + 1 - len(buckets)))
        if r.query_length > max_read_size:
            max_read_size = r.query_length

        read = Read2(
            name=r.name + ("/1" if r.flag & IS_FIRST_IN_PAIR else "/2"),
            mate_pos=r.mate_pos,
            flags=r.flag,
            mapq=r.mapq,
            sequence=bytes(r.seq),
            qual=r.qual,
        )
        read.alignment.score = 0
        read_offset = 0

        for i, (op, cnt) in enumerate(r.cigar):
            if ref_offset >= REF_SIZE:
                break
            if op in (0, 7, 8):
                ref_piece = reference[ref_offset : ref_offset + cnt]
                piece = read.sequence[read_offset : read_offset + cnt]
                n = min(len(ref_piece), len(piece))
                for k in range(n):
                    a, bb = piece[k], ref_piece[k]
                    if a != bb and a != ord("N") and bb != ord("N"):
                        read.alignment.score -= SCORE_MISMATCH
                    else:
                        read.alignment.score += SCORE_MATCH
                read_offset += cnt
                ref_offset += cnt
            elif op == 1:
                piece = read.sequence[read_offset : read_offset + cnt]
                if piece:
                    ev = Event(region_begin + ref_offset, "I", bytes(piece))
                    info = events_map.get(ev)
                    if info is None:
                        info = EventSupport()
                        info.span = compute_indel_span(ev, reference, ref_offset)
                        events_map[ev] = info
                    # register in bucket
                    _bucket_for_event(buckets, ev, region_begin).events[ev] = info
                    if not info.has_realignment_support:
                        read.alignment.score -= SCORE_GAP_OPEN + (cnt - 1) * SCORE_GAP_EXTEND
                    else:
                        read.alignment.score += SCORE_MATCH * cnt
                    _add_indel_support(info, read_offset, read.flags, read.mapq)
                    read.alignment.indel_events.append(ReadIndelEvent(read_offset, ev))
                read_offset += cnt
            elif op == 2:
                if ref_offset + cnt >= REF_SIZE:
                    continue
                ev = Event(region_begin + ref_offset, "D", reference[ref_offset : ref_offset + cnt])
                info = events_map.get(ev)
                if info is None:
                    info = EventSupport()
                    info.span = compute_indel_span(ev, reference, ref_offset)
                    events_map[ev] = info
                _bucket_for_event(buckets, ev, region_begin).events[ev] = info
                if not info.has_realignment_support:
                    read.alignment.score -= SCORE_GAP_OPEN + (cnt - 1) * SCORE_GAP_EXTEND
                _add_indel_support(info, read_offset, read.flags, read.mapq)
                read.alignment.indel_events.append(ReadIndelEvent(read_offset, ev))
                ref_offset += cnt
            elif op == 4:
                read_offset += cnt
                read.flags |= IS_CLIPPED
                read.alignment.score -= SCORE_CLIP
                if i == 0:
                    read.alignment.num_clipped_begin = cnt
                else:
                    read.alignment.num_clipped_end = cnt

        read.alignment.pos = r.pos
        read.alignment.pos_end = region_begin + ref_offset
        bucket = buckets[bucket_index]
        end_with_clip = read.alignment.pos_end + read.alignment.num_clipped_end
        if end_with_clip > bucket.max_pos_end:
            bucket.max_pos_end = end_with_clip
            global_max_pos_end = max(global_max_pos_end, end_with_clip)
        bucket.global_max_pos_end = global_max_pos_end
        bucket.reads.append(read)

    return buckets, max_read_size


def _bucket_for_event(buckets: list, ev: Event, region_begin: int) -> Bucket2:
    idx = (ev.pos - region_begin) // BUCKET_SIZE
    while idx >= len(buckets):
        buckets.append(Bucket2())
    return buckets[idx]


def realign_to_indels(
    realignment_indels: list[Event],
    events_map: dict,
    buckets: list[Bucket2],
    max_read_size: int,
    region_begin: int,
    reference: bytes,
    device: torch.device | str,
) -> None:
    """caller.cpp:1855-2230 — SW-realign candidate reads against the
    reference-with-indel; updates support/anti/multi counts and finally
    promotes indels to good support. Fork of
    graphtyper_tpu/typer/discovery.py:655; the SW batches go to the port's
    align_batch on `device`."""
    from graphtyper_tpu_torch.utils.dna import encode
    from graphtyper_tpu_torch.ops.sw import align_batch

    REF_SIZE = len(reference)
    PAD = 50

    for indel in realignment_indels:
        indel_info = events_map[indel]
        indel_span = indel.pos + indel_info.span
        begin_padded = max(0, indel.pos - max_read_size - 2 * PAD - region_begin)
        if begin_padded >= REF_SIZE:
            continue
        end_padded = indel.pos + max_read_size + 2 * PAD - region_begin
        new_ref0 = bytearray(reference[begin_padded : min(end_padded, REF_SIZE)])
        ref_pos0 = list(range(len(new_ref0)))
        if not apply_indel_event(new_ref0, ref_pos0, indel, begin_padded + region_begin):
            continue

        b = begin_padded // BUCKET_SIZE
        b_end = min(len(buckets) - 1, end_padded // BUCKET_SIZE)
        while b > 0 and buckets[b].global_max_pos_end > (indel.pos - PAD):
            b -= 1

        # gather candidate reads + per-read applied events
        candidates = []  # (read, applied_events, new_ref, ref_pos)
        for bi in range(b, b_end + 1):
            bucket = buckets[bi]
            if bucket.max_pos_end <= (indel.pos - PAD):
                continue
            for read in bucket.reads:
                if read.alignment.pos < 0 or len(read.sequence) == 0:
                    continue
                if read.alignment.has_indel_event(indel):
                    continue
                aln = read.alignment
                if (
                    (aln.num_clipped_end == 0 and aln.pos_end < indel.pos)
                    or (aln.pos_end + aln.num_clipped_end + min(aln.num_clipped_end, PAD) < indel.pos)
                    or (aln.num_clipped_begin == 0 and aln.pos > indel_span)
                    or (aln.pos - aln.num_clipped_begin - min(aln.num_clipped_begin, PAD) > indel_span)
                ):
                    continue
                # apply the read's other supported events to the ref copy
                applied = [ReadIndelEvent(0, indel)]
                new_ref = bytearray(new_ref0)
                ref_pos = list(ref_pos0)
                for e in read.alignment.indel_events:
                    info = events_map[e.event]
                    if info.has_realignment_support:
                        ok = apply_indel_event(new_ref, ref_pos, e.event, begin_padded + region_begin)
                        if ok:
                            applied.append(ReadIndelEvent(0, e.event))
                        else:
                            applied.append(ReadIndelEvent(READ_ANTI_SUPPORT, e.event))
                candidates.append((read, applied, bytes(new_ref), ref_pos))

        if not candidates:
            continue

        # batched SW over all candidate reads for this indel
        Mx = max(len(c[0].sequence) for c in candidates)
        Nx = max(len(c[2]) for c in candidates)
        Q = np.full((len(candidates), Mx), 5, dtype=np.uint8)
        D = np.full((len(candidates), Nx), 5, dtype=np.uint8)
        qlens = np.zeros(len(candidates), dtype=np.int64)
        dlens = np.zeros(len(candidates), dtype=np.int64)
        for ci, (read, _, nref, _rp) in enumerate(candidates):
            qc = encode(read.sequence)
            Q[ci, : len(qc)] = qc
            qlens[ci] = len(qc)
            dc = encode(nref)
            D[ci, : len(dc)] = dc
            dlens[ci] = len(dc)
        res = align_batch(Q, qlens, D, dlens, device)

        for ci, (read, applied, nref, ref_pos) in enumerate(candidates):
            score = int(res.score[ci])
            db_begin = int(res.database_begin[ci])
            db_end = int(res.database_end[ci])
            old_score = read.alignment.score
            if db_begin == 0 or db_end >= len(nref):
                continue  # insufficient padding
            if score <= old_score:
                if score < old_score:
                    _add_indel_support(events_map[indel], READ_ANTI_SUPPORT, read.flags, read.mapq)
                    read.alignment.indel_events.append(ReadIndelEvent(READ_ANTI_SUPPORT, indel))
                elif (
                    indel.pos >= ref_pos[db_begin] + begin_padded + region_begin
                    and indel.pos <= ref_pos[min(db_end, len(ref_pos) - 1)] + begin_padded + region_begin
                ):
                    _add_indel_support(events_map[indel], READ_MULTI_SUPPORT, read.flags, read.mapq)
                    read.alignment.indel_events.append(ReadIndelEvent(READ_MULTI_SUPPORT, indel))
                continue
            # better score: replace events and update alignment
            _replace_indel_events(read, events_map, applied)
            read.alignment.pos = ref_pos[db_begin] + region_begin + begin_padded
            read.alignment.pos_end = ref_pos[min(db_end, len(ref_pos) - 1)] + region_begin + begin_padded
            read.alignment.score = score

    # final promotion (caller.cpp:2178-2230)
    for indel in realignment_indels:
        info = events_map[indel]
        if info.has_indel_good_support:
            continue
        correction = (
            (len(indel.sequence) / 2.0 + 8.0) / 8.0 if indel.type == "I" else (len(indel.sequence) / 3.0 + 10.0) / 10.0
        )
        count = correction * (info.hq_count + info.lq_count)
        is_good_count = (
            (info.hq_count >= 5 and count >= 5.5)
            or (info.span >= 5 and info.hq_count >= 4 and count >= 5.0)
            or (info.span >= 15 and info.hq_count >= 3 and count >= 4.5)
        )
        if is_good_count and info.is_good_indel():
            info.has_indel_good_support = True


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def streamlined_discovery(
    hts_paths: list[str],
    ref_path: str,
    region_str: str,
    sample_names_out: list[str] | None,
    device: torch.device | str,
    dist=None,
) -> VcfOutput:
    """caller.cpp:2753-3095 — full discovery: first pass per sample, merge,
    realignment second pass, emit sites-only VCF with phasing INFO.

    `dist` (optional) distributes the per-file work across hosts
    (parallel/distributed.DiscoveryDist): each host computes first-pass
    partials only for the files it owns, partials allgather and merge in
    global file order on every host, and the sequential realignment rounds
    pass the shared event state between owners — so every host ends with a
    state (and emitted VCF) byte-identical to the single-process run.

    Fork of graphtyper_tpu/typer/discovery.py:788. The split first pass
    aggregates every owned file's rows in one call on `device`
    (device_discovery "auto" and "on" alike; "off" keeps the monolithic
    native pass), and realignment runs on `device`."""
    from graphtyper_tpu_torch.io.fasta import FastaFile

    region = GenomicRegion.parse(region_str)
    fasta = FastaFile(ref_path)
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    reference = fasta.fetch(region.chr, region.begin, region.end)
    region_begin = region.begin
    chromosome_offset = 0
    from graphtyper_tpu_torch.graph.coords import AbsolutePosition

    abs_pos = AbsolutePosition(fasta.contigs)
    # event positions are 0-based region offsets; +offset_of(chr,1) makes the
    # emitted variant positions 1-based absolute (caller.cpp:2760,2997)
    chromosome_offset = abs_pos.get_absolute_position(region.chr, 1)

    # first pass per file
    haplotypes: dict = {}
    indel_events: dict = {}  # Event -> EventSupport (merged across files)
    num_buckets = 0
    per_file_reads: list[list[AlignedRead]] = []

    from graphtyper_tpu_torch.config import current_options
    from graphtyper_tpu_torch.typer import native_discovery

    use_native_fp = current_options().native_caller != "off"

    per_file_reads = [None] * len(hts_paths)
    opts_now = current_options()

    def _first_pass_one(file_i: int, path: str):
        """(buckets, sample_haps, name, reads_or_none) for one file."""
        if use_native_fp and path.endswith(".bam"):
            # native first pass straight from BAM bytes; reads load lazily
            # only if this file later needs realignment
            from graphtyper_tpu_torch.pipeline.native_caller import _bam_bytes, _parse_bam_header_meta

            data = _bam_bytes(path)
            meta = _parse_bam_header_meta(data)
            if meta is not None:
                ref_names, samples, _text = meta
                target = ref_names.index(region.chr) if region.chr in ref_names else -2
                out = native_discovery.run_first_pass_native(
                    data, target, region_begin, reference, opts_now
                )
                if out is not None:
                    buckets, sample_haps = out
                    name = samples[0] if samples else path.rsplit("/", 1)[-1].split(".")[0]
                    return buckets, sample_haps, name, None
        header, reads = read_alignments_cached(path, ref_path=ref_path)
        reads = [r for r in reads if r.ref_id >= 0 and header.ref_names[r.ref_id] == region.chr]
        reads.sort(key=lambda r: r.pos)
        name = header.sample_names[0] if header.sample_names else path.rsplit("/", 1)[-1].split(".")[0]
        buckets, sample_haps = run_first_pass(reads, region_begin, reference, opts=opts_now)
        return buckets, sample_haps, name, reads

    owned = [
        (file_i, path)
        for file_i, path in enumerate(hts_paths)
        if dist is None or dist.owns(file_i)
    ]
    partials: dict[int, tuple] = {}
    threads = max(1, getattr(opts_now, "threads", 1))

    # split first-pass path (VERDICT r3 #2): per-file extraction emits
    # observation rows, every owned file's rows batch into ONE segment-sum
    # aggregation on the device (the port's ops/discovery_pileup), then the
    # unchanged native gates run per file. Files the
    # extractor cannot take (non-BAM, odd headers) fall through to
    # _first_pass_one. Reference analog: src/typer/caller.cpp:488-1365.
    use_rows = use_native_fp and getattr(opts_now, "device_discovery", "auto") != "off"
    extracts: dict[int, tuple] = {}  # file_i -> (extract dict, name)
    if use_rows:
        from graphtyper_tpu_torch.pipeline.native_caller import _bam_bytes, _parse_bam_header_meta

        def _extract_one(fp):
            file_i, path = fp
            if not path.endswith(".bam"):
                return None
            data = _bam_bytes(path)
            meta = _parse_bam_header_meta(data)
            if meta is None:
                return None
            ref_names, samples, _text = meta
            target = ref_names.index(region.chr) if region.chr in ref_names else -2
            x = native_discovery.fp_extract(data, target, region_begin, reference)
            if x is None:
                return None
            name = samples[0] if samples else path.rsplit("/", 1)[-1].split(".")[0]
            return x, name

        if threads > 1 and len(owned) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(threads, len(owned))) as ex:
                xs = list(ex.map(_extract_one, owned))
        else:
            xs = [_extract_one(fp) for fp in owned]
        extracts = {fi: r for (fi, _p), r in zip(owned, xs) if r is not None}
        if extracts:
            order = sorted(extracts)
            counters_list = native_discovery.aggregate_cohort(
                [extracts[fi][0] for fi in order], device
            )

            def _gates_one(args):
                fi, counters = args
                x, name = extracts[fi]
                out = native_discovery.fp_gates(x, counters, region_begin, reference, opts_now)
                return fi, out, name

            gate_jobs = list(zip(order, counters_list))
            if threads > 1 and len(gate_jobs) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=min(threads, len(gate_jobs))) as ex:
                    gated = list(ex.map(_gates_one, gate_jobs))
            else:
                gated = [_gates_one(j) for j in gate_jobs]
            for fi, out, name in gated:
                if out is not None:
                    buckets, sample_haps = out
                    partials[fi] = (buckets, sample_haps, name)
                    per_file_reads[fi] = None

    rest = [(fi, p) for fi, p in owned if fi not in partials]
    if rest:
        if threads > 1 and len(rest) > 1:
            # cohort fan-out: the native first pass and BGZF decode release
            # the GIL, so per-file threads give real parallelism
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(threads, len(rest))) as ex:
                results = list(ex.map(lambda fp: _first_pass_one(*fp), rest))
        else:
            results = [_first_pass_one(*fp) for fp in rest]
        for (file_i, _path), (buckets, sample_haps, name, reads) in zip(rest, results):
            per_file_reads[file_i] = reads
            partials[file_i] = (buckets, sample_haps, name)

    if dist is not None:
        # partials allgather: every host merges the full set in file order
        merged_partials: dict[int, tuple] = {}
        for d in dist.allgather(partials):
            merged_partials.update(d)
        partials = merged_partials

    for file_i in range(len(hts_paths)):
        buckets, sample_haps, name = partials[file_i]
        if sample_names_out is not None:
            sample_names_out.append(name)
        # fix file index on surviving indels
        for b in buckets:
            for ev, info in b.events.items():
                info.max_log_qual_file_i = file_i
        merge_haplotypes2(haplotypes, sample_haps)
        num_buckets = max(num_buckets, len(buckets))
        for b in buckets:
            for ev, info in b.events.items():
                old = indel_events.get(ev)
                if old is None:
                    indel_events[ev] = info
                else:
                    old.has_indel_good_support |= info.has_indel_good_support
                    if info.max_log_qual > old.max_log_qual:
                        old.max_log_qual = info.max_log_qual
                        old.max_log_qual_file_i = info.max_log_qual_file_i
    del partials

    # second pass: realign indels lacking good support, in their best file
    indel_to_realign: dict[int, list[Event]] = {}
    for ev in sorted(indel_events.keys(), key=lambda e: e.sort_key()):
        info = indel_events[ev]
        info.clear()
        info.anti_count = 0
        info.multi_count = 0
        if not info.has_indel_good_support:
            indel_to_realign.setdefault(info.max_log_qual_file_i, []).append(ev)

    def _file_reads(file_i: int):
        if per_file_reads[file_i] is None:
            header, reads = read_alignments_cached(hts_paths[file_i], ref_path=ref_path)
            reads = [r for r in reads if r.ref_id >= 0 and header.ref_names[r.ref_id] == region.chr]
            reads.sort(key=lambda r: r.pos)
            per_file_reads[file_i] = reads
        return per_file_reads[file_i]

    for file_i, indels in indel_to_realign.items():
        if not indels:
            continue
        if dist is not None and not dist.owns(file_i):
            # sequential state round: adopt the owner's post-realignment
            # event state (the shared counters accumulate across files in
            # file order — identical to the single-process walk)
            new_state = dist.sync_state(file_i, None)
            indel_events.clear()
            indel_events.update(new_state)
            continue
        buckets2 = None
        max_read_size = 100
        if use_native_fp and hts_paths[file_i].endswith(".bam"):
            # native second pass straight from BAM bytes (no AlignedRead
            # objects; C++ scores CIGARs, Python replays event support)
            from graphtyper_tpu_torch.pipeline.native_caller import _bam_bytes, _parse_bam_header_meta

            data = _bam_bytes(hts_paths[file_i])
            meta = _parse_bam_header_meta(data)
            if meta is not None:
                ref_names, _samples, _text = meta
                target = ref_names.index(region.chr) if region.chr in ref_names else -2
                out = native_discovery.read_reads_into_buckets_native(
                    data, target, indel_events, num_buckets, region_begin, reference,
                    realign_events=indels,
                )
                if out is not None:
                    buckets2, max_read_size = out
        if buckets2 is None:
            buckets2, max_read_size = read_reads_into_buckets(
                _file_reads(file_i), indel_events, num_buckets, region_begin, reference
            )
        # include nearby good events (caller.cpp:2690-2730)
        NEARBY_BP = 60
        all_events = sorted(indel_events.keys(), key=lambda e: e.sort_key())
        nearby = []
        for indel in indels:
            for ev in all_events:
                if ev == indel:
                    continue
                info2 = indel_events[ev]
                if info2.has_indel_good_support and abs(ev.pos - indel.pos) <= NEARBY_BP:
                    idx = (ev.pos - region_begin) // BUCKET_SIZE
                    if idx < len(buckets2) and ev in buckets2[idx].events:
                        nearby.append(ev)
        # order: good-support indels first, then in the reference's event
        # order (caller.cpp:2734-2744, event.cpp:173-181). The full sort key
        # breaks ties at one position; the JAX package sorts by position
        # alone, so its ties keep the set's order, which follows the
        # per-process hash salt of the events' str and bytes fields.
        work = sorted(
            set(indels + nearby),
            key=lambda e: (0 if indel_events[e].has_indel_good_support else 1, e.sort_key()),
        )
        realign_to_indels(
            work, indel_events, buckets2, max_read_size, region_begin, reference, device
        )
        if dist is not None:
            dist.sync_state(file_i, indel_events)

    # emission (caller.cpp:2953-3090)
    vcf = VcfOutput()
    sorted_haps = sorted(haplotypes.keys(), key=lambda e: e.sort_key())

    def indel_ok(ev: Event) -> bool:
        if ev.type == "X":
            return True
        info = indel_events.get(ev)
        return info is not None and info.has_indel_good_support

    for event_index, ev in enumerate(sorted_haps, start=1):
        if not indel_ok(ev):
            continue
        abs_p = ev.pos + chromosome_offset
        variant = Variant()
        variant.abs_pos = abs_p
        local = ev.pos - region_begin
        if ev.type == "X":
            variant.seqs = [reference[local : local + 1], ev.sequence]
            variant.type = "X"
        elif ev.type == "I":
            variant.seqs = [b"", ev.sequence]
            variant.type = "I"
        else:
            variant.seqs = [ev.sequence, b""]
            variant.type = "D"
        if ev.type in ("I", "D"):
            # add base in front from the local reference
            if local >= 1:
                base = reference[local - 1 : local]
                variant.seqs = [base + s for s in variant.seqs]
                variant.abs_pos -= 1
            else:
                variant.seqs = [b"N" + s for s in variant.seqs]
                variant.abs_pos -= 1

        hap_info = haplotypes[ev]
        ss_hap = []
        ss_anti = []
        next_index = event_index + 1
        for ev2 in sorted_haps[event_index:]:
            if ev2.pos >= ev.pos + 2 * BUCKET_SIZE:
                break
            if not indel_ok(ev2):
                next_index += 1
                continue
            if ev2 in hap_info.always_together:
                ss_hap.append(str(next_index))
            elif ev2 not in hap_info.ever_together:
                ss_anti.append(str(next_index))
            next_index += 1
        variant.infos["GT_ID"] = str(event_index)
        if ss_hap:
            variant.infos["GT_HAPLOTYPE"] = ",".join(ss_hap)
        if ss_anti:
            variant.infos["GT_ANTI_HAPLOTYPE"] = ",".join(ss_anti)
        vcf.variants.append(variant)

    return vcf
