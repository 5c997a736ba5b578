"""Reference-based discovery with device realignment and device pileup.

Forks of two functions of graphtyper_tpu/typer/discovery.py whose bodies
call the device layer: `realign_to_indels` (:655) runs its SW batches
through the port's `align_batch`, and `streamlined_discovery` (:788) runs
the first-pass aggregation through the port's pileup and calls the forked
realignment. Everything else is the JAX package's host code, imported.
The multi-host `dist` argument is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu.io.bam import AlignedRead, read_alignments_cached
from graphtyper_tpu.graph.coords import GenomicRegion
from graphtyper_tpu.typer.discovery import (
    BUCKET_SIZE,
    Bucket2,
    ReadIndelEvent,
    _add_indel_support,
    _replace_indel_events,
    merge_haplotypes2,
    read_reads_into_buckets,
    run_first_pass,
)
from graphtyper_tpu.typer.events import READ_ANTI_SUPPORT, READ_MULTI_SUPPORT, Event, apply_indel_event
from graphtyper_tpu.typer.variant import Variant
from graphtyper_tpu.typer.vcf_out import VcfOutput


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
    from graphtyper_tpu.utils.dna import encode
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
) -> VcfOutput:
    """caller.cpp:2753-3095 — full discovery: first pass per sample, merge,
    realignment second pass, emit sites-only VCF with phasing INFO.

    Fork of graphtyper_tpu/typer/discovery.py:788 without its `dist`
    argument. The split first pass aggregates every file's rows in one call
    on `device` (device_discovery "auto" and "on" alike; "off" keeps the
    monolithic native pass), and realignment runs on `device`."""
    from graphtyper_tpu.io.fasta import FastaFile

    region = GenomicRegion.parse(region_str)
    fasta = FastaFile(ref_path)
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    reference = fasta.fetch(region.chr, region.begin, region.end)
    region_begin = region.begin
    chromosome_offset = 0
    from graphtyper_tpu.graph.coords import AbsolutePosition

    abs_pos = AbsolutePosition(fasta.contigs)
    # event positions are 0-based region offsets; +offset_of(chr,1) makes the
    # emitted variant positions 1-based absolute (caller.cpp:2760,2997)
    chromosome_offset = abs_pos.get_absolute_position(region.chr, 1)

    # first pass per file
    haplotypes: dict = {}
    indel_events: dict = {}  # Event -> EventSupport (merged across files)
    num_buckets = 0
    per_file_reads: list[list[AlignedRead]] = []

    from graphtyper_tpu.config import current_options

    use_native_fp = current_options().native_caller != "off"
    if use_native_fp:
        from graphtyper_tpu.typer import native_discovery
        from graphtyper_tpu_torch.typer import native_discovery as device_discovery

        use_native_fp = native_discovery.available()

    per_file_reads = [None] * len(hts_paths)
    opts_now = current_options()

    def _first_pass_one(file_i: int, path: str):
        """(buckets, sample_haps, name, reads_or_none) for one file."""
        if use_native_fp and path.endswith(".bam"):
            # native first pass straight from BAM bytes; reads load lazily
            # only if this file later needs realignment
            from graphtyper_tpu.pipeline.native_caller import _bam_bytes, _parse_bam_header_meta

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

    owned = list(enumerate(hts_paths))
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
        from graphtyper_tpu.pipeline.native_caller import _bam_bytes, _parse_bam_header_meta

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
            counters_list = device_discovery.aggregate_cohort(
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
        buckets2 = None
        max_read_size = 100
        if use_native_fp and hts_paths[file_i].endswith(".bam"):
            # native second pass straight from BAM bytes (no AlignedRead
            # objects; C++ scores CIGARs, Python replays event support)
            from graphtyper_tpu.pipeline.native_caller import _bam_bytes, _parse_bam_header_meta

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
        # order: good-support indels first, then by position (caller.cpp:2734-2744)
        work = sorted(
            set(indels + nearby),
            key=lambda e: (0 if indel_events[e].has_indel_good_support else 1, e.sort_key()[0]),
        )
        realign_to_indels(
            work, indel_events, buckets2, max_read_size, region_begin, reference, device
        )

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
