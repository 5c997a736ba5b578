"""The pooled read caller routed to the port's device scorer.

Forks of graphtyper_tpu/pipeline/caller.py:216 `call_pool` and :629
`call_pools`: they construct the port's SiteScorer on the device they are
given and call the forked native caller. Reading, pairing, the phasing map
and the pool result are the JAX package's host code, imported. The
rep-sharded oracle and the mesh key are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtyper_tpu.constants import IS_FIRST_IN_PAIR, IS_PAIRED, IS_REVERSED
from graphtyper_tpu.index.kmer_index import KmerIndex
from graphtyper_tpu.io.bam import AlignedRead
from graphtyper_tpu.pipeline.caller import (
    SAM_FLAG_FILTER,
    PoolResult,
    ReferenceDepth,
    _StatsWriter,
    _build_pool_result,
    compute_ph_map,
    is_good_sv_read,
    read_pool_records,
    split_pools,
)
from graphtyper_tpu.typer.alignment import (
    align_read,
    get_better_paths,
    update_paths,
    update_unpaired_read_paths,
)
from graphtyper_tpu.typer.vcf_out import VcfOutput
from graphtyper_tpu_torch.typer.scoring import SiteScorer


def call_pool(
    graph,
    index: KmerIndex,
    hts_paths: list[str],
    device: torch.device | str,
    region=None,
    avg_cov_by_readlen: list[float] | None = None,
    is_writing_calls_vcf: bool = True,
    is_writing_hap: bool = True,
    force_align_both_orientations: bool = False,
    no_filter_on_coverage: bool = False,
    ref_path: str | None = None,
    stream_spill: str | None = None,
) -> PoolResult:
    """parallel_reader_genotype_only for one pool of samples, scored on
    `device` (fork of graphtyper_tpu/pipeline/caller.py:216).

    stream_spill: optional per-pool spill path for cross-iteration staged
    batch reuse in the streaming caller (native_caller.py
    run_native_call_pool_stream)."""
    from graphtyper_tpu.config import current_options as _copts
    from graphtyper_tpu.pipeline.native_caller import available as native_available
    from graphtyper_tpu_torch.pipeline import native_caller as nc

    # Fastest path: BAM bytes straight into the native loop (no AlignedRead
    # objects at all); falls through to the object paths on any mismatch.
    # SV pools run it too (gt_call_finish_sv: is_good_sv_read from the raw
    # records, coverage bins, leftover mates, native ReferenceDepth).
    if (
        _copts().native_caller != "off"
        and not getattr(_copts(), "stats", "")
        and not getattr(_copts(), "primer_bedpe", "")
        and region is not None
    ):
        if native_available():
            fast = None
            stream_mode = getattr(_copts(), "streaming_caller", "auto")
            use_stream = stream_mode == "on"
            if stream_mode == "auto" and all(p.endswith(".bam") for p in hts_paths):
                # big pools stream (bounded RSS); small pools stay in-memory
                # (lower latency)
                import os as _os

                total = sum(_os.path.getsize(p) for p in hts_paths)
                use_stream = len(hts_paths) >= 12 or total > 256 * 1024 * 1024
            if use_stream:
                sv_stream_cov = None
                if (
                    graph.is_sv_graph
                    and not no_filter_on_coverage
                    and avg_cov_by_readlen is not None
                ):
                    sv_stream_cov = avg_cov_by_readlen
                fast = nc.run_native_call_pool_stream(
                    graph,
                    index,
                    hts_paths,
                    region,
                    device,
                    sam_flag_filter=SAM_FLAG_FILTER,
                    force_both=force_align_both_orientations,
                    hq_reads=getattr(_copts(), "hq_reads", False),
                    avg_cov=sv_stream_cov,
                    stream_spill=stream_spill,
                )
            if fast is None:
                sv_avg_cov = None
                if (
                    graph.is_sv_graph
                    and not no_filter_on_coverage
                    and avg_cov_by_readlen is not None
                ):
                    sv_avg_cov = avg_cov_by_readlen
                fast = nc.run_native_call_pool_bam(
                    graph,
                    index,
                    hts_paths,
                    region,
                    device,
                    sam_flag_filter=SAM_FLAG_FILTER,
                    force_both=force_align_both_orientations,
                    hq_reads=getattr(_copts(), "hq_reads", False),
                    avg_cov=sv_avg_cov,
                    ref_path=ref_path,
                )
            if fast is not None:
                sample_names, scorer, num_records, num_duplicated, fast_depth = fast
                scorer.finalize()
                ph = compute_ph_map(scorer) if is_writing_hap else {}
                return _build_pool_result(
                    graph,
                    scorer,
                    sample_names,
                    ph,
                    fast_depth,
                    is_writing_calls_vcf,
                    num_records,
                    num_duplicated,
                )

    sample_names, pooled = read_pool_records(
        hts_paths, region, ref_path=ref_path, position_filter=graph.is_sv_graph
    )
    scorer = SiteScorer(
        graph,
        sample_names,
        device,
        hq_reads=getattr(_copts(), "hq_reads", False),
    )
    is_sv = graph.is_sv_graph
    reference_depth = ReferenceDepth(graph, len(sample_names)) if is_sv else None

    maps: list[dict] = [dict() for _ in sample_names]  # read name -> genos
    num_records = 0
    num_duplicated = 0
    prev_key = None
    prev_genos = None

    # SV coverage bins (50bp, 3x avg cap)
    first_pos = pooled[0][0].pos if pooled else 0
    bin_counts: list[dict[int, int]] = [dict() for _ in sample_names]
    coverage_filter = is_sv and not no_filter_on_coverage and avg_cov_by_readlen is not None

    def _bin_update(bins: list[dict[int, int]], read: AlignedRead, sample_i: int) -> bool:
        if avg_cov_by_readlen[sample_i] <= 0.0:
            return True
        max_bin = min(0xFFFF, int(avg_cov_by_readlen[sample_i] * 50.0 * 3.0 + 0.5))
        b = (read.pos - first_pos) // 50
        cnt = bins[sample_i].get(b, 0)
        if cnt > max_bin:
            return False
        bins[sample_i][b] = cnt + 1
        return True

    def update_bin_count(read: AlignedRead, sample_i: int) -> bool:
        if not coverage_filter:
            return True
        return _bin_update(bin_counts, read, sample_i)

    from graphtyper_tpu.config import current_options

    stats_dir = getattr(current_options(), "stats", "")
    stats = _StatsWriter(stats_dir, sample_names, graph) if stats_dir else None

    # amplicon primer masking (primers.cpp, hooked before scoring like
    # vcf_writer.cpp:88-143); forces the Python loop since the native loop
    # has no primer hook
    primers = None
    primer_bedpe = getattr(current_options(), "primer_bedpe", "")
    if primer_bedpe:
        from graphtyper_tpu.typer.primers import Primers

        primers = Primers(primer_bedpe, graph)

    # Fully-native pooled loop (alignment + dedup + pairing + extraction in
    # C++, device scoring after): the production fast path. SV pools run the
    # same loop with the is_good_sv_read gate, coverage bins, leftover-mate
    # resolution and ReferenceDepth accumulated natively (gt_call_pool_sv).
    if current_options().native_caller != "off" and stats is None and primers is None:
        from graphtyper_tpu.pipeline import native_caller as host_nc

        if native_available() and not (
            # avg_cov is per input FILE; with merged multi-sample files the
            # sample count can exceed it — keep the Python loop's loud
            # IndexError instead of native out-of-bounds reads
            coverage_filter
            and len(avg_cov_by_readlen) != len(sample_names)
        ):
            sv_ctx = None
            if is_sv:
                sv_ctx = {
                    "sv_bad": np.array(
                        [0 if is_good_sv_read(t[0]) else 1 for t in pooled], dtype=np.uint8
                    ),
                    "avg_cov": (
                        np.asarray(avg_cov_by_readlen, dtype=np.float64)
                        if coverage_filter
                        else None
                    ),
                    "first_pos": first_pos,
                    "depth": reference_depth.depths,
                    "ref_offset": reference_depth.reference_offset,
                }
            native_stats = host_nc.run_native_call_pool(
                graph,
                index,
                pooled,
                len(sample_names),
                scorer,
                sam_flag_filter=SAM_FLAG_FILTER,
                force_both=force_align_both_orientations,
                hq_reads=scorer.hq_reads,
                sv_ctx=sv_ctx,
            )
            if native_stats is not None:
                num_records, num_duplicated = native_stats
                scorer.finalize()
                ph = compute_ph_map(scorer) if is_writing_hap else {}
                return _build_pool_result(
                    graph,
                    scorer,
                    sample_names,
                    ph,
                    reference_depth,
                    is_writing_calls_vcf,
                    num_records,
                    num_duplicated,
                )
            if reference_depth is not None:
                reference_depth.depths[:] = 0  # discard partial native fill

    # Native batch alignment: collect the first read of every consecutive
    # (pos, seq) run (the loop below computes each unique alignment exactly
    # once from that representative) and align them all in one C++ call.
    # Under the SV coverage filter, the bin accounting decides per-read
    # whether alignment happens at all — but those decisions depend only on
    # read metadata (pos/flag/sample order), never on alignment results, so
    # a metadata-only pre-pass replays them exactly on a scratch bin state
    # and collects precisely the reads the main loop will align.
    aligned_iter = None
    if current_options().native_aligner != "off":
        from graphtyper_tpu.typer import native_align

        if native_align.available():
            reps = []
            rep_prev_key = None
            sim_bins: list[dict[int, int]] = [dict() for _ in sample_names]
            for read, _si, _ri in pooled:
                if read.flag & SAM_FLAG_FILTER:
                    continue
                if is_sv and not is_good_sv_read(read):
                    continue
                key = (read.pos, read.seq)
                if rep_prev_key is not None and key == rep_prev_key:
                    if coverage_filter:
                        _bin_update(sim_bins, read, _si)
                    continue
                if coverage_filter and not _bin_update(sim_bins, read, _si):
                    continue  # skipped new key: rep_prev_key stays, like prev_key
                reps.append(read)
                rep_prev_key = key
            aligner = native_align.NativeAligner(graph, index)
            aligned_iter = iter(aligner.align_batch(reps, force_align_both_orientations))

    def process(read: AlignedRead, sample_i: int, rg_i: int, genos) -> None:
        map_gpaths = maps[rg_i]
        found = map_gpaths.get(read.name)
        if found is None:
            if read.flag & IS_PAIRED:
                update_paths(genos, read)
                map_gpaths[read.name] = genos
            else:
                selected = update_unpaired_read_paths(genos, read)
                if selected is not None:
                    if stats is not None:
                        stats.add(selected, read, sample_i)
                    scorer.update_haplotype_scores(selected, sample_i, primers=primers)
        else:
            update_paths(genos, read)
            if (genos[0].flags & IS_FIRST_IN_PAIR) == (found[0].flags & IS_FIRST_IN_PAIR):
                raise ValueError(f"Reads with name={read.name} both have same IS_FIRST_IN_PAIR")
            better = get_better_paths(found, genos)
            if better is not None:
                if is_sv and reference_depth is not None:
                    reference_depth.add_genotype_paths(better[0], sample_i)
                    reference_depth.add_genotype_paths(better[1], sample_i)
                if stats is not None:
                    stats.add(better[0], read, sample_i)
                    stats.add(better[1], read, sample_i)
                scorer.update_haplotype_scores_pair(better[0], better[1], sample_i, primers=primers)
            del map_gpaths[read.name]

    for read, sample_i, rg_i in pooled:
        if read.flag & SAM_FLAG_FILTER:
            continue
        if is_sv and not is_good_sv_read(read):
            continue
        num_records += 1
        key = (read.pos, read.seq)
        if prev_key is not None and key == prev_key:
            num_duplicated += 1
            update_bin_count(read, sample_i)
            genos = [g.clone() for g in prev_genos]
        else:
            if not update_bin_count(read, sample_i):
                num_records -= 1
                continue
            if aligned_iter is not None:
                prev_genos = next(aligned_iter)
            else:
                prev_genos = align_read(graph, index, read, force_align_both_orientations)
            prev_key = key
            genos = [g.clone() for g in prev_genos]
        process(read, sample_i, rg_i, genos)

    # leftover mates (SV only — reference drops them otherwise)
    if is_sv:
        for rg_i, map_gpaths in enumerate(maps):
            sample_i = rg_i
            for name, genos in map_gpaths.items():
                other = [g.clone() for g in genos]
                for g in other:
                    g.flags ^= IS_FIRST_IN_PAIR | IS_REVERSED
                better = get_better_paths(genos, other)
                if better is not None:
                    reference_depth.add_genotype_paths(better[0], sample_i)
                    scorer.update_haplotype_scores(better[0], sample_i)
        maps = []

    if stats is not None:
        stats.flush()

    # apply all buffered device observations before state is consumed
    scorer.finalize()

    ph = compute_ph_map(scorer) if is_writing_hap else {}
    return _build_pool_result(
        graph,
        scorer,
        sample_names,
        ph,
        reference_depth,
        is_writing_calls_vcf,
        num_records,
        num_duplicated,
    )


def call_pools(
    graph,
    index: KmerIndex,
    hts_paths: list[str],
    device: torch.device | str,
    tmp_dir: str | None = None,
    **kw,
) -> PoolResult:
    """Split the sample files into pools bounded by max_files_open
    (caller.cpp:197-220 _determine_num_jobs_and_num_parts), run call_pool per
    pool on `device`, and reduce: pool VCFs stream through batched files
    (vcf_operations.cpp:20-142) and phasing maps OR-merge
    (caller.cpp:439-482). Single pool passes straight through. Fork of
    graphtyper_tpu/pipeline/caller.py:629."""
    from graphtyper_tpu.config import current_options

    pools = split_pools(hts_paths)
    if len(pools) <= 1:
        return call_pool(graph, index, hts_paths, device, **kw)
    threads = max(1, getattr(current_options(), "threads", 1))

    import os
    import tempfile

    from graphtyper_tpu.pipeline.vcf_operations import merge_ph_maps, vcf_merge_streamed

    own_tmp = tmp_dir is None
    tmp = tmp_dir or tempfile.mkdtemp(prefix="gt_pools_")
    pool_size = len(pools[0])
    offsets = list(range(0, len(hts_paths), pool_size))
    # per-pool slices of the per-file coverage list (SV bins index by the
    # pool-local sample, which is the pool-local file here); SV reformat
    # runs per pool against its own samples' ReferenceDepth — the
    # reference's per-job behavior (hts_parallel_reader.cpp:1003-1005) —
    # and the record sets are graph-derived, so the batch merge aligns
    avg_cov = kw.get("avg_cov_by_readlen")

    def run_one(lo_pool):
        lo, pool = lo_pool
        kw_pool = dict(kw)
        if avg_cov is not None:
            kw_pool["avg_cov_by_readlen"] = list(avg_cov[lo : lo + pool_size])
        if kw_pool.get("stream_spill"):
            kw_pool["stream_spill"] = f"{kw_pool['stream_spill']}.pool{lo}"
        return call_pool(graph, index, pool, device, **kw_pool)

    import time as _time

    _t0 = _time.monotonic()
    if threads > 1 and len(pools) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(threads, len(pools))) as ex:
            results = list(ex.map(run_one, zip(offsets, pools)))
    else:
        results = [run_one(lp) for lp in zip(offsets, pools)]

    # DO NOT CHANGE THIS LOG LINE FORMAT (genotype.cpp:117 "we parse it
    # externally" — the Thread work summary is the de-facto metrics feed)
    from graphtyper_tpu.utils.log import get_logger

    get_logger().info(
        "Finished calling. Thread work: pools=%d threads=%d records=%d wall=%.2fs",
        len(pools),
        min(threads, len(pools)),
        sum(r.num_records for r in results),
        _time.monotonic() - _t0,
    )

    pool_files: list[str] = []
    ph_maps: list[dict] = []
    num_records = 0
    num_duplicated = 0
    last = None
    for p, res in enumerate(results):
        path = os.path.join(tmp, f"pool{p}.vcfb")
        res.vcf.save_batched(path)
        pool_files.append(path)
        ph_maps.append(res.ph)
        num_records += res.num_records
        num_duplicated += res.num_duplicated
        last = res
        res.vcf = None
    sample_names, variants = vcf_merge_streamed(pool_files)
    merged = VcfOutput(sample_names=sample_names, variants=list(variants))
    if own_tmp:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return PoolResult(
        vcf=merged,
        ph=merge_ph_maps(ph_maps),
        scorer=last.scorer,
        reference_depth=last.reference_depth,
        num_records=num_records,
        num_duplicated=num_duplicated,
    )
