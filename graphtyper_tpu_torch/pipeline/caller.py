"""The pooled read caller: stream reads in (tid,pos,seq) order, deduplicate
identical reads (alignment computed once and reused — the reference's big
cohort-scale win), pair mates, score sites, derive the phasing map, and emit
a per-pool VcfOutput.

Reference semantics: src/utilities/hts_parallel_reader.cpp —
parallel_reader_genotype_only (:458-1033) incl. is_good_read SV gate (:528),
coverage bins (:599-633), leftover-mate handling (:719-772), phasing `ph`
map derivation (:790-904, thresholds 0.22/0.78, support>=4 or >=28%).

Port of graphtyper_tpu/pipeline/caller.py. Reading, pairing, the phasing
map and the pool result are the JAX module's host code, copied. The forks
of :216 `call_pool` and :629 `call_pools` construct the port's SiteScorer
on the device they are given, with the scorer's mesh, and call the
port's native caller, with the rep-sharded oracle (parallel/rep_shard.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.constants import (
    IS_ANY_ANTI_HAP_SUPPORT,
    IS_ANY_HAP_SUPPORT,
    IS_FIRST_IN_PAIR,
    IS_PAIRED,
    IS_REVERSED,
    IS_UNMAPPED,
)
from graphtyper_tpu_torch.index.kmer_index import KmerIndex
from graphtyper_tpu_torch.io.bam import AlignedRead, read_alignments_cached
from graphtyper_tpu_torch.typer.alignment import (
    align_read,
    get_better_paths,
    update_paths,
    update_unpaired_read_paths,
)
from graphtyper_tpu_torch.typer.scoring import SiteScorer
from graphtyper_tpu_torch.typer.vcf_out import VcfOutput

SAM_FLAG_FILTER = 3840  # options.hpp:90


class ReferenceDepth:
    """Per-sample depth track over the region (reference_depth.cpp)."""

    def __init__(self, graph, sample_count: int):
        self.reference_offset = graph.first_ref_order()
        size = len(graph.reference)
        self.depths = np.zeros((sample_count, size), dtype=np.int32)
        self.graph = graph

    def add_genotype_paths(self, geno, sample_index: int) -> None:
        if not geno.paths:
            return
        p = geno.paths[0]
        start = self.graph.get_ref_reach_pos(p.start) - self.reference_offset
        end = self.graph.get_ref_reach_pos(p.end) - self.reference_offset
        start = max(0, start)
        end = min(self.depths.shape[1], end + 1)
        if start < end:
            np.minimum(self.depths[sample_index, start:end] + 1, 0xFFFF, out=self.depths[sample_index, start:end])

    def get_read_depth(self, pos: int, sample_index: int) -> int:
        """Depth at one contig-local position (reference_depth.cpp:61-70)."""
        idx = pos - self.reference_offset
        if 0 <= idx < self.depths.shape[1]:
            return int(self.depths[sample_index, idx])
        return 0

    def get_max_depth(self, abs_pos: int, ref_len: int, sample_index: int) -> int:
        start = abs_pos - self.reference_offset
        end = start + ref_len - 1
        if ref_len > 1:
            start += 1
        start = max(0, start)
        end = min(self.depths.shape[1], end + 1)
        if start >= self.depths.shape[1] or start >= end:
            return 0
        return int(self.depths[sample_index, start:end].max())


def is_good_sv_read(read: AlignedRead) -> bool:
    """hts_parallel_reader.cpp:528-568."""
    if read.flag & IS_UNMAPPED:
        return False
    is_mate_far_away = read.ref_id != read.mate_ref_id or abs(read.pos - read.mate_pos) > 200000
    if read.mapq <= 15 and is_mate_far_away:
        return False
    if len(read.cigar) >= 2:
        op_f, cnt_f = read.cigar[0]
        op_b, cnt_b = read.cigar[-1]
        is_one_clipped = (op_f == 4 and cnt_f >= 12) or (op_b == 4 and cnt_b >= 12)
        are_both_clipped = op_f == 4 and op_b == 4
        if are_both_clipped or (read.mapq <= 15 and is_one_clipped):
            return False
    return True


@dataclass
class PoolResult:
    vcf: VcfOutput
    ph: dict  # {(hap_id1, allele1): {(hap_id2, allele2): int8 flags}}
    scorer: SiteScorer
    reference_depth: ReferenceDepth | None = None
    num_records: int = 0
    num_duplicated: int = 0


def _ref_span(cigar) -> int:
    """Reference bases consumed by a cigar (M/D/N/=/X); empty cigars span one
    base like htslib's bam_endpos."""
    span = 0
    for op, cnt in cigar:
        if op in (0, 2, 3, 7, 8):
            span += cnt
    return span if span > 0 else 1


def read_pool_records(
    hts_paths: list[str], region=None, ref_path: str | None = None,
    position_filter: bool = False,
) -> tuple[list[str], list[tuple[AlignedRead, int, int]]]:
    """Load and pool-merge reads: returns (sample_names, [(read, sample_i,
    rg_i)] sorted by (ref_id, pos, seq)). position_filter additionally keeps
    only reads overlapping [region.begin, region.end) — must match the
    native prep's filter exactly (native/gt_align.cpp parse_bam_pool)."""
    sample_names: list[str] = []
    pooled: list[tuple[AlignedRead, int, int]] = []
    for path in hts_paths:
        header, reads = read_alignments_cached(path, parse_tags=True, ref_path=ref_path)
        if header.sample_names:
            file_samples = header.sample_names
        else:
            file_samples = [path.rsplit("/", 1)[-1].split(".")[0]]
        base_idx = {}
        for s in file_samples:
            base_idx[s] = len(sample_names)
            sample_names.append(s)
        default_i = base_idx[file_samples[0]]
        # merged files (pipeline/sam_merge.py) carry several samples; records
        # resolve to samples via their RG tag (hts_reader.cpp RG->sample)
        multi = len(file_samples) > 1
        for r in reads:
            if region is not None:
                # region filter: read overlaps [begin, end) on the region contig
                if r.ref_id < 0:
                    continue
                if header.ref_names[r.ref_id] != region.chr:
                    continue
                if position_filter and not (
                    r.pos < region.end and r.pos + _ref_span(r.cigar) > region.begin
                ):
                    continue
            if multi:
                sm = header.rg_to_sample.get(r.tags.get("RG"))
                sample_i = base_idx.get(sm, default_i)
            else:
                sample_i = default_i
            pooled.append((r, sample_i, sample_i))
    pooled.sort(key=lambda t: (t[0].ref_id, t[0].pos, t[0].seq))
    return sample_names, pooled


class _StatsWriter:
    """--stats debug dumps: per-read and per-path TSVs, appended per sample
    (vcf_writer.cpp update_statistics/print_geno_statistics:442-540; the
    reference gzips per line-batch, here one gzip member per pool)."""

    def __init__(self, stats_dir: str, sample_names: list[str], graph):
        import os

        os.makedirs(stats_dir, exist_ok=True)
        self.dir = stats_dir
        self.samples = sample_names
        self.graph = graph
        self.read_lines: list[dict] = [dict() for _ in sample_names]
        self.reads: list[list[str]] = [[] for _ in sample_names]
        self.paths: list[list[str]] = [[] for _ in sample_names]

    def add(self, geno, read, sample_i: int) -> None:
        from graphtyper_tpu_torch.constants import IS_FIRST_IN_PAIR, IS_REVERSED
        from graphtyper_tpu_torch.utils.dna import decode

        rid = f"{self.samples[sample_i]}_{read.name}/{1 if geno.flags & IS_FIRST_IN_PAIR else 2}"
        seq = decode(geno.read2) if geno.read2 is not None else ""
        qual = (
            "".join(chr(q + 33) for q in geno.qual2) if geno.qual2 is not None else ""
        )
        ins = geno.ml_insert_size if geno.ml_insert_size != 0x7FFFFFFF else "."
        self.reads[sample_i].append(
            f"{rid}\t{self.samples[sample_i]}\t{seq}\t{qual}\t{geno.longest_path_length}\t"
            f"{geno.original_pos}\t{ins}"
        )
        for p, path in enumerate(geno.paths):
            chrom, start = self.graph.abs_pos.get_contig_position(path.start)
            _, end = self.graph.abs_pos.get_contig_position(path.end)
            strand = "F" if (geno.flags & IS_REVERSED) == 0 else "B"
            overlapping = ",".join(
                f"{vo}:{sorted(nums)}" for vo, nums in zip(path.var_order, path.nums)
            ) or "."
            self.paths[sample_i].append(
                f"{rid}\t{p}\t{path.read_start_index}\t{path.read_end_index}\t"
                f"{path.mismatches}\t{strand}\t{chrom}\t{start}\t{end}\t{overlapping}"
            )

    def flush(self) -> None:
        import gzip
        import os

        for i, sample in enumerate(self.samples):
            if self.reads[i]:
                with gzip.open(os.path.join(self.dir, f"{sample}_read_details.tsv.gz"), "at") as f:
                    f.write("\n".join(self.reads[i]) + "\n")
            if self.paths[i]:
                with gzip.open(os.path.join(self.dir, f"{sample}_read_path_details.tsv.gz"), "at") as f:
                    f.write("\n".join(self.paths[i]) + "\n")


def _scan_pool_variants(variants: list, sample_names: list[str]) -> list:
    """Pool-save scan: the batched native path handles eligible variants and
    returns the rest for the Python scan_calls."""
    from graphtyper_tpu_torch.typer import native_finisher

    if native_finisher.available():
        return native_finisher.scan_variants(variants, len(sample_names))
    return variants


def _build_pool_result(
    graph,
    scorer: SiteScorer,
    sample_names: list[str],
    ph: dict,
    reference_depth,
    is_writing_calls_vcf: bool,
    num_records: int,
    num_duplicated: int,
) -> PoolResult:
    is_sv = graph.is_sv_graph
    vcf = VcfOutput(sample_names=list(sample_names))
    if is_writing_calls_vcf:
        for ps, site in enumerate(scorer.sites):
            vcf.add_haplotype(site, ps, graph)
        if is_sv:
            from graphtyper_tpu_torch.typer.sv_reformat import reformat_sv_vcf_records

            with counters.span("sv.reformat", n=len(vcf.variants)):
                reformat_sv_vcf_records(vcf.variants, reference_depth, graph)
            vcf.variants.sort(key=lambda v: (v.abs_pos, v.seqs))
            for var in vcf.variants:
                var.stats = type(var.stats)()  # clear
        else:
            # segment calling skips the pool-save scan
            # (hts_parallel_reader.cpp:1022)
            from graphtyper_tpu_torch.config import current_options as _co

            if not _co().is_segment_calling:
                for var in _scan_pool_variants(vcf.variants, sample_names):
                    var.scan_calls()
    else:
        # sites-only VCF for haplotype extraction between iterations
        for ps, site in enumerate(scorer.sites):
            vcf.add_haplotype(site, ps, graph)
        for var in _scan_pool_variants(vcf.variants, sample_names):
            var.scan_calls()
        for var in vcf.variants:
            var.calls = []

    return PoolResult(
        vcf=vcf,
        ph=ph,
        scorer=scorer,
        reference_depth=reference_depth,
        num_records=num_records,
        num_duplicated=num_duplicated,
    )


def split_pools(hts_paths: list[str]) -> list[list[str]]:
    """The deterministic pool split call_pools uses: bounded by
    max_files_open (caller.cpp:197-220) and sized down so every worker
    thread gets a pool. Exposed so the rep-sharded distributed exchange
    (parallel/rep_shard.py) preps exactly the pools the call will run."""
    from graphtyper_tpu_torch.config import current_options

    opts = current_options()
    pool_size = max(1, opts.max_files_open)
    threads = max(1, getattr(opts, "threads", 1))
    if threads > 1 and len(hts_paths) > 1:
        pool_size = min(pool_size, max(1, -(-len(hts_paths) // threads)))
    return [hts_paths[lo : lo + pool_size] for lo in range(0, len(hts_paths), pool_size)]


def compute_ph_map(scorer: SiteScorer) -> dict:
    """Derive the phasing map from accumulated per-sample connections
    (hts_parallel_reader.cpp:790-904)."""
    sites = scorer.sites
    ph: dict = {}
    n = len(sites)
    for ps1 in range(n - 1):
        hap1 = sites[ps1]
        order1 = hap1.gt.id
        for ps2 in range(ps1 + 1, n):
            hap2 = sites[ps2]
            if hap2.gt.id >= order1 + 100:
                break
            for s in range(len(hap1.hap_samples)):
                samp1 = hap1.hap_samples[s]
                samp2 = hap2.hap_samples[s]
                conn_map = scorer.connections[ps1][s]
                cov_sum1 = float(samp1.gt_coverage.sum())
                cov_sum2 = float(samp2.gt_coverage.sum())
                for cov1 in range(1, hap1.gt.num):
                    conn = conn_map.get(cov1)
                    if conn is None:
                        continue
                    support_vec = conn.get(ps2)
                    if support_vec is None:
                        continue
                    c1 = int(samp1.gt_coverage[cov1])
                    is_clearly_seen1 = c1 >= 4 or (cov_sum1 > 0 and c1 / cov_sum1 >= 0.28)
                    is_not_seen1 = c1 <= 2 or (cov_sum1 > 0 and c1 / cov_sum1 < 0.22)
                    bucket = ph.setdefault((ps1, cov1), {})
                    total_support = int(support_vec.sum())
                    for cov2 in range(1, len(support_vec)):
                        support = float(support_vec[cov2])
                        c2 = int(samp2.gt_coverage[cov2])
                        is_clearly_seen2 = c2 >= 4 or (cov_sum2 > 0 and c2 / cov_sum2 >= 0.28)
                        is_not_seen2 = c2 <= 2 or (cov_sum2 > 0 and c2 / cov_sum2 < 0.22)
                        if is_not_seen1 and is_not_seen2:
                            continue
                        if (is_not_seen1 and is_clearly_seen2) or (is_not_seen2 and is_clearly_seen1):
                            is_good = IS_ANY_ANTI_HAP_SUPPORT
                        else:
                            if total_support <= 2:
                                continue
                            if is_clearly_seen1 and is_clearly_seen2 and support / total_support > 0.78:
                                is_good = IS_ANY_HAP_SUPPORT
                            elif support / total_support < 0.22:
                                is_good = IS_ANY_ANTI_HAP_SUPPORT
                            else:
                                continue
                        bucket[(ps2, cov2)] = bucket.get((ps2, cov2), 0) | is_good
    return ph


def call_pool(graph, index: KmerIndex, hts_paths: list[str], device: torch.device | str, *args,
              **kw) -> PoolResult:
    """`_call_pool` as span `call.pool` (n: samples), unless the caller
    (`call_pools`) already has one open on this thread."""
    with counters.outermost("call.pool", n=len(hts_paths)):
        return _call_pool(graph, index, hts_paths, device, *args, **kw)


def _call_pool(
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
    scorer_mesh=None,
    stream_spill: str | None = None,
    rep_oracle=None,
    batch_records: int | None = None,
) -> PoolResult:
    """parallel_reader_genotype_only for one pool of samples, scored on
    `device`, or over the entries of `scorer_mesh` (a parallel/mesh.py
    Mesh). `rep_oracle` imports the align
    results other hosts computed (parallel/rep_shard.py) and keeps the pool
    in memory. Fork of graphtyper_tpu/pipeline/caller.py:216.

    stream_spill: optional per-pool spill path for cross-iteration staged
    batch reuse in the streaming caller (native_caller.py
    run_native_call_pool_stream). batch_records: the records of one
    streamed batch, None for the streaming caller's own
    (native_caller.STREAM_BATCH_RECORDS)."""
    from graphtyper_tpu_torch.config import current_options as _copts
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
        fast = None
        stream_mode = getattr(_copts(), "streaming_caller", "auto")
        if rep_oracle is not None:
            # rep-sharded mode imports external results through the prep's
            # row numbering, which the streaming caller does not have
            stream_mode = "off"
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
                mesh=scorer_mesh,
                batch_records=batch_records or nc.STREAM_BATCH_RECORDS,
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
                mesh=scorer_mesh,
                rep_oracle=rep_oracle,
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
        mesh=scorer_mesh,
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

    from graphtyper_tpu_torch.config import current_options

    stats_dir = getattr(current_options(), "stats", "")
    stats = _StatsWriter(stats_dir, sample_names, graph) if stats_dir else None

    # amplicon primer masking (primers.cpp, hooked before scoring like
    # vcf_writer.cpp:88-143); forces the Python loop since the native loop
    # has no primer hook
    primers = None
    primer_bedpe = getattr(current_options(), "primer_bedpe", "")
    if primer_bedpe:
        from graphtyper_tpu_torch.typer.primers import Primers

        primers = Primers(primer_bedpe, graph)

    # Fully-native pooled loop (alignment + dedup + pairing + extraction in
    # C++, device scoring after): the production fast path. SV pools run the
    # same loop with the is_good_sv_read gate, coverage bins, leftover-mate
    # resolution and ReferenceDepth accumulated natively (gt_call_pool_sv).
    if current_options().native_caller != "off" and stats is None and primers is None:
        if not (
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
            native_stats = nc.run_native_call_pool(
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
        from graphtyper_tpu_torch.typer import native_align

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
    stream_budget: int | None = None,
    **kw,
) -> PoolResult:
    """Split the sample files into pools bounded by max_files_open
    (caller.cpp:197-220 _determine_num_jobs_and_num_parts), run call_pool per
    pool on `device`, and reduce: pool VCFs stream through batched files
    (vcf_operations.cpp:20-142) and phasing maps OR-merge
    (caller.cpp:439-482). Single pool passes straight through. Each pool
    is span `call.pool`, a child of the caller's span on whichever thread
    runs it (a single pool's `call_pool` opens it on the caller's thread).
    stream_budget: the records of one streamed batch, shared by the pools
    that run at once (each streams batches of stream_budget // their
    number), so that streaming memory does not grow with the split; None
    leaves each pool the streaming caller's own batch.
    Fork of graphtyper_tpu/pipeline/caller.py:629."""
    from graphtyper_tpu_torch.config import current_options

    pools = split_pools(hts_paths)
    threads = max(1, getattr(current_options(), "threads", 1))
    if stream_budget is not None:
        kw["batch_records"] = stream_budget // max(1, min(threads, len(pools)))
    if len(pools) <= 1:
        return call_pool(graph, index, hts_paths, device, **kw)

    import os
    import tempfile

    from graphtyper_tpu_torch.pipeline.vcf_operations import merge_ph_maps, vcf_merge_streamed

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
    parent = counters.current()

    def run_one(lo_pool):
        lo, pool = lo_pool
        kw_pool = dict(kw)
        if avg_cov is not None:
            kw_pool["avg_cov_by_readlen"] = list(avg_cov[lo : lo + pool_size])
        if kw_pool.get("stream_spill"):
            kw_pool["stream_spill"] = f"{kw_pool['stream_spill']}.pool{lo}"
        with counters.span("call.pool", n=len(pool), parent=parent):
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
    from graphtyper_tpu_torch.utils.log import get_logger

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
