"""Genotyping pipeline orchestrators on a torch device.

Forks of graphtyper_tpu/pipeline/genotype.py: `genotype` (:146),
`genotype_only_with_a_vcf` (:20), `genotype_sv` (:84), `genotype_regions`
(:388) and its region worker pool (:347, :461-485); its two region helpers
are copied. The device
is an argument threaded down to discovery and the call iterations. Region
workers are spawn processes that get the device in the slot the JAX
package used for the jax platform, load the C++ engine and the kernel
library their parent built before the fan-out, and return their event
counters with their output path. There is no serial fallback: a
failing worker fails the call.
Each unit's stages are spans (counters.py): `bamshrink`, `discovery`,
`sites.write`, `graph.build`, `index.build`, `call`, `merge` and `write`
under `unit`, under the call's `job`; the workers return theirs too.
`genotype_sv` is a `job` of `graph.build`, `index.build`, `call.pool`
(with `sv.reformat` inside), `merge` and `write`.
"""

from __future__ import annotations

import os
import time

import torch

from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.graph.build import construct_graph
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.index.build import index_graph
from graphtyper_tpu_torch.pipeline.caller import call_pools, split_pools
from graphtyper_tpu_torch.pipeline.vcf_operations import vcf_merge_and_break, vcf_merge_and_filter


def _clamp_region_to_contig(region: GenomicRegion, ref_path: str) -> None:
    from graphtyper_tpu_torch.io.fasta import FastaFile

    fasta = FastaFile(ref_path)
    try:
        if fasta.has_contig(region.chr):
            region.end = min(region.end, fasta.contig_length(region.chr))
    finally:
        fasta.close()


def apply_cohort_size_tuning(n_samples: int) -> None:
    """Cohort-size parameter adjustment (genotype.cpp:693-732): larger
    cohorts demand more per-variant support before extraction since spurious
    candidates multiply with sample count. Mutates the global Options like
    the reference's singleton."""
    from graphtyper_tpu_torch.config import current_options, set_options
    from dataclasses import replace as _replace

    if n_samples < 4:
        return
    opts = current_options()
    extract = opts.minimum_extract_score_over_homref + 6
    if n_samples >= 1500:
        extract += 3
    set_options(
        _replace(
            opts,
            genotype_aln_min_support=opts.genotype_aln_min_support + 1,
            genotype_dis_min_support=opts.genotype_dis_min_support + 1,
            genotype_aln_min_support_ratio=opts.genotype_aln_min_support_ratio + 0.02,
            minimum_extract_score_over_homref=extract,
        )
    )


def genotype_only_with_a_vcf(
    ref_path: str,
    sams: list[str],
    vcf_path: str,
    region_str: str,
    output_dir: str,
    device: torch.device | str,
    avg_cov_by_readlen: list[float] | None = None,
) -> str:
    """Single-iteration genotyping from a known-variants VCF
    (genotype.cpp:262-334) on `device`. Returns the output VCF path. Fork of
    graphtyper_tpu/pipeline/genotype.py:20."""
    region = GenomicRegion.parse(region_str)
    _clamp_region_to_contig(region, ref_path)
    padded = GenomicRegion(region.chr, region.begin, region.end)
    padded.pad(1000)

    os.makedirs(output_dir, exist_ok=True)
    graph = construct_graph(ref_path, vcf_path, padded.to_string(), is_sv_graph=False, use_index=True)
    index = index_graph(graph)

    result = call_pools(
        graph,
        index,
        sams,
        device,
        region=padded,
        avg_cov_by_readlen=avg_cov_by_readlen,
        is_writing_calls_vcf=True,
        is_writing_hap=False,
        ref_path=ref_path,
    )

    # region-structured output, <out>/<chr>/<start>-<end>.vcf.gz, like the
    # iterative pipeline (genotype.cpp:606-659) so multi-region runs never
    # overwrite each other
    out_path = os.path.join(output_dir, region.to_file_string() + ".vcf.gz")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    vcf_merge_and_break(
        [result.vcf],
        out_path,
        region.to_string(),
        graph,
        filter_zero_qual=False,
    )
    # keep a stable top-level name for the common single-region case
    legacy = os.path.join(output_dir, "graphtyper.vcf.gz")
    import shutil

    shutil.copyfile(out_path, legacy)
    for ext in (".tbi", ".csi"):
        if os.path.exists(out_path + ext):
            shutil.copyfile(out_path + ext, legacy + ext)
    return out_path


def genotype_sv(
    ref_path: str,
    sv_vcf: str,
    sams: list[str],
    region_str: str,
    output_dir: str,
    device: torch.device | str,
    avg_cov_by_readlen: list[float] | None = None,
) -> str:
    """Single-iteration SV genotyping (genotype_sv.cpp:26-180), the pools
    scored on `device`. The call is span `job`, with `graph.build`,
    `index.build`, `call` (the pools, each a `call.pool`, and their
    reduce), `merge` and `write` under it. Fork of
    graphtyper_tpu/pipeline/genotype.py:84."""
    with counters.span("job"):
        return _genotype_sv(ref_path, sv_vcf, sams, region_str, output_dir, device, avg_cov_by_readlen)


def _genotype_sv(ref_path, sv_vcf, sams, region_str, output_dir, device, avg_cov_by_readlen) -> str:
    region = GenomicRegion.parse(region_str)
    _clamp_region_to_contig(region, ref_path)
    padded = GenomicRegion(region.chr, region.begin, region.end)
    padded.pad_end(200000)
    padded.pad(1000)

    os.makedirs(output_dir, exist_ok=True)
    # SV pools position-filter to the padded region (reference iterator
    # semantics); an index lets the native parse byte-slice instead of
    # decompressing whole inputs (io/bai.py) — CRAM needs none (container
    # headers carry ranges)
    bams = [p for p in sams if p.endswith(".bam")]
    if bams:
        from concurrent.futures import ThreadPoolExecutor

        from graphtyper_tpu_torch.io.bai import ensure_bai

        with ThreadPoolExecutor(max_workers=min(8, len(bams))) as ex:
            list(ex.map(ensure_bai, bams))
    with counters.span("graph.build"):
        graph = construct_graph(ref_path, sv_vcf, padded.to_string(), is_sv_graph=True, use_index=True)
    with counters.span("index.build"):
        index = index_graph(graph)

    # the samples split over the --threads pool threads as `genotype`'s
    # (graphtyper runs genotype_sv through the same call(), caller.cpp:197-220);
    # the pools that run at once share one pool's streamed batch, so the
    # split does not multiply the streaming memory
    from graphtyper_tpu_torch.pipeline.native_caller import STREAM_BATCH_RECORDS

    counters.add("sv_pools", len(split_pools(sams)))
    with counters.span("call"):
        result = call_pools(
            graph,
            index,
            sams,
            device,
            region=padded,
            avg_cov_by_readlen=avg_cov_by_readlen,
            is_writing_calls_vcf=True,
            is_writing_hap=False,
            ref_path=ref_path,
            stream_budget=STREAM_BATCH_RECORDS,
        )

    out_path = os.path.join(output_dir, "graphtyper.sv.vcf.gz")
    out_region = os.path.join(output_dir, region.to_file_string() + ".vcf.gz")
    os.makedirs(os.path.dirname(out_region), exist_ok=True)
    with counters.span("merge"):
        vcf_merge_and_break(
            [result.vcf],
            out_region,
            region.to_string(),
            graph,
            filter_zero_qual=True,
            force_no_break_down=True,  # SVs are not decomposed
        )
    import shutil

    with counters.span("write"):
        shutil.copyfile(out_region, out_path)
        for ext in (".tbi", ".csi"):
            if os.path.exists(out_region + ext):
                shutil.copyfile(out_region + ext, out_path + ext)
    return out_region


def genotype(
    ref_path: str,
    sams: list[str],
    region_str: str,
    output_path: str,
    device: torch.device | str,
    avg_cov_by_readlen: list[float] | None = None,
    prior_vcf: str | None = None,
    is_extra_call_only_iteration: bool = False,
    output_all_variants: bool = False,
    keep_tmp: bool = False,
    scorer_mesh=None,
) -> str:
    """The full discovery + iterative regenotyping pipeline
    (genotype.cpp:336-681):

    it1: reference-based discovery -> sites-only VCF
    it2..LAST-1: graph from previous sites (add-all-variants), call, extract
                 good alleles with phasing constraints (vcf_merge_and_filter)
    LAST: final call, merge, decompose, write the output VCF.

    Fork of graphtyper_tpu/pipeline/genotype.py:146: discovery and the call
    iterations run on `device`; with `scorer_mesh`
    (a parallel/mesh.py Mesh) every call iteration's scoring runs over
    that mesh.
    """
    import shutil
    import tempfile

    from graphtyper_tpu_torch.graph.coords import AbsolutePosition
    from graphtyper_tpu_torch.io.fasta import FastaFile
    from graphtyper_tpu_torch.typer.discovery import streamlined_discovery

    region = GenomicRegion.parse(region_str)
    fasta = FastaFile(ref_path)
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    padded = GenomicRegion(region.chr, region.begin, region.end)
    padded.pad(1000)
    if fasta.has_contig(region.chr):
        padded.end = min(padded.end, fasta.contig_length(region.chr))
    contigs = list(fasta.contigs)
    abs_pos = AbsolutePosition(contigs)
    fasta.close()

    tmp = tempfile.mkdtemp(prefix="graphtyper_tpu_")
    os.makedirs(output_path, exist_ok=True)
    os.makedirs(os.path.join(output_path, region.chr), exist_ok=True)
    os.makedirs(os.path.join(output_path, "input_sites", region.chr), exist_ok=True)

    from graphtyper_tpu_torch.config import current_options

    # read-preprocessing copy step (genotype.cpp:48-121 run_bamshrink): per
    # sample, slice + filter + trim into temp BAMs unless --no_bamshrink
    n_reads = None
    if not current_options().no_bamshrink:
        from graphtyper_tpu_torch.pipeline.bamshrink import run_bamshrink

        with counters.span("bamshrink") as sp:
            kept0 = counters.COUNTS["bamshrink_reads"]
            sams = run_bamshrink(
                list(sams), padded, tmp, avg_cov_by_readlen, current_options(),
                ref_path=ref_path,
            )
            # a process shrinks one unit at a time: the change is this unit's
            n_reads = sp.n = counters.COUNTS["bamshrink_reads"] - kept0

    # very large cohorts: merge per-sample inputs in chunks so pool readers
    # open fewer files (genotype.cpp:174-260)
    from graphtyper_tpu_torch.pipeline.sam_merge import run_sam_merge

    sams = run_sam_merge(list(sams), tmp, current_options())

    # ---- iteration 1: discovery ----
    it1 = os.path.join(tmp, "it1")
    os.makedirs(it1, exist_ok=True)
    # overlap: the reference backbone supplies ~95% of iteration 2's index
    # k-mers, so its seed filter builds on a background thread while
    # discovery runs (typer/native_align.prebuild_reference_seed_filter)
    ref_donor = None
    try:
        if current_options().native_caller != "off":
            from graphtyper_tpu_torch.typer.native_align import prebuild_reference_seed_filter
            from graphtyper_tpu_torch.utils.dna import encode

            f2 = FastaFile(ref_path)
            if f2.has_contig(padded.chr):
                refbytes = f2.fetch(padded.chr, padded.begin, padded.end)
                ref_donor = prebuild_reference_seed_filter(encode(refbytes.upper()))
            f2.close()
    except Exception:
        ref_donor = None
    sample_names: list[str] = []
    with counters.span("discovery", n=n_reads):
        sites_vcf = streamlined_discovery(sams, ref_path, padded.to_string(), sample_names, device)
    if prior_vcf:
        from graphtyper_tpu_torch.io.vcf_io import VcfReader
        from graphtyper_tpu_torch.typer.variant import Variant as TyperVariant

        for rec in VcfReader(prior_vcf).read_region(region.chr, region.begin, region.end):
            v = TyperVariant(
                abs_pos=abs_pos.get_absolute_position(rec.chrom, rec.pos + 1),
                seqs=[rec.ref.encode()] + [a.encode() for a in rec.alts],
            )
            sites_vcf.variants.append(v)
    it1_final = os.path.join(it1, "final.vcf.gz")
    # in-memory sites handoff: the file is the checkpoint, the records feed
    # the next iteration's graph directly (skips bgzf+tabix read-back)
    from graphtyper_tpu_torch.graph.build import records_from_vcf_output

    with counters.span("sites.write"):
        sites_vcf.write(it1_final, contigs, abs_pos, filter_zero_qual=False, is_dropping_genotypes=True)
        prev_records = records_from_vcf_output(sites_vcf, abs_pos)

    # ---- iterations 2..LAST ----
    FIRST_CALLONLY_ITERATION = 2
    LAST_ITERATION = 3 + (1 if is_extra_call_only_iteration else 0)
    prev_vcf = it1_final
    out_vcf_path = os.path.join(tmp, "graphtyper.vcf.gz")
    final_result = None
    graph = None

    prev_index = None
    for i in range(FIRST_CALLONLY_ITERATION, LAST_ITERATION + 1):
        is_last = i == LAST_ITERATION
        out_dir = os.path.join(tmp, f"it{i}")
        os.makedirs(out_dir, exist_ok=True)
        with counters.span("graph.build"):
            graph = construct_graph(
                ref_path, prev_vcf, padded.to_string(), is_sv_graph=False, use_index=True,
                add_all_variants=True, records=prev_records,
            )
        # successive iterations share almost every k-mer (the reference
        # backbone), so the seed filter carries over with a small additive
        # update instead of a rebuild (native_align._adopt_donor_filter);
        # iteration 2 adopts the prebuilt reference-backbone filter
        with counters.span("index.build"):
            index = index_graph(graph, seed_filter_donor=prev_index or ref_donor)
        prev_index = index
        with counters.span("call"):
            result = call_pools(
                graph,
                index,
                sams,
                device,
                region=padded,
                avg_cov_by_readlen=avg_cov_by_readlen,
                is_writing_calls_vcf=is_last,
                is_writing_hap=not is_last,
                ref_path=ref_path,
                scorer_mesh=scorer_mesh,
                # call iterations stream the identical record sequence: iteration
                # 2 can spill the staged batches and iteration 3 replay them,
                # skipping decompress+parse+extract. Opt-in (GT_STREAM_SPILL=1),
                # as in the JAX package (graphtyper_tpu/pipeline/genotype.py:282):
                # the spill is about four times the BGZF input, so it pays only
                # where the disk is faster than decompression.
                stream_spill=os.path.join(tmp, "stream_spill")
                if os.environ.get("GT_STREAM_SPILL", "0") == "1"
                else None,
            )
        if not is_last:
            next_vcf = os.path.join(out_dir, "final.vcf.gz")
            with counters.span("merge"):
                filtered = vcf_merge_and_filter([result.vcf], next_vcf, result.ph, graph)
                prev_records = records_from_vcf_output(filtered, abs_pos)
            prev_vcf = next_vcf
        else:
            final_result = result
            with counters.span("merge"):
                vcf_merge_and_break(
                    [result.vcf],
                    out_vcf_path,
                    region.to_string(),
                    graph,
                    filter_zero_qual=output_all_variants,
                )
                if current_options().normal_and_no_variant_overlapping:
                    # a second, non-overlapping decomposition of the same calls
                    # (genotype.cpp:594-603)
                    vcf_merge_and_break(
                        [result.vcf],
                        os.path.join(tmp, "graphtyper_no_variant_overlapping.vcf.gz"),
                        region.to_string(),
                        graph,
                        filter_zero_qual=output_all_variants,
                        force_no_variant_overlapping=True,
                    )

    # ---- copy results ----
    with counters.span("write"):
        dst = _copy_results(tmp, output_path, region, prev_vcf, out_vcf_path)
    # --no_cleanup keeps the temporary iteration folders (genotype.cpp:664)
    if not keep_tmp and not current_options().no_cleanup:
        shutil.rmtree(tmp, ignore_errors=True)
    return dst


def _copy_results(tmp: str, output_path: str, region, prev_vcf: str, out_vcf_path: str) -> str:
    """Copy a unit's results out of its temporary directory: the sites of
    its last call iteration's input, its VCF with the index, and the
    sidecars; returns the VCF's path."""
    import shutil

    sites_dst = os.path.join(output_path, "input_sites", region.to_file_string() + ".vcf.gz")
    shutil.copyfile(prev_vcf, sites_dst)
    final_name = f"{region.begin + 1:09d}-{region.end:09d}.vcf.gz"
    dst = os.path.join(output_path, region.chr, final_name)
    shutil.copyfile(out_vcf_path, dst)
    for ext in (".tbi", ".csi"):
        if os.path.exists(out_vcf_path + ext):
            shutil.copyfile(out_vcf_path + ext, dst + ext)
    # --uncompressed_sample_names byte-range sidecar (genotype.cpp:645)
    br_src = os.path.join(tmp, "graphtyper.samples_byte_range")
    if os.path.exists(br_src):
        shutil.copyfile(br_src, dst[: -len(".vcf.gz")] + ".samples_byte_range")
    # the second (non-overlapping) decomposition output (genotype.cpp:648-658)
    novl_src = os.path.join(tmp, "graphtyper_no_variant_overlapping.vcf.gz")
    if os.path.exists(novl_src):
        novl_dst = dst[: -len(".vcf.gz")] + ".no_variant_overlapping.vcf.gz"
        shutil.copyfile(novl_src, novl_dst)
        for ext in (".tbi", ".csi"):
            if os.path.exists(novl_src + ext):
                shutil.copyfile(novl_src + ext, novl_dst + ext)
        br2 = os.path.join(tmp, "graphtyper_no_variant_overlapping.samples_byte_range")
        if os.path.exists(br2):
            shutil.copyfile(br2, novl_dst[: -len(".vcf.gz")] + ".samples_byte_range")
    return dst


def _genotype_one(args_tuple):
    """Region worker (fork of graphtyper_tpu/pipeline/genotype.py:347):
    returns (output path, this job's event counters, its spans). The job
    carries its parent's span, None when the parent records none, and when
    it was handed to the pool, on the wall clock."""
    ref_path, sams, sub_str, output_path, device, opts, kw, job, submit_ns = args_tuple
    from graphtyper_tpu_torch.config import set_options

    # spawn children start from default Options — restore the parent's
    set_options(opts)
    counters.trace(job is not None)
    counters.take()  # a warm worker reports this job only
    counters.record("pool.wait", submit_ns, time.time_ns(), parent=job)
    with counters.span("unit", parent=job):
        out = genotype(ref_path, sams, sub_str, output_path, device, **kw)
    return (out, *counters.take())


def genotype_regions(
    ref_path: str,
    sams: list[str],
    region_str: str,
    output_path: str,
    device: torch.device | str,
    max_region_size: int = 50_000,
    processes: int | None = None,
    **kw,
) -> list[str]:
    """Split the region into <=50kb units and genotype each on `device`
    (genotype.cpp:683-741, main.cpp:30-58). With processes > 1 the units
    fan out over a persistent spawn-process pool; each worker's counters and
    spans are added to counters.WORKERS and counters.WORKER_SPANS. The call
    is span `job`, each unit a `unit` under it. Fork of
    graphtyper_tpu/pipeline/genotype.py:388."""
    from graphtyper_tpu_torch.config import current_options
    from graphtyper_tpu_torch.graph.coords import split_region
    from graphtyper_tpu_torch.io.fasta import FastaFile

    with counters.span("job"):
        device = torch.device(device)
        apply_cohort_size_tuning(len(sams))
        region = GenomicRegion.parse(region_str)
        fasta = FastaFile(ref_path)
        if fasta.has_contig(region.chr):
            region.end = min(region.end, fasta.contig_length(region.chr))
        fasta.close()
        subs = list(split_region(region, max_region_size))
        if len(subs) > 1:
            # index inputs once in the parent so every region worker's bamshrink
            # decodes only its slice (io/bai.py) instead of the whole file
            from graphtyper_tpu_torch.io.bai import ensure_bai

            if len(sams) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=min(8, len(sams))) as ex:
                    list(ex.map(ensure_bai, sams))
            else:
                ensure_bai(sams[0])
        if processes is None:
            processes = getattr(current_options(), "threads", 1)
        if processes > 1 and len(subs) > 1:
            # build once here; the workers find the libraries built
            from graphtyper_tpu_torch.io.native import get_lib

            get_lib()
            if device.type == "cuda":
                from graphtyper_tpu_torch import kernels

                kernels.load()
            job = counters.current()
            submit_ns = time.time_ns() if job is not None else None
            jobs = [
                (ref_path, sams, s.to_string(), output_path, str(device), current_options(), kw, job,
                 submit_ns)
                for s in subs
            ]
            outs = []
            for out, job_counts, job_spans in _region_pool(processes).map(_genotype_one, jobs):
                counters.add_worker(job_counts, job_spans)
                outs.append(out)
            return outs
        outs = []
        for s in subs:
            with counters.span("unit"):
                outs.append(genotype(ref_path, sams, s.to_string(), output_path, device, **kw))
        return outs


# ---- persistent region worker pool ----------------------------------------
# Spawn workers (fork is unsafe under a live CUDA context) pay the torch
# import and the CUDA context once per process; the pool stays alive across
# genotype_regions calls so chromosome-scale runs stream regions through
# warm workers.
_POOL = None
_POOL_SIZE = 0


def _region_pool(processes: int):
    global _POOL, _POOL_SIZE
    if _POOL is not None and _POOL_SIZE != processes:
        shutdown_region_pool()
    if _POOL is None:
        import atexit
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        _POOL = ProcessPoolExecutor(max_workers=processes, mp_context=mp.get_context("spawn"))
        _POOL_SIZE = processes
        atexit.register(shutdown_region_pool)
    return _POOL


def shutdown_region_pool() -> None:
    """Stop the region workers (they also stop at interpreter exit)."""
    global _POOL
    if _POOL is not None:
        _POOL.shutdown(wait=True, cancel_futures=True)
        _POOL = None
