"""Camou (camouflaged multi-copy region) genotyping.

Reference semantics: src/utilities/genotype_camou.cpp (:26-350, labeled WIP
in main.cpp:1378) — ploidy = 2 x number of intervals, no MAPQ filtering,
both-orientation alignment (main.cpp:1243-1247), camou PL adjustment
(variant.cpp update_camou_phred). The reference's camou discovery still
depends on the legacy VariantMap path whose producers are dead code
(hts_parallel_reader.cpp:1034-1222 commented out); we use the live
streamlined discovery instead and keep the camou calling semantics.

Fork of graphtyper_tpu/pipeline/genotype_camou.py: discovery and the call
pool of every interval run on the device they are given.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import replace

import torch

from graphtyper_tpu_torch.graph.build import construct_graph
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.index.build import index_graph
from graphtyper_tpu_torch.pipeline.caller import call_pool
from graphtyper_tpu_torch.pipeline.vcf_operations import vcf_merge_and_break
from graphtyper_tpu_torch.typer.discovery import streamlined_discovery


def parse_interval(line: str) -> str:
    """BED line -> region string (genotype_camou.cpp:28-58)."""
    fields = line.rstrip("\n").split("\t")
    if len(fields) >= 3:
        return f"{fields[0]}:{fields[1]}-{fields[2]}"
    if len(fields) == 2:
        return f"{fields[0]}:{fields[1]}"
    return fields[0]


def update_camou_phred_all(variants, ploidy: int) -> None:
    """variant.cpp:167-230 update_camou_phred applied to every variant."""
    import numpy as np

    from graphtyper_tpu_torch.models.genotype_model import to_index

    for var in variants:
        for call in var.calls:
            cov = call.coverage
            total = int(cov.sum())
            cnum = len(cov)
            if total == 0:
                phred = np.zeros(cnum * (cnum + 1) // 2, dtype=np.int64)
            else:
                phred = np.full(cnum * (cnum + 1) // 2, 99, dtype=np.int64)
                phred[0] = 0
                norm = [int(cov[k]) * ploidy // 2 for k in range(cnum)]
                for y in range(1, cnum):
                    ERROR = 4
                    phred00 = norm[y] * ERROR
                    phred01_or_11 = int(cov[0])
                    m = min(phred00, phred01_or_11)
                    phred00 = min(99, (phred00 - m) * 3)
                    phred01_or_11 = min(99, (phred01_or_11 - m) * 3)
                    if phred00 > phred[0]:
                        phred[0] = phred00
                    for x in range(cnum):
                        idx = to_index(min(x, y), max(x, y))
                        if phred01_or_11 < phred[idx]:
                            phred[idx] = phred01_or_11
            call.phred = phred


def genotype_camou(
    ref_path: str,
    interval_bed: str,
    sams: list[str],
    output_path: str,
    device: torch.device | str,
) -> str:
    """Camou genotyping of every BED interval on `device`. Fork of
    graphtyper_tpu/pipeline/genotype_camou.py:71 without its `opts`
    argument: the JAX function sets ploidy, filter_on_mapq=False and
    force_align_both_orientations on a copy of it that no callee reads
    (:78-84), so the ploidy reaches the writer through the global options
    and both orientations through call_pool, as here, and the MAPQ filter
    stays as the global options have it."""
    with open(interval_bed) as f:
        intervals = [parse_interval(l) for l in f if l.strip()]
    if not intervals:
        raise ValueError("No intervals in BED file")
    ploidy = 2 * len(intervals)
    # ploidy > 2 must reach the record writer: the FILTER column is "."
    # for polyploid calling (vcf.cpp:860)
    from graphtyper_tpu_torch.config import current_options, set_options

    _prev_opts = current_options()
    set_options(replace(_prev_opts, ploidy=ploidy))

    tmp = tempfile.mkdtemp(prefix="graphtyper_tpu_camou_")
    try:
        return _genotype_camou_body(ref_path, sams, output_path, device, intervals, ploidy, tmp)
    finally:
        set_options(_prev_opts)


def _genotype_camou_body(ref_path, sams, output_path, device, intervals, ploidy, tmp):
    outs = []
    for interval in intervals:
        region = GenomicRegion.parse(interval)
        padded = GenomicRegion(region.chr, region.begin, region.end)
        padded.pad(1000)
        # discovery on this interval
        sites = streamlined_discovery(sams, ref_path, padded.to_string(), [], device)
        it1 = os.path.join(tmp, f"sites_{region.chr}_{region.begin}.vcf.gz")
        graph0 = construct_graph(ref_path, "", padded.to_string())
        sites.write(it1, graph0.contigs, graph0.abs_pos, is_dropping_genotypes=True)
        # graph + call with camou options
        graph = construct_graph(ref_path, it1, padded.to_string(), add_all_variants=True)
        index = index_graph(graph)
        result = call_pool(
            graph,
            index,
            sams,
            device,
            region=padded,
            force_align_both_orientations=True,
            is_writing_hap=False,
        )
        update_camou_phred_all(result.vcf.variants, ploidy)
        out_vcf = os.path.join(tmp, f"camou_{region.chr}_{region.begin}.vcf.gz")
        # camou keeps bad alts (main.cpp:1247 force_no_filter_bad_alts)
        vcf_merge_and_break(
            [result.vcf], out_vcf, region.to_string(), graph,
            filter_zero_qual=True, force_no_filter_bad_alts=True,
        )
        outs.append((region, out_vcf))

    os.makedirs(output_path, exist_ok=True)
    final = None
    for region, out_vcf in outs:
        os.makedirs(os.path.join(output_path, region.chr), exist_ok=True)
        dst = os.path.join(output_path, region.chr, f"{region.begin + 1:09d}-{region.end:09d}.camou.vcf.gz")
        shutil.copyfile(out_vcf, dst)
        final = dst
    shutil.rmtree(tmp, ignore_errors=True)
    return final
