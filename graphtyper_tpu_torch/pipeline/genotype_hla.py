"""HLA genotyping pipeline (src/utilities/genotype_hla.cpp, WIP in the
reference per main.cpp:1378): graph from a known-HLA VCF whose sample
columns are HLA alleles, reads aligned and scored per site, then every
diploid pair of HLA alleles scored to emit one allele-level <H> record.

Fork of graphtyper_tpu/pipeline/genotype_hla.py: the pool is scored on the
device it is given.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

from graphtyper_tpu_torch.graph.build import construct_graph
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.index.build import index_graph
from graphtyper_tpu_torch.pipeline.caller import call_pool
from graphtyper_tpu_torch.pipeline.vcf_tools import read_vcf_with_calls
from graphtyper_tpu_torch.typer.hla import add_hla_haplotypes, build_allele_hap_gts
from graphtyper_tpu_torch.typer.vcf_out import VcfOutput


def genotype_hla(
    ref_path: str,
    hla_vcf_fn: str,
    sams: list[str],
    region_str: str,
    output_path: str,
    device: torch.device | str,
    interval_fn: str | None = None,
    segment_fasta_files: list[str] | None = None,
) -> str:
    """HLA genotyping (genotype_hla.cpp) on `device`: optional multi-interval
    bamshrink preprocessing over a BED file (:106-107), allele-level <H>
    record from the panel VCF, and — when segment FASTAs are given —
    whole-panel segment calling (segment_calling.cpp) into a sibling
    .segments.vcf.gz. Fork of graphtyper_tpu/pipeline/genotype_hla.py:22."""
    from dataclasses import replace

    from graphtyper_tpu_torch.config import current_options, set_options

    # the reference's genotype_hla subcommand option block (main.cpp:837-844):
    # segment-calling output semantics ("." FILTER, GT:GQ:PL on <...> records,
    # no pool-save scan), HQ-read filtering, no decomposition
    prev_opts = current_options()
    set_options(
        replace(prev_opts, is_segment_calling=True, hq_reads=True, no_decompose=True)
    )
    try:
        return _genotype_hla_body(
            ref_path, hla_vcf_fn, sams, region_str, output_path, device, interval_fn,
            segment_fasta_files,
        )
    finally:
        set_options(prev_opts)


def _genotype_hla_body(
    ref_path, hla_vcf_fn, sams, region_str, output_path, device, interval_fn, segment_fasta_files
) -> str:
    from graphtyper_tpu_torch.io.fasta import FastaFile

    region = GenomicRegion.parse(region_str)
    fasta = FastaFile(ref_path)
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    fasta.close()
    padded = GenomicRegion(region.chr, region.begin, region.end)
    padded.pad(1000)

    if interval_fn:
        from graphtyper_tpu_torch.pipeline.bamshrink import run_bamshrink_multi

        shrink_tmp = tempfile.mkdtemp(prefix="graphtyper_tpu_hla_shrink_")
        sams = run_bamshrink_multi(sams, interval_fn, shrink_tmp)

    graph = construct_graph(ref_path, hla_vcf_fn, padded.to_string(), use_index=True)
    index = index_graph(graph)

    hla_vcf, _contigs = read_vcf_with_calls(hla_vcf_fn)
    allele_names, allele_hap_gts = build_allele_hap_gts(graph, hla_vcf)

    result = call_pool(graph, index, sams, device, region=padded, is_writing_hap=False)

    out = VcfOutput(sample_names=result.vcf.sample_names)
    add_hla_haplotypes(out, result.scorer, allele_hap_gts, graph)
    for var in out.variants:
        var.scan_calls()
        # name alleles in INFO so the <H> indices are interpretable
        var.infos["HLA_ALLELES"] = ",".join(allele_names)

    os.makedirs(os.path.join(output_path, region.chr), exist_ok=True)
    if segment_fasta_files:
        from graphtyper_tpu_torch.typer.segment_calling import segment_calling

        seg_dst = os.path.join(
            output_path, region.chr, f"{region.begin + 1:09d}-{region.end:09d}.segments.vcf.gz"
        )
        segment_calling(
            graph, index, result.scorer, segment_fasta_files, seg_dst, result.vcf.sample_names
        )
    dst = os.path.join(output_path, region.chr, f"{region.begin + 1:09d}-{region.end:09d}.hla.vcf.gz")
    tmp = tempfile.mkdtemp(prefix="graphtyper_tpu_hla_")
    out_tmp = os.path.join(tmp, "hla.vcf.gz")
    out.write(out_tmp, graph.contigs, graph.abs_pos, filter_zero_qual=False, output_all_variants=True)
    shutil.copyfile(out_tmp, dst)
    shutil.rmtree(tmp, ignore_errors=True)
    return dst
