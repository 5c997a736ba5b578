"""Long-read genotyping pipeline (src/utilities/genotype_lr.cpp:26-178):
single pass of pileup-based genotyping over the padded region, results
copied to <out>/<chr>/<start>-<end>.vcf.gz.
"""

from __future__ import annotations

import os
import shutil
import tempfile

from graphtyper_tpu_torch.config import Options
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.io.fasta import FastaFile
from graphtyper_tpu_torch.typer.discovery_lr import streamlined_lr_genotyping


def genotype_lr(
    ref_path: str,
    sams: list[str],
    region_str: str,
    output_path: str,
    opts: Options | None = None,
) -> str:
    from dataclasses import replace

    from graphtyper_tpu_torch.config import current_options, set_options

    # the reference's genotype_lr subcommand sets is_lr_calling
    # (main.cpp:1066): scan_calls bumps GQ by 10 (variant.cpp:334) and the
    # FILTER column is "." (vcf.cpp:860)
    # subcommand defaults (main.cpp:1065-1066, :1181-1182): LR calling mode,
    # read-bias / proper-pair filters off
    opts = replace(
        opts or Options(),
        is_lr_calling=True,
        filter_on_read_bias=False,
        filter_on_proper_pairs=False,
    )
    prev_opts = current_options()
    set_options(
        replace(
            prev_opts,
            is_lr_calling=True,
            filter_on_read_bias=False,
            filter_on_proper_pairs=False,
        )
    )
    try:
        region = GenomicRegion.parse(region_str)
        fasta = FastaFile(ref_path)
        if fasta.has_contig(region.chr):
            region.end = min(region.end, fasta.contig_length(region.chr))
        contigs = list(fasta.contigs)
        fasta.close()
        padded = GenomicRegion(region.chr, region.begin, region.end)
        padded.pad(1000)

        tmp = tempfile.mkdtemp(prefix="graphtyper_tpu_lr_")
        vcf = streamlined_lr_genotyping(sams, ref_path, padded.to_string(), opts)
        out_tmp = os.path.join(tmp, "graphtyper.vcf.gz")
        vcf.write(out_tmp, vcf._contigs, vcf._abs_pos, region=region)
    finally:
        set_options(prev_opts)

    os.makedirs(os.path.join(output_path, region.chr), exist_ok=True)
    dst = os.path.join(output_path, region.chr, f"{region.begin + 1:09d}-{region.end:09d}.vcf.gz")
    shutil.copyfile(out_tmp, dst)
    if os.path.exists(out_tmp + ".tbi"):
        shutil.copyfile(out_tmp + ".tbi", dst + ".tbi")
    shutil.rmtree(tmp, ignore_errors=True)
    return dst


def genotype_lr_regions(ref_path: str, sams: list[str], regions: list[str], output_path: str, **kw) -> list[str]:
    return [genotype_lr(ref_path, sams, r, output_path, **kw) for r in regions]
