"""File-level VCF tools: parse records (with genotypes) back into Variant
objects, break down, merge across files.

Reference semantics: vcf.cpp Vcf::read (the reference has its own VCF text
parser for these subcommands) + vcf_operations.cpp vcf_break_down (:902),
vcf_merge (:143).
"""

from __future__ import annotations

import numpy as np

from graphtyper_tpu_torch.graph.coords import AbsolutePosition, Contig, GenomicRegion
from graphtyper_tpu_torch.io.vcf_io import VcfReader
from graphtyper_tpu_torch.typer.sample_call import SampleCall
from graphtyper_tpu_torch.typer.variant import Variant, break_down_variant
from graphtyper_tpu_torch.typer.vcf_out import VcfOutput


def _parse_contigs_from_header(header_lines: list[str]) -> list[Contig]:
    contigs = []
    for line in header_lines:
        if line.startswith("##contig="):
            body = line[len("##contig=<") :].rstrip(">")
            kv = dict(p.split("=", 1) for p in body.split(",") if "=" in p)
            if "ID" in kv:
                contigs.append(Contig(kv["ID"], int(kv.get("length", "0"))))
    return contigs


def read_vcf_with_calls(path: str) -> tuple[VcfOutput, list[Contig]]:
    reader = VcfReader(path)
    recs = reader.read_all()
    contigs = _parse_contigs_from_header(reader.header_lines)
    abs_pos = AbsolutePosition(contigs) if contigs else None
    out = VcfOutput(sample_names=list(reader.sample_names))
    for rec in recs:
        var = Variant()
        if abs_pos is not None and abs_pos.is_contig_available(rec.chrom):
            var.abs_pos = abs_pos.get_absolute_position(rec.chrom, rec.pos + 1)
        else:
            var.abs_pos = rec.pos + 1
        var.seqs = [rec.ref.encode()] + [a.encode() for a in rec.alts]
        var.infos = rec.info_dict()
        fmt = rec.format.split(":") if rec.format else []
        for sample in rec.samples:
            vals = dict(zip(fmt, sample.split(":")))
            cnum = len(var.seqs)
            phred = np.zeros(cnum * (cnum + 1) // 2, dtype=np.int64)
            if "PL" in vals and vals["PL"] not in (".", ""):
                pl = [int(x) for x in vals["PL"].split(",")]
                phred[: len(pl)] = pl
            cov = np.zeros(cnum, dtype=np.int64)
            if "AD" in vals and vals["AD"] not in (".", ""):
                ad = [int(x) for x in vals["AD"].split(",")]
                cov[: len(ad)] = ad
            call = SampleCall(phred=phred, coverage=cov)
            if "MD" in vals and vals["MD"] not in (".", ""):
                call.ambiguous_depth = int(vals["MD"])
            var.calls.append(call)
        out.variants.append(var)
    return out, contigs


class _RefProxy:
    """Minimal graph stand-in for Variant normalization when only a VCF +
    contigs are available (no reference bases -> add_base_in_front fails
    gracefully and normalization stops)."""

    def __init__(self, contigs):
        self.contigs = contigs
        self.reference = b""
        self.genomic_region = GenomicRegion()
        self.is_sv_graph = False
        self.abs_pos = AbsolutePosition(contigs)


def vcf_break_down_file(graph_path: str, vcf_path: str, output_path: str, region: str = ".") -> None:
    """The vcf_break_down subcommand (main.cpp:1404, vcf_operations.cpp:902)."""
    from graphtyper_tpu_torch.graph.graph import Graph

    graph = Graph.load(graph_path) if graph_path and graph_path != "-" else None
    vcf, contigs = read_vcf_with_calls(vcf_path)
    ref = graph if graph is not None else _RefProxy(contigs)
    out = VcfOutput(sample_names=vcf.sample_names)
    # vcf_operations.cpp:963-964: the standalone tool reads the globals
    from graphtyper_tpu_torch.config import current_options

    _o = current_options()
    for var in vcf.variants:
        for nv in break_down_variant(
            var, ref,
            is_no_variant_overlapping=_o.no_variant_overlapping,
            is_all_biallelic=_o.is_all_biallelic,
        ):
            nv.normalize(ref)
            nv.generate_infos(ref)
            out.variants.append(nv)
    reg = GenomicRegion.parse(region)
    out.write(
        output_path,
        contigs if graph is None else graph.contigs,
        ref.abs_pos,
        region=reg if reg.chr != "N/A" else None,
    )


def vcf_merge_files(vcf_paths: list[str], output_path: str) -> None:
    """The vcf_merge subcommand: concatenate per-pool sample columns."""
    merged: VcfOutput | None = None
    contigs = None
    for path in vcf_paths:
        vcf, c = read_vcf_with_calls(path)
        if merged is None:
            merged, contigs = vcf, c
        else:
            merged.sample_names.extend(vcf.sample_names)
            for var, ovar in zip(merged.variants, vcf.variants):
                var.calls.extend(ovar.calls)
    if merged is None:
        return
    ref = _RefProxy(contigs)
    for var in merged.variants:
        var.infos = {}
        var.generate_infos(ref)
    merged.write(output_path, contigs, ref.abs_pos)


def vcf_update_info(vcf_path: str, output_path: str) -> None:
    """Re-generate INFO fields of a VCF with calls and rewrite it
    (vcf_operations.cpp vcf_update_info:1027-1080)."""
    vcf, contigs = read_vcf_with_calls(vcf_path)
    ref = _RefProxy(contigs)
    out = VcfOutput(sample_names=vcf.sample_names)
    for var in vcf.variants:
        var.scan_calls()
        if vcf.sample_names:
            var.generate_infos(ref)
        out.variants.append(var)
    out.write(output_path, contigs, ref.abs_pos)
