"""Graph constructor: FASTA + VCF(+tabix) -> pangenome graph.

Reference semantics: src/graph/constructor.cpp construct_graph (:1597),
split_multi_allelic (:1033), add_var_record (:1208), GT_ID /
GT_ANTI_HAPLOTYPE event parsing (:1540-1589), prefix-extension
(genomic_region.cpp add_reference_to_record_if_they_have_a_matching_prefix).
SV record transformation lives in graph/build_sv.py.
"""

from __future__ import annotations

import numpy as np

from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.graph.coords import AbsolutePosition, GenomicRegion
from graphtyper_tpu_torch.graph.graph import Graph
from graphtyper_tpu_torch.graph.records import Allele, VarRecord
from graphtyper_tpu_torch.io.fasta import FastaFile
from graphtyper_tpu_torch.io.vcf_io import VcfReader, VcfTextRecord


def _prefix_match(seq1: bytes, seq2: bytes) -> bool:
    n = min(len(seq1), len(seq2))
    return seq1[:n] == seq2[:n]


def _has_matching_longest_prefix(ref: bytes, alts: list[Allele]) -> bool:
    """genomic_region.cpp:35-66 — true if ref prefixes an alt (or vice versa)
    or any two alts prefix-match (duplicates are an input error)."""
    for a in alts:
        if _prefix_match(ref, a.seq):
            return True
    for i in range(len(alts) - 1):
        for j in range(i + 1, len(alts)):
            if _prefix_match(alts[i].seq, alts[j].seq):
                if alts[i].seq == alts[j].seq:
                    raise ValueError("Duplicated alt alleles detected")
                return True
    return False


def extend_record_while_ambiguous(var: VarRecord, reference: bytes, region_begin: int) -> None:
    """Append reference bases while some allele is a prefix of another, so no
    alt-combination can spell the reference (genomic_region.cpp:239-258)."""
    if var.is_sv:
        return
    pos = var.pos - region_begin + len(var.ref.seq)
    while pos < len(reference) and reference[pos : pos + 1] != b"N" and _has_matching_longest_prefix(
        var.ref.seq, var.alts
    ):
        base = reference[pos : pos + 1]
        var.ref.seq += base
        for alt in var.alts:
            alt.seq += base
        pos += 1


def split_multi_allelic(rec: VcfTextRecord) -> list[VcfTextRecord]:
    """constructor.cpp:1033-1078."""
    if not rec.ref or not rec.alts:
        return []
    if len(rec.alts) == 1:
        return [rec]
    out = []
    for alt in rec.alts:
        if not alt or alt.startswith("."):
            continue
        out.append(
            VcfTextRecord(
                chrom=rec.chrom,
                pos=rec.pos,
                id=rec.id,
                ref=rec.ref,
                alts=[alt],
                qual=rec.qual,
                filter=rec.filter,
                info=rec.info,
            )
        )
    return out


def add_var_record(
    var_records: list[VarRecord],
    rec: VcfTextRecord,
    fasta: FastaFile,
    region: GenomicRegion,
    is_sv_graph: bool,
    graph: Graph | None = None,
) -> None:
    """Small-variant path of constructor.cpp add_var_record (:1208-1596);
    SV alleles are routed to build_sv.add_sv_record."""
    if not rec.ref or not rec.alts:
        return
    assert len(rec.alts) == 1
    alt = rec.alts[0]
    var = VarRecord(rec.pos)

    is_sv = len(alt) >= 5 and any(c in alt for c in "<[]")
    if is_sv:
        if not is_sv_graph:
            raise ValueError(f"Found an SV in a non-SV graph at {region.chr}:{rec.pos + 1}")
        from graphtyper_tpu_torch.graph.build_sv import add_sv_record

        add_sv_record(var_records, rec, var, fasta, region, graph=graph)
        return

    if any(c not in "ACGT" for c in alt):
        # non-ACGT alt ignored with a warning (constructor.cpp:1500-1512)
        from graphtyper_tpu_torch.utils.log import get_logger

        get_logger().warning(
            "Ignoring alt. allele %s at pos=%d. Non-ACGT base.", alt, rec.pos
        )
        return

    var.ref = Allele(rec.ref.encode())
    var.alts = [Allele(alt.encode())]

    # GT_ID / GT_ANTI_HAPLOTYPE events (constructor.cpp:1540-1589)
    info = rec.info_dict()
    if "GT_ID" in info and info["GT_ID"]:
        event_id = int(info["GT_ID"])
        assert event_id >= 1
        var.ref.events.add(-event_id)
        var.alts[0].events.add(event_id)
    if "GT_ANTI_HAPLOTYPE" in info and info["GT_ANTI_HAPLOTYPE"]:
        for val in info["GT_ANTI_HAPLOTYPE"].split(","):
            var.alts[0].anti_events.add(int(val))

    if var.alts:
        var_records.append(var)


def records_from_vcf_output(vcf_out, abs_pos) -> list:
    """In-memory handoff between pipeline iterations: the VcfTextRecords that
    writing `vcf_out` and reading the file back would produce (same sort,
    same record skips, same INFO text — construct_graph re-sorts and
    position-filters, so this is drop-in for VcfReader.read_region's
    superset). tests/pipeline/test_inmem_handoff.py asserts output parity
    against the file round-trip."""
    from graphtyper_tpu_torch.io.vcf_io import VcfTextRecord

    recs = []
    for var in sorted(vcf_out.variants, key=lambda v: (v.abs_pos, v.seqs)):
        # write-side skips (vcf_out.py format_record)
        if var.calls and len(var.seqs) > 80:
            continue
        if sum(len(s) for s in var.seqs) > 16000:
            continue
        chrom, pos = abs_pos.get_contig_position(var.abs_pos)
        info = (
            ";".join(
                f"{k}={var.infos[k]}" if var.infos[k] else k for k in sorted(var.infos)
            )
            or "."
        )
        recs.append(
            VcfTextRecord(
                chrom=chrom,
                pos=pos - 1,
                id=".",
                ref=var.seqs[0].decode(),
                alts=[s.decode() for s in var.seqs[1:]],
                info=info,
            )
        )
    return recs


def construct_graph(
    reference_filename: str,
    vcf_filename: str,
    region_str: str,
    is_sv_graph: bool = False,
    use_index: bool = True,
    add_all_variants: bool = False,
    records: list | None = None,
) -> Graph:
    """constructor.cpp construct_graph (:1597-1772). Returns the graph (no
    global mutable state, unlike the reference's gyper::graph singleton).

    `records` (optional, from records_from_vcf_output) skips the VCF file
    read-back when the previous iteration's sites are still in memory."""
    graph = Graph()
    graph.is_sv_graph = is_sv_graph
    region = GenomicRegion.parse(region_str)

    fasta = FastaFile(reference_filename)
    graph.contigs = list(fasta.contigs)
    abs_pos = AbsolutePosition(graph.contigs)
    graph.abs_pos = abs_pos

    # clamp open-ended region to contig length
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    reference_sequence = fasta.fetch(region.chr, region.begin, region.end)
    if not reference_sequence:
        raise ValueError(f"Failed reading region {region_str} from {reference_filename}")
    _ref_arr = np.frombuffer(reference_sequence, dtype=np.uint8)
    if ((_ref_arr < ord("A")) | (_ref_arr > ord("Z"))).any():
        raise ValueError("Non-uppercase character in input FASTA reference")

    var_records: list[VarRecord] = []
    if vcf_filename or records is not None:
        if records is not None:
            recs = [r for r in records if r.chrom == region.chr]
        else:
            reader = VcfReader(vcf_filename)
            recs = reader.read_region(region.chr, region.begin, region.end)
        for rec in recs:
            if rec.pos >= region.begin and rec.pos + len(rec.ref) <= region.end:
                for split in split_multi_allelic(rec):
                    if is_sv_graph:
                        from graphtyper_tpu_torch.graph.build_sv import transform_sv_record

                        ok = transform_sv_record(split, fasta, region)
                        if ok:
                            add_var_record(var_records, split, fasta, region, is_sv_graph, graph)
                    else:
                        add_var_record(var_records, split, fasta, region, is_sv_graph, graph)
        for var in var_records:
            extend_record_while_ambiguous(var, reference_sequence, region.begin)

    if is_sv_graph:
        # one SV per breakpoint allele: an insertion or duplication with two
        # breakpoints counts two
        counters.add("sv_alleles", len(graph.svs))
    var_records.sort(key=lambda v: v.pos)
    graph.add_genomic_region(reference_sequence, var_records, region, add_all_variants)
    if not graph.check():
        raise ValueError("Problem creating graph")
    graph.create_special_positions()
    fasta.close()
    return graph
