"""SV record transformation and breakpoint-graph construction.

Reference semantics: src/graph/constructor.cpp — transform_sv_records
(:1079-1206), add_var_record SV path (:1263-1495), add_sv_breakend (:312),
add_sv_deletion (:478), add_sv_insertion (:515), add_sv_duplication (:727),
add_sv_inversion (:873). Breakpoint alternative alleles get an
`<SV:NNNNNNN>` tag appended (:155-161) which the caller later parses back
(sv.cpp reformat) to associate calls with SV models.
"""

from __future__ import annotations

import numpy as np

from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.graph.records import Allele, VarRecord
from graphtyper_tpu_torch.graph.sv import SV, SVType, parse_sv_type
from graphtyper_tpu_torch.io.fasta import FastaFile
from graphtyper_tpu_torch.io.vcf_io import VcfTextRecord
from graphtyper_tpu_torch.utils.dna import revcomp_ascii

EXTRA_SEQUENCE_LENGTH = 152

_COMPL = bytes.maketrans(b"ACGTN", b"TGCAN")


def _complement(seq: bytes) -> bytes:
    return seq.translate(_COMPL)


def _sv_tag(n_svs: int) -> bytes:
    return f"<SV:{n_svs:07d}>".encode()


def _read_ref(fasta: FastaFile, chrom: str, begin: int, length: int) -> bytes:
    """0-based begin, clamped to contig bounds."""
    return fasta.fetch(chrom, begin, begin + length)


def _read_ref_ends(fasta: FastaFile, chrom: str, begin: int, end: int, length: int) -> bytes:
    """constructor.cpp read_reference_genome_ends (:266-287)."""
    if end - begin > 2 * length:
        return _read_ref(fasta, chrom, begin, length) + _read_ref(fasta, chrom, end - length, length)
    return fasta.fetch(chrom, begin, end)


def _is_similar(seq1: bytes, seq2: bytes) -> bool:
    """Global-alignment similarity >= 0.8 (constructor.cpp:1360-1400);
    score(match)=1, mismatch/gap=-1, first 1000bp only."""
    max_size = 1000
    if len(seq1) > max_size and len(seq2) > max_size:
        seq1, seq2 = seq1[:max_size], seq2[:max_size]
    n, m = len(seq1), len(seq2)
    if n == 0 or m == 0:
        return False
    a = np.frombuffer(seq1, dtype=np.uint8)
    b = np.frombuffer(seq2, dtype=np.uint8)
    idx = np.arange(1, m + 1, dtype=np.int32)
    prev = -np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int32)
        cur[0] = -i
        # candidates not depending on cur: diagonal and gap-in-a
        best = np.maximum(prev[:-1] + np.where(b == a[i - 1], 1, -1).astype(np.int32), prev[1:] - 1)
        # cur[j] = max(best[j], cur[j-1] - 1) resolved as a prefix-max scan:
        # cur[j] = max(max_{k<=j}(best[k] + k) - j, cur[0] - j)
        run = np.maximum.accumulate(best + idx)
        cur[1:] = np.maximum(run - idx, cur[0] - idx)
        prev = cur
    score = int(prev[m])
    return score / max(n, m) >= 0.8


def transform_sv_record(rec: VcfTextRecord, fasta: FastaFile, region: GenomicRegion) -> bool:
    """Turn a large explicit-sequence indel into a symbolic <DEL>/<INS>
    (constructor.cpp:1079-1206). Mutates rec in place."""
    if not rec.alts or not rec.alts[0]:
        return False
    if rec.pos == 0:
        return True
    alt = rec.alts[0]
    if any(c in alt for c in "<[]"):
        return True  # already symbolic
    size_diff = len(alt) - len(rec.ref)
    if size_diff <= -50:  # DEL
        if rec.ref[0] != alt[0]:
            rec.pos -= 1
            base = _read_ref(fasta, region.chr, rec.pos, 1).decode()
            rec.alts = [base + alt]
            rec.ref = base
            alt = rec.alts[0]
        seq = alt[1:] if len(alt) > 1 else ""
        extra = [] if rec.info in (".", "") else [rec.info]
        info = ";".join(
            extra
            + [
                f"SVTYPE=DEL;SVLEN={-size_diff};SVSIZE={-size_diff};END={len(seq) + rec.pos + 1 - size_diff}"
                + (f";SEQ={seq}" if seq else "")
            ]
        )
        rec.info = info
        rec.ref = rec.ref[0]
        rec.alts = ["<DEL>"]
    elif size_diff >= 50:  # INS
        if rec.ref[0] != alt[0]:
            rec.pos -= 1
            base = _read_ref(fasta, region.chr, rec.pos, 1).decode()
            rec.ref = base + rec.ref
            seq = alt
        else:
            seq = alt[1:]
        sep = "" if (rec.info in (".", "") or rec.info.endswith(";")) else ";"
        prefix = "" if rec.info in (".", "") else rec.info
        rec.info = f"{prefix}{sep}SVTYPE=INS;SVLEN={size_diff};SVSIZE={size_diff};SEQ={seq}"
        rec.alts = ["<INS>"]
    return True


def add_sv_record(
    var_records: list[VarRecord],
    rec: VcfTextRecord,
    var: VarRecord,
    fasta: FastaFile,
    region: GenomicRegion,
    graph=None,
) -> None:
    """SV branch of add_var_record (constructor.cpp:1263-1495): parse the SV
    INFO, then build breakpoint alt alleles. `graph` holds the SV list."""
    from graphtyper_tpu_torch.graph.graph import Graph  # typing only

    assert graph is not None
    chrom = region.chr

    # Replace N reference base
    if rec.ref == "N":
        var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))
    else:
        var.ref = Allele(rec.ref.encode())

    sv = SV()
    sv.begin = var.pos + 1
    sv.chrom = chrom
    if rec.id and rec.id != ".":
        sv.old_variant_id = rec.id

    info = rec.info_dict()
    is_a_dup = "DUPSVLEN" in info
    if "SVTYPE" in info:
        sv.type = parse_sv_type(info["SVTYPE"])
    for key, attr in (
        ("END", "end"),
        ("SVSIZE", "size"),
        ("SVLEN", "length"),
        ("NCLUSTERS", "n_clusters"),
        ("ORSTART", "or_start"),
        ("OREND", "or_end"),
        ("NUM_MERGED_SVS", "num_merged_svs"),
    ):
        if key in info and info[key]:
            try:
                setattr(sv, attr, int(float(info[key])))
            except ValueError:
                pass
    for key, attr in (
        ("SEQ", "seq"),
        ("SVINSSEQ", "ins_seq"),
        ("LEFT_SVINSSEQ", "ins_seq_left"),
        ("RIGHT_SVINSSEQ", "ins_seq_right"),
        ("DUPSVINSSEQ", "ins_seq"),
    ):
        if key in info and info[key]:
            setattr(sv, attr, info[key].encode())
    if "INV3" in info:
        sv.inv_type = "INV3"
    if "INV5" in info:
        sv.inv_type = "INV5"

    if sv.type == SVType.NOT_SV:
        raise ValueError(f"SV with no SVTYPE at pos {var.pos}")
    if sv.type == SVType.INS and is_a_dup:
        sv.type = SVType.DUP
    if sv.length < 0:
        sv.length = -sv.length
    if sv.type != SVType.BND and sv.length == 0:
        sv.length = sv.size or len(sv.seq) or len(sv.ins_seq)
    if sv.size == 0:
        sv.size = sv.length
    if sv.end == 0:
        sv.end = sv.begin + sv.size

    # INS that matches flanking reference becomes DUP (constructor.cpp:1356-1432)
    if sv.type == SVType.INS and sv.seq:
        if var.pos - 1 - len(sv.seq) >= 0:
            ref_before = _read_ref(fasta, chrom, var.pos - 1 - len(sv.seq), len(sv.seq))
            if len(ref_before) == len(sv.seq) and _is_similar(ref_before, sv.seq):
                var.pos -= len(sv.seq)
                sv.type = SVType.DUP
        if sv.type == SVType.INS:
            ref_after = _read_ref(fasta, chrom, var.pos + 1, len(sv.seq))
            if _is_similar(ref_after, sv.seq):
                sv.type = SVType.DUP

    var.is_sv = True
    if sv.type == SVType.BND:
        _add_sv_breakend(graph, sv, var, rec, fasta, chrom)
    elif sv.type in (SVType.DEL, SVType.DEL_ALU):
        _add_sv_deletion(graph, sv, var, fasta, chrom)
    elif sv.type == SVType.DUP:
        _add_sv_duplication(graph, var_records, sv, var, fasta, chrom)
    elif sv.type == SVType.INS:
        _add_sv_insertion(graph, sv, var, rec, fasta, chrom)
    elif sv.type == SVType.INV:
        _add_sv_inversion(graph, var_records, sv, var, fasta, chrom)
    else:
        return  # skip OTHER / INS:ME:ALU (constructor.cpp:1490-1493)

    if var.alts:
        var_records.append(var)


def _add_sv_breakend(graph, sv: SV, var: VarRecord, rec: VcfTextRecord, fasta: FastaFile, chrom: str) -> None:
    var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))
    alt = rec.alts[0]
    sv.original_alt = alt.encode()
    E = EXTRA_SEQUENCE_LENGTH

    def parse_mate(c: str) -> tuple[str, int]:
        bracket = alt.index(c)
        last_colon = alt.rindex(":")
        mate_chrom = alt[bracket + 1 : last_colon]
        end = alt.index(c, last_colon)
        return mate_chrom, int(alt[last_colon + 1 : end])

    if "[" in alt:
        mate_chrom, pos = parse_mate("[")
        first = alt.index("[")
        if first != 0:
            # Case 1: S SNNN[chr:pos[ -> extend right of mate
            bnd = var.ref.seq + alt[1:first].encode()
            bnd += _read_ref(fasta, mate_chrom, pos, E - len(bnd) + 1)
            bnd += _sv_tag(len(graph.svs))
        else:
            # Case 2: [chr:pos[NNNS -> reversed complement left of mate
            bnd = _sv_tag(len(graph.svs))
            second = alt.index("[", 1)
            ln = E - (len(alt) - second)
            seq = _read_ref(fasta, mate_chrom, pos - 1, ln)
            bnd += _complement(seq)[::-1]
            bnd += alt[second + 1 :].encode()
    else:
        mate_chrom, pos = parse_mate("]")
        first = alt.index("]")
        if first == 0:
            # Case 3: ]chr:pos]NNS -> sequence left of mate, then suffix
            bnd = _sv_tag(len(graph.svs))
            second = alt.index("]", 1)
            ln = E - (len(alt) - second) - 1
            bnd += _read_ref(fasta, mate_chrom, pos - ln, ln)
            bnd += alt[second + 1 :].encode()
        else:
            # Case 4: SNN]chr:pos] -> revcomp of mate appended right
            bnd = var.ref.seq + alt[1:first].encode()
            ln = E - len(bnd) + 1
            seq = _read_ref(fasta, mate_chrom, pos - ln, ln)
            bnd += _complement(seq)[::-1]
            bnd += _sv_tag(len(graph.svs))

    var.alts.append(Allele(bnd))
    graph.svs.append(sv)


def _add_sv_deletion(graph, sv: SV, var: VarRecord, fasta: FastaFile, chrom: str) -> None:
    var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))
    alt1 = bytearray(var.ref.seq)
    if sv.seq and not sv.seq.startswith(b"."):
        alt1 += sv.seq
    elif sv.ins_seq and not sv.ins_seq.startswith(b"."):
        alt1 += sv.ins_seq
    E = EXTRA_SEQUENCE_LENGTH
    if len(alt1) < E + 1:
        alt1 += _read_ref(fasta, chrom, var.pos + len(sv.seq) + sv.size + 1, E + 1 - len(alt1))
    alt1 += _sv_tag(len(graph.svs))
    var.alts.append(Allele(bytes(alt1)))
    sv.model = "BREAKPOINT"
    graph.svs.append(sv)


def _add_sv_insertion(graph, sv: SV, var: VarRecord, rec: VcfTextRecord, fasta: FastaFile, chrom: str) -> None:
    E = EXTRA_SEQUENCE_LENGTH
    if rec.ref[0] != "N":
        var.ref = Allele(rec.ref.encode())
    else:
        var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))

    if sv.seq:
        base = _read_ref(fasta, chrom, var.pos, 1)
        alt1 = bytearray(base)
        alt2 = bytearray(base)
        if len(sv.seq) >= E:
            alt1 += sv.seq[:E]
            alt1 += _sv_tag(len(graph.svs))
            sv1 = _copy_sv(sv)
            sv1.related_sv = len(graph.svs) + 1
            sv1.model = "BREAKPOINT1"
            graph.svs.append(sv1)
            alt2 += _sv_tag(len(graph.svs))
            alt2 += sv.seq[-E:]
            sv2 = _copy_sv(sv)
            sv2.related_sv = len(graph.svs) - 1
            sv2.model = "BREAKPOINT2"
            graph.svs.append(sv2)
        else:
            padding = E - len(sv.seq)
            alt1 += sv.seq
            alt1 += _read_ref(fasta, chrom, var.pos + 1, padding)
            alt1 += _sv_tag(len(graph.svs))
            sv1 = _copy_sv(sv)
            sv1.related_sv = len(graph.svs) + 1
            sv1.model = "BREAKPOINT1"
            graph.svs.append(sv1)
            alt2 += _sv_tag(len(graph.svs))
            alt2 += _read_ref(fasta, chrom, var.pos - padding, padding + 1)
            alt2 += sv.seq
            sv2 = _copy_sv(sv)
            sv2.related_sv = len(graph.svs) - 1
            sv2.model = "BREAKPOINT2"
            graph.svs.append(sv2)
        var.alts.append(Allele(bytes(alt1)))
        var.alts.append(Allele(bytes(alt2)))
    elif sv.or_start != -1 and sv.or_end != -1:
        base = _read_ref(fasta, chrom, var.pos, 1)
        alt1 = bytearray(base)
        alt2 = bytearray()
        ins = _read_ref_ends(fasta, chrom, sv.or_start - 1, sv.or_end, E)
        if len(ins) >= E:
            alt1 += ins[:E]
            alt1 += _sv_tag(len(graph.svs))
            sv1 = _copy_sv(sv)
            sv1.related_sv = len(graph.svs) + 1
            sv1.model = "BREAKPOINT1"
            graph.svs.append(sv1)
            alt2 += _sv_tag(len(graph.svs))
            alt2 += ins[-E:]
            sv2 = _copy_sv(sv)
            sv2.related_sv = len(graph.svs) - 1
            sv2.model = "BREAKPOINT2"
            graph.svs.append(sv2)
        else:
            padding = E - len(ins)
            alt1 += ins
            alt1 += _read_ref(fasta, chrom, var.pos + 1, padding)
            alt1 += _sv_tag(len(graph.svs))
            sv1 = _copy_sv(sv)
            sv1.related_sv = len(graph.svs) + 1
            sv1.model = "BREAKPOINT1"
            graph.svs.append(sv1)
            padding = min(padding, var.pos)
            alt2 += _sv_tag(len(graph.svs))
            alt2 += _read_ref(fasta, chrom, var.pos - padding, padding)
            alt2 += ins
            sv2 = _copy_sv(sv)
            sv2.related_sv = len(graph.svs) - 1
            sv2.model = "BREAKPOINT2"
            graph.svs.append(sv2)
        var.alts.append(Allele(bytes(alt1)))
        var.alts.append(Allele(bytes(alt2)))
    elif sv.ins_seq_left or sv.ins_seq_right:
        left = sv.ins_seq_left[:E]
        right = sv.ins_seq_right[:E]
        if len(left) > 1 and len(right) > 0:
            alt1 = var.ref.seq + left + _sv_tag(len(graph.svs))
            sv1 = _copy_sv(sv)
            sv1.model = "BREAKPOINT1"
            sv1.related_sv = len(graph.svs) + 1
            graph.svs.append(sv1)
            var.alts.append(Allele(alt1))
            alt2 = _sv_tag(len(graph.svs)) + right
            sv2 = _copy_sv(sv)
            sv2.model = "BREAKPOINT2"
            sv2.related_sv = len(graph.svs) - 1
            graph.svs.append(sv2)
            var.alts.append(Allele(alt2))
        elif len(left) > 1:
            alt1 = var.ref.seq + left + _sv_tag(len(graph.svs))
            sv.model = "BREAKPOINT1"
            graph.svs.append(sv)
            var.alts.append(Allele(alt1))
        elif len(right) > 0:
            alt2 = _sv_tag(len(graph.svs)) + right
            sv.model = "BREAKPOINT2"
            graph.svs.append(sv)
            var.alts.append(Allele(alt2))
    # else: unknown insertion form — skipped with warning in reference


def _copy_sv(sv: SV) -> SV:
    return SV.from_dict(sv.to_dict())


def _add_sv_duplication(graph, var_records: list[VarRecord], sv: SV, var: VarRecord, fasta: FastaFile, chrom: str) -> None:
    E = EXTRA_SEQUENCE_LENGTH
    var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))
    if sv.or_end == -1:
        if sv.or_start == -1:
            # Case 1: tandem duplication, both breakpoints known
            dup = _read_ref_ends(fasta, chrom, var.pos + 1, var.pos + sv.length + 1, E)
            var2 = VarRecord(var.pos, Allele(var.ref.seq), [])
            var2.is_sv = True
            var.pos += sv.length
            var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))
            dup_begin = bytearray(var.ref.seq)
            dup_begin += sv.ins_seq
            dup_end = bytearray()
            if len(dup) >= E:
                dup_begin += dup[:E]
                dup_begin += _sv_tag(len(graph.svs))
                sv1 = _copy_sv(sv)
                sv1.related_sv = len(graph.svs) + 1
                sv1.model = "BREAKPOINT1"
                graph.svs.append(sv1)
                dup_end += _sv_tag(len(graph.svs))
                dup_end += dup[-E:]
                dup_end += sv.ins_seq
                sv2 = _copy_sv(sv)
                sv2.related_sv = len(graph.svs) - 1
                sv2.model = "BREAKPOINT2"
                graph.svs.append(sv2)
            else:
                padding = E - len(dup)
                dup_begin += dup
                dup_begin += _read_ref(fasta, chrom, var.pos + 1, padding)
                dup_begin += _sv_tag(len(graph.svs))
                sv1 = _copy_sv(sv)
                sv1.model = "BREAKPOINT1"
                sv1.related_sv = len(graph.svs) + 1
                graph.svs.append(sv1)
                padding = min(padding, var2.pos)
                dup_end += _sv_tag(len(graph.svs))
                dup_end += _read_ref(fasta, chrom, var2.pos - padding + 1, padding)
                dup_end += dup
                sv2 = _copy_sv(sv)
                sv2.related_sv = len(graph.svs) - 1
                sv2.model = "BREAKPOINT2"
                graph.svs.append(sv2)
            var.alts.append(Allele(bytes(dup_begin)))
            var2.alts.append(Allele(bytes(dup_end)))
            var_records.append(var2)
        else:
            # Case 2: ORSTART only
            dup_begin = bytearray(var.ref.seq)
            dup_begin += sv.ins_seq
            dup_begin += _read_ref(fasta, chrom, sv.or_start - 1, E)
            dup_begin += _sv_tag(len(graph.svs))
            sv.model = "BREAKPOINT1"
            var.alts.append(Allele(bytes(dup_begin)))
            graph.svs.append(sv)
    else:
        # Case 3: OREND only
        start_reading_at = max(E, sv.or_end)
        dup_begin = bytearray(_sv_tag(len(graph.svs)))
        dup_begin += _read_ref(fasta, chrom, start_reading_at - E, E)
        dup_begin += sv.ins_seq
        var.alts.append(Allele(bytes(dup_begin)))
        sv.model = "BREAKPOINT2"
        graph.svs.append(sv)


def _add_sv_inversion(graph, var_records: list[VarRecord], sv: SV, var: VarRecord, fasta: FastaFile, chrom: str) -> None:
    E = EXTRA_SEQUENCE_LENGTH
    var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))
    if sv.inv_type == "INV3":
        sv.or_end = sv.end
    elif sv.inv_type == "INV5":
        sv.or_start = sv.begin
        sv.begin += sv.size
        var.pos += sv.size
        var.ref = Allele(_read_ref(fasta, chrom, var.pos, 1))

    if sv.or_end == -1:
        if sv.or_start == -1:
            # Case 1: tandem inversion
            dup = _read_ref_ends(fasta, chrom, var.pos + 1, var.pos + sv.length + 1, E)
            inv = _complement(dup)[::-1]
            inv_begin = bytearray(var.ref.seq)
            inv_begin += sv.ins_seq
            var2 = VarRecord(var.pos + sv.length, Allele(_read_ref(fasta, chrom, var.pos + sv.length, 1)), [])
            var2.is_sv = True
            inv_end = bytearray()
            if len(inv) >= E:
                inv_begin += inv[:E]
                inv_begin += _sv_tag(len(graph.svs))
                sv1 = _copy_sv(sv)
                sv1.related_sv = len(graph.svs) + 1
                sv1.model = "BREAKPOINT1"
                graph.svs.append(sv1)
                inv_end += _sv_tag(len(graph.svs))
                inv_end += inv[-E:]
                inv_end += sv.ins_seq
                sv2 = _copy_sv(sv)
                sv2.related_sv = len(graph.svs) - 1
                sv2.model = "BREAKPOINT2"
                graph.svs.append(sv2)
            else:
                padding = E - len(inv)
                inv_begin += inv
                inv_begin += _read_ref(fasta, chrom, var.pos + 1, padding)
                inv_begin += _sv_tag(len(graph.svs))
                sv1 = _copy_sv(sv)
                sv1.model = "BREAKPOINT1"
                sv1.related_sv = len(graph.svs) + 1
                graph.svs.append(sv1)
                padding = min(padding, var2.pos)
                inv_end += _sv_tag(len(graph.svs))
                inv_end += _read_ref(fasta, chrom, var2.pos - padding + 1, padding)
                inv_end += inv
                inv_end += sv.ins_seq
                sv2 = _copy_sv(sv)
                sv2.related_sv = len(graph.svs) - 1
                sv2.model = "BREAKPOINT2"
                graph.svs.append(sv2)
            var.alts.append(Allele(bytes(inv_begin)))
            var2.alts.append(Allele(bytes(inv_end)))
            var_records.append(var2)
        else:
            # Case 2: ORSTART only — reversed complement of [or_start, +E)
            dup = _read_ref(fasta, chrom, sv.or_start - 1, E)
            inv = _sv_tag(len(graph.svs)) + _complement(dup)[::-1] + sv.ins_seq
            sv.model = "BREAKPOINT2"
            var.alts.append(Allele(inv))
            graph.svs.append(sv)
    else:
        # Case 3: OREND only — complement of [or_end-E, or_end) reversed
        start_reading_at = max(E, sv.or_end)
        dup = _read_ref(fasta, chrom, start_reading_at - E, E)
        inv = var.ref.seq + sv.ins_seq + _complement(dup)[::-1] + _sv_tag(len(graph.svs))
        sv.model = "BREAKPOINT1"
        var.alts.append(Allele(inv))
        graph.svs.append(sv)
