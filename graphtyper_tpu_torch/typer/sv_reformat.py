"""SV call aggregation: parse `<SV:NNNNNNN>` tags out of called alleles,
split each SV into a biallelic record relocated to its origin, combine
breakpoint models by best GQ, and add coverage-model calls.

Reference semantics: src/graph/sv.cpp — reformat_sv_vcf_records (:117-500),
make_new_sv_var (:179-224), make_variant_with_combined_calls (:226-280),
SV allele naming get_allele/get_allele_with_model (:51-81);
src/typer/sample_call.cpp make_call_based_on_coverage (:230-389).
"""

from __future__ import annotations


import numpy as np

from graphtyper_tpu_torch.graph.sv import SV, SVType
from graphtyper_tpu_torch.models.genotype_model import VarStats, to_index
from graphtyper_tpu_torch.typer.sample_call import SampleCall
from graphtyper_tpu_torch.typer.variant import Variant, _update_per_allele_stats


def _sv_get_type(sv: SV) -> str:
    return {
        SVType.DEL: "DEL",
        SVType.DEL_ALU: "DEL:ME:ALU",
        SVType.DUP: "DUP",
        SVType.INS: "INS",
        SVType.INS_ALU: "INS:ME:ALU",
        SVType.INV: "INV",
        SVType.BND: "BND",
    }.get(sv.type, "SV")


def _sv_get_allele(sv: SV) -> bytes:
    size = str(sv.size) if sv.size > 0 else f"{len(sv.ins_seq_left) + len(sv.ins_seq_right)}+"
    return f"<{_sv_get_type(sv)}:SVSIZE={size}>".encode()


def _median(vals: list[int]) -> int:
    if not vals:
        return 0
    vals = sorted(vals)
    return vals[len(vals) // 2]


def make_call_based_on_coverage(pn_index: int, sv: SV, reference_depth, graph) -> SampleCall:
    """sample_call.cpp:230-389 (DEL/DUP/INV coverage model)."""
    begin = sv.begin  # contig-local 1-based
    end = begin + min(sv.size, 190000)
    N = 101
    M = 20
    depths_in: list[int] = []
    depths_out: list[int] = []
    size = end - begin
    n_in = min(N, size - 2 * M)
    if n_in % 2 == 0:
        n_in -= 1
    for i in range(1, max(n_in, 0) + 1):
        pos = (i * (size - 2 * M)) // (n_in + 1) + begin + M
        depths_in.append(reference_depth.get_read_depth(pos, pn_index))
    for i in range(1, N // 2 + 2):
        depths_out.append(reference_depth.get_read_depth(max(begin - i * M, 0), pn_index))
    if sv.size < 190000:
        for i in range(1, N // 2 + 1):
            depths_out.append(reference_depth.get_read_depth(max(end + i * M, 0), pn_index))

    median_out = _median(depths_out)
    median_in = _median(depths_in)
    ERROR = 12
    cov = [0, 0]
    if sv.type in (SVType.DEL, SVType.DEL_ALU):
        cov[0] = max(0, min(0xFFFF, median_in))
        cov[1] = max(0, min(0xFFFF, median_out - median_in))
    elif sv.type in (SVType.DUP, SVType.INV):
        cmed = (median_out + median_in) / 2.0
        dmed = median_in - median_out
        if dmed <= 0:
            cov[0] = max(0, min(0xFFFF, round(cmed)))
            cov[1] = 0
        elif dmed >= 2 * median_in:
            cov[0] = 0
            cov[1] = max(0, min(0xFFFF, round(cmed)))
        else:
            frac = dmed / median_out if median_out else 0.0
            cov[0] = max(0, min(0xFFFF, round((1.0 - frac) * cmed)))
            cov[1] = max(0, min(0xFFFF, round(cmed) - cov[0]))

    gt_00 = cov[1] * ERROR
    gt_01 = 3 * (cov[0] + cov[1])
    gt_11 = cov[0] * ERROR
    min_gt = min(gt_00, gt_01, gt_11)
    gt_00, gt_01, gt_11 = gt_00 - min_gt, gt_01 - min_gt, gt_11 - min_gt
    if sv.size <= 100:
        gt_00, gt_01, gt_11 = (gt_00 * 2) // 3, (gt_01 * 2) // 3, (gt_11 * 2) // 3
    elif sv.size > 10000:
        gt_00, gt_01, gt_11 = gt_00 * 2, gt_01 * 2, gt_11 * 2
    elif sv.size > 1000:
        gt_00, gt_01, gt_11 = (gt_00 * 3) // 2, (gt_01 * 3) // 2, (gt_11 * 3) // 2
    call = SampleCall(
        phred=np.array([min(255, gt_00), min(255, gt_01), min(255, gt_11)], dtype=np.int64),
        coverage=np.array(cov, dtype=np.int64),
    )
    return call


def _make_new_sv_var(old_var: Variant, aa: int, sv: SV, sv_id: int, graph) -> Variant:
    nv = Variant()
    nv.seqs = [old_var.seqs[0], old_var.seqs[aa + 1]]
    nv.infos = dict(old_var.infos)
    nv.stats = VarStats.sized(2)
    if len(old_var.stats.per_allele) > aa + 1:
        nv.stats.per_allele[0] = old_var.stats.per_allele[0]
        nv.stats.per_allele[1] = old_var.stats.per_allele[aa + 1]
        nv.stats.read_strand[0] = old_var.stats.read_strand[0]
        nv.stats.read_strand[1] = old_var.stats.read_strand[aa + 1]
    for call in old_var.calls:
        nv.calls.append(call.make_bi_allelic(aa + 1))
    if sv.n_clusters > 0:
        nv.infos["NCLUSTERS"] = str(sv.n_clusters)
    if sv.num_merged_svs > 0:
        nv.infos["NUM_MERGED_SVS"] = str(sv.num_merged_svs)
    nv.infos["SV_ID"] = str(sv_id)
    if sv.related_sv >= 0:
        nv.infos["RELATED_SV_ID"] = str(sv.related_sv)
    nv.abs_pos = graph.abs_pos.get_absolute_position(sv.chrom, sv.begin)
    return nv


def _combine_calls(var1: Variant, var2: Variant) -> Variant:
    """make_variant_with_combined_calls (sv.cpp:226-280)."""
    import copy

    combined = copy.deepcopy(var1)
    for i in range(len(var1.calls)):
        cc = combined.calls[i]
        c2 = var2.calls[i]
        gt2 = c2.get_gt_call()
        gt1 = cc.get_gt_call()
        gq1 = c2.get_gq()
        gq2 = cc.get_gq()
        max_gq = gq1
        min_gq = gq2
        dp1 = cc.get_unique_depth()
        if gq1 > gq2:
            combined.calls[i] = copy.deepcopy(c2)
            cc = combined.calls[i]
            max_gq = gq1
            min_gq = gq2
        if var1.calls[i].filter > 0 and var2.calls[i].filter > 0:
            cc.filter = 3
        elif var1.calls[i].filter > 0:
            cc.filter = var1.calls[i].filter
        elif var2.calls[i].filter > 0:
            cc.filter = var2.calls[i].filter
        elif dp1 >= 10 and c2.get_unique_depth() >= 10:
            final_gt = cc.get_gt_call()
            index = to_index(final_gt[0], final_gt[1])
            if final_gt == gt1 and final_gt == gt2 and min_gq > 10:
                cc.filter = 0
            elif max_gq > 40 and int(var1.calls[i].phred[index]) + int(var2.calls[i].phred[index]) <= 20:
                cc.filter = 0
            elif max_gq > 30:
                cc.filter = 1
            else:
                cc.filter = 2
        else:
            cc.filter = 3
    combined.stats = VarStats()
    combined.generate_infos(is_sv_graph=True)
    return combined


def _finish_sv_var(new_vars: list[Variant], var: Variant, sv: SV, model: str) -> None:
    """add_sv_to_new_vars_vector (sv.cpp:305-390)."""
    if sv.type != SVType.BND and model:
        an = bytearray(var.seqs[1])
        an[-1:] = b":" + model.encode() + b">"
        var.seqs[1] = bytes(an)
    elif sv.type == SVType.BND:
        var.seqs[1] = sv.original_alt
    var.infos["SVTYPE"] = _sv_get_type(sv)
    var.infos["END"] = str(max(sv.end, sv.begin))
    if sv.length != 0:
        var.infos["SVSIZE"] = str(sv.size)
        var.infos["SVLEN"] = str(sv.length)
    if model:
        var.infos["SVMODEL"] = model
    if sv.or_start != -1:
        var.infos["ORSTART"] = str(sv.or_start)
        var.infos["OREND"] = str(sv.or_end)
    if sv.seq:
        var.infos["SEQ"] = sv.seq.decode()
    if sv.n_clusters > 0:
        var.infos["NCLUSTERS"] = str(sv.n_clusters)
    if sv.num_merged_svs >= 0:
        var.infos["NUM_MERGED_SVS"] = str(sv.num_merged_svs)
    if sv.old_variant_id and sv.old_variant_id != ".":
        var.infos["OLD_VARIANT_ID"] = sv.old_variant_id
    if sv.ins_seq:
        var.infos["SVINSSEQ"] = sv.ins_seq.decode()
    if sv.ins_seq_left:
        var.infos["LEFT_SVINSSEQ"] = sv.ins_seq_left.decode()
    if sv.ins_seq_right:
        var.infos["RIGHT_SVINSSEQ"] = sv.ins_seq_right.decode()
    if sv.type == SVType.INV and sv.inv_type:
        if sv.inv_type in ("INV3", "BOTH"):
            var.infos["INV3"] = ""
        if sv.inv_type in ("INV5", "BOTH"):
            var.infos["INV5"] = ""
    new_vars.append(var)


def reformat_sv_vcf_records(variants: list[Variant], reference_depth, graph) -> None:
    """sv.cpp:117-500 (mutates `variants` in place)."""
    import copy

    original_size = len(variants)
    to_erase: set[int] = set()
    related_svs: dict[int, int] = {}
    new_vars: list[Variant] = []

    for v in range(original_size):
        var = variants[v]
        sv_ids: list[int] = []
        for a in range(1, len(var.seqs)):
            seq = var.seqs[a]
            idx = seq.find(b"<SV:")
            if idx >= 0 and len(seq) - idx > 11:
                sv_ids.append(int(seq[idx + 4 : idx + 11]))
            else:
                sv_ids.append(-1)
        if all(i == -1 for i in sv_ids):
            continue

        is_any_not_sv = False
        for aa in range(len(sv_ids)):
            if sv_ids[aa] == -1:
                is_any_not_sv = True
                continue
            sv = graph.svs[sv_ids[aa]]
            nsv = _make_new_sv_var(var, aa, sv, sv_ids[aa], graph)
            if sv.type != SVType.BND:
                nsv.seqs[0] = b"N"
                nsv.seqs[1] = _sv_get_allele(sv)

            # duplication-breakpoint PL adjustment (sv.cpp:420-450)
            if sv.type == SVType.DUP and sv.model in ("BREAKPOINT1", "BREAKPOINT2"):
                for call in nsv.calls:
                    ERROR = 25
                    m13 = 4.77121255
                    m23 = 1.76091259
                    gt_00 = int(call.coverage[1]) * ERROR
                    gt_01 = int(0.499999999 + m13 * int(call.coverage[1]) + m23 * int(call.coverage[0]))
                    gt_11 = 3 * (int(call.coverage[0]) + int(call.coverage[1]))
                    min_gt = min(gt_00, gt_01, gt_11)
                    call.phred = np.array(
                        [min(255, gt_00 - min_gt), min(255, gt_01 - min_gt), min(255, gt_11 - min_gt)],
                        dtype=np.int64,
                    )

            if sv.type in (SVType.INS, SVType.INV) and sv_ids[aa] in related_svs:
                var_bp1 = new_vars[related_svs[sv_ids[aa]]]
                combined = _combine_calls(nsv, var_bp1)
                _finish_sv_var(new_vars, combined, sv, "AGGREGATED")

            if graph.is_sv_graph:
                if sv.type in (SVType.DEL, SVType.DEL_ALU):
                    cov_var = copy.deepcopy(nsv)
                    for pn in range(len(cov_var.calls)):
                        cov_var.calls[pn] = make_call_based_on_coverage(pn, sv, reference_depth, graph)
                    combined = _combine_calls(nsv, cov_var)
                    _finish_sv_var(new_vars, combined, sv, "AGGREGATED")
                    _finish_sv_var(new_vars, cov_var, sv, "COVERAGE")
                elif sv.type == SVType.DUP and sv_ids[aa] in related_svs:
                    cov_var = copy.deepcopy(nsv)
                    for pn in range(len(cov_var.calls)):
                        cov_var.calls[pn] = make_call_based_on_coverage(pn, sv, reference_depth, graph)
                    combined = _combine_calls(nsv, cov_var)
                    other_bp = new_vars[related_svs[sv_ids[aa]]]
                    combined2 = _combine_calls(combined, other_bp)
                    _finish_sv_var(new_vars, combined2, sv, "AGGREGATED")
                    _finish_sv_var(new_vars, cov_var, sv, "COVERAGE")

            if sv.related_sv != -1:
                related_svs[sv.related_sv] = len(new_vars)
            _finish_sv_var(new_vars, nsv, sv, sv.model)

        if is_any_not_sv:
            from graphtyper_tpu_torch.typer.variant import break_multi_snps

            non_sv = Variant(abs_pos=var.abs_pos, infos=dict(var.infos), suffix_id=var.suffix_id)
            non_sv.seqs = [var.seqs[0]] * len(var.seqs)
            non_sv.seqs = [
                var.seqs[aa + 1] if (0 < aa + 1 and aa < len(sv_ids) and sv_ids[aa] == -1) else var.seqs[0]
                for aa in range(-1, len(sv_ids))
            ]
            # collapse duplicate alleles and remap calls
            seen: list[bytes] = [non_sv.seqs[0]]
            old2new = [0]
            for a in range(1, len(non_sv.seqs)):
                s = non_sv.seqs[a]
                if s in seen:
                    old2new.append(seen.index(s))
                else:
                    old2new.append(len(seen))
                    seen.append(s)
            if len(seen) > 1:
                from graphtyper_tpu_torch.typer.variant import _remap_call

                nv2 = Variant(abs_pos=var.abs_pos, seqs=seen, infos=dict(var.infos), suffix_id=var.suffix_id)
                for call in var.calls:
                    nv2.calls.append(_remap_call(call, len(non_sv.seqs), len(seen), old2new))
                _update_per_allele_stats(len(non_sv.seqs), len(seen), old2new, var, nv2)
                nv2.normalize(graph)
                new_vars.append(nv2)

        to_erase.add(v)

    if to_erase:
        kept = [variants[v] for v in range(original_size) if v not in to_erase]
        variants[:] = new_vars + kept
