"""Cross-pool VCF reductions: merge, break down, filter/extract, concatenate.

Reference semantics: src/typer/vcf_operations.cpp — vcf_merge_and_return
(:20-142, concatenate per-site sample calls + sum stats), vcf_merge_and_filter
(:278-478, the iteration handoff: emit good alts as biallelic sites-only
records with GT_ID / GT_HAPLOTYPE / GT_ANTI_HAPLOTYPE), vcf_merge_and_break
(:480-731, final merge + decomposition + normalization + INFO + write),
vcf_concatenate (:734+).
"""

from __future__ import annotations

from graphtyper_tpu_torch.constants import IS_ANY_ANTI_HAP_SUPPORT, IS_ANY_HAP_SUPPORT
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.io.bgzf import BgzfWriter
from graphtyper_tpu_torch.typer.variant import Variant, break_down_variant
from graphtyper_tpu_torch.typer.vcf_out import VcfOutput


def vcf_merge(pool_vcfs: list[VcfOutput]) -> VcfOutput:
    """Concatenate per-site calls across pools and sum INFO stats."""
    if not pool_vcfs:
        return VcfOutput()
    base = pool_vcfs[0]
    for other in pool_vcfs[1:]:
        base.sample_names.extend(other.sample_names)
        assert len(other.variants) == len(base.variants)
        for var, ovar in zip(base.variants, other.variants):
            var.stats.add_stats(ovar.stats)
            var.calls.extend(ovar.calls)
    return base


def vcf_merge_streamed(pool_paths: list[str]):
    """Streaming cross-pool merge over batched pool files (save_batched):
    corresponding allele batches are loaded pool-by-pool, merged (sample
    calls concatenated, stats summed), and yielded — cohort merges never
    hold every pool's full call matrix in memory
    (vcf_operations.cpp:20-142, batch size options.hpp:109).

    Returns (sample_names, variant_generator)."""
    opened = [VcfOutput.open_batched(p) for p in pool_paths]
    sample_names: list[str] = []
    for names, _gen in opened:
        sample_names.extend(names)

    def gen():
        gens = [g for _n, g in opened]
        while True:
            batches = []
            for g in gens:
                batches.append(next(g, None))
            if batches[0] is None:
                if any(b is not None for b in batches):
                    raise ValueError("pool batch streams are misaligned")
                return
            base = batches[0]
            for other in batches[1:]:
                if other is None or len(other) != len(base):
                    raise ValueError("pool batch streams are misaligned")
                for var, ovar in zip(base, other):
                    if var.abs_pos != ovar.abs_pos or var.seqs != ovar.seqs:
                        raise ValueError("pool variants differ between pools")
                    var.stats.add_stats(ovar.stats)
                    var.calls.extend(ovar.calls)
            for var in base:
                yield var

    return sample_names, gen()


def merge_ph_maps(ph_maps: list[dict]) -> dict:
    """OR-merge per-pool phasing maps (caller.cpp:439-482)."""
    out: dict = {}
    for ph in ph_maps:
        for key, bucket in ph.items():
            dst = out.setdefault(key, {})
            for k2, flags in bucket.items():
                dst[k2] = dst.get(k2, 0) | flags
    return out


def vcf_merge_and_break_streamed(
    pool_paths: list[str],
    output_path: str,
    region_str: str,
    graph,
    **kw,
) -> None:
    """vcf_merge_and_break over batched pool files with bounded memory: the
    merged variants stream through decomposition/INFO generation and out via
    the threaded bgzf writer."""
    sample_names, variants = vcf_merge_streamed(pool_paths)
    merged = VcfOutput(sample_names=sample_names, variants=list(variants))
    vcf_merge_and_break([merged], output_path, region_str, graph, **kw)


def vcf_merge_and_break(
    pool_vcfs: list[VcfOutput],
    output_path: str,
    region_str: str,
    graph,
    filter_zero_qual: bool = False,
    force_no_variant_overlapping: bool = False,
    force_no_break_down: bool = False,
    no_decompose: bool = False,
    no_variant_overlapping: bool = False,
    is_all_biallelic: bool = False,
    force_no_filter_bad_alts: bool = False,
) -> None:
    """vcf_operations.cpp:480-731."""
    from graphtyper_tpu_torch.config import current_options as _gopts

    # the reference reads the global flag (vcf_operations.cpp:648); the
    # zero-qual force implies it (main.cpp:664-665)
    _o = _gopts()
    force_no_filter_bad_alts = (
        force_no_filter_bad_alts or _o.force_no_filter_bad_alts or _o.force_no_filter_zero_qual
    )
    # the global --no_variant_overlapping feeds the decomposition mode
    # (vcf_operations.cpp:618)
    no_variant_overlapping = no_variant_overlapping or _o.no_variant_overlapping
    vcf = vcf_merge(pool_vcfs)
    region = GenomicRegion.parse(region_str)
    candidates: list[Variant] = []
    for var in vcf.variants:
        if len(var.calls) != len(vcf.sample_names):
            raise ValueError("calls / sample_names mismatch")
        if force_no_break_down:
            new_variants = [var]
        else:
            new_variants = break_down_variant(
                var,
                graph,
                no_variant_overlapping or force_no_variant_overlapping,
                is_all_biallelic,
                no_decompose=no_decompose,
            )
        for nv in new_variants:
            dist = nv.normalize(graph)
            if dist > 200:
                continue
            candidates.append(nv)

    # scan + INFO/FILTER/FORMAT generation: one batched native pass over the
    # eligible (non-SV) records; the rest run the Python path
    if not graph.is_sv_graph:
        from graphtyper_tpu_torch.typer import native_finisher

        if native_finisher.available():
            native_finisher.finish_variants(candidates, len(vcf.sample_names))
    broken: list[Variant] = []
    for nv in candidates:
        fin = getattr(nv, "_fin", None)
        if fin is not None:
            is_good_alt = fin[0]
        else:
            is_good_alt = nv.generate_infos(graph, is_sv_graph=graph.is_sv_graph)
        if not force_no_filter_bad_alts and all(g == 0 for g in is_good_alt):
            continue
        broken.append(nv)

    out = VcfOutput(sample_names=vcf.sample_names, variants=broken)
    out.write(
        output_path,
        graph.contigs,
        graph.abs_pos,
        region=region if region.chr != "N/A" else None,
        filter_zero_qual=filter_zero_qual,
        is_sv_graph=graph.is_sv_graph,
    )

    from graphtyper_tpu_torch.config import current_options

    if current_options().encoding == "p":
        # popVCF-encode the final output in place and rebuild its index
        # (--encoding=popvcf, main.cpp:440-444 + include/popvcf/encode.hpp)
        import os

        from graphtyper_tpu_torch.io.popvcf import encode_file
        from graphtyper_tpu_torch.io.tabix import write_index_for

        tmp_path = output_path + ".pop_tmp"
        encode_file(output_path, tmp_path)
        os.replace(tmp_path, output_path)
        write_index_for(output_path, use_csi=getattr(current_options(), "is_csi", False))


def _group_by_call_count(variants: list) -> dict[int, list]:
    groups: dict[int, list] = {}
    for v in variants:
        groups.setdefault(len(v.calls), []).append(v)
    return groups


def vcf_merge_and_filter(
    pool_vcfs: list[VcfOutput],
    output_path: str,
    ph: dict,
    graph,
) -> None:
    """vcf_operations.cpp:278-478 — the iteration handoff: merged sites ->
    good biallelic site records with phasing-constraint INFO strings."""
    vcf = vcf_merge(pool_vcfs)

    # map hap_id -> starting global allele id
    hap_id2var_id: dict[int, int] = {}
    var_id = 0
    for var in vcf.variants:
        assert var.hap_id >= 0
        hap_id2var_id[var.hap_id] = var_id
        var_id += len(var.seqs) - 1

    out = VcfOutput(sample_names=[])
    # only the is_good_alt verdicts are needed here — the batched native
    # finisher skips string building entirely (want_strings=False)
    from graphtyper_tpu_torch.typer import native_finisher

    if native_finisher.available():
        for S, group in _group_by_call_count(vcf.variants).items():
            native_finisher.finish_variants(group, S, want_strings=False)
    var_id = 0
    for var in vcf.variants:
        fin = getattr(var, "_fin", None)
        if fin is not None:
            is_good_alt = fin[0]
        else:
            is_good_alt = var.generate_infos(graph, is_sv_graph=False)
        for a in range(len(var.seqs) - 1):
            var_id += 1
            if is_good_alt[a] == 0:
                continue
            nv = Variant(abs_pos=var.abs_pos, seqs=[var.seqs[0], var.seqs[a + 1]])
            nv.infos["GT_ID"] = str(var_id)
            anti: list[str] = []
            hap: list[str] = []
            for a2 in range(a + 1, len(var.seqs) - 1):
                if is_good_alt[a2] == 0:
                    continue
                anti.append(str(var_id + a2 - a))
            key = (var.hap_id, a + 1)
            if key in ph:
                for (other_hap_id, other_allele), flags in sorted(ph[key].items()):
                    if other_allele == 0:
                        continue
                    if flags not in (IS_ANY_HAP_SUPPORT, IS_ANY_ANTI_HAP_SUPPORT):
                        continue
                    other_var_id = hap_id2var_id[other_hap_id] + other_allele
                    if flags == IS_ANY_HAP_SUPPORT:
                        hap.append(str(other_var_id))
                    else:
                        anti.append(str(other_var_id))
            if anti:
                nv.infos["GT_ANTI_HAPLOTYPE"] = ",".join(anti)
            if hap:
                nv.infos["GT_HAPLOTYPE"] = ",".join(hap)
            out.variants.append(nv)

    out.write(
        output_path,
        graph.contigs,
        graph.abs_pos,
        filter_zero_qual=False,
        is_dropping_genotypes=True,
    )
    # returned so the next iteration can take the sites in memory
    # (graph/build.records_from_vcf_output) instead of re-reading the file
    return out


def vcf_concatenate(vcf_paths: list[str], output_path: str, contigs=None) -> None:
    """Concatenate region VCF files (text level, header from the first;
    vcf_operations.cpp:734+)."""
    from graphtyper_tpu_torch.io.bgzf import decompress_all

    w = BgzfWriter(output_path)
    wrote_header = False
    for path in vcf_paths:
        text = decompress_all(path).decode()
        for line in text.split("\n"):
            if not line:
                continue
            if line.startswith("#"):
                if not wrote_header:
                    w.write(line.encode() + b"\n")
            else:
                w.write(line.encode() + b"\n")
        wrote_header = True
    w.close()
