"""VCF output model: header, record formatting, site filters, bgzf + tabix.

Reference semantics: src/typer/vcf.cpp — write_header (:526-765),
write_record (:767-1155) incl. site FILTER thresholds and the binned-PL
table (binned_pl.hpp), add_haplotype (:1507), batched serialization
(save/load/append, :1662+; ours is npz-based instead of cereal).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from datetime import date

import numpy as np

from graphtyper_tpu_torch.graph.coords import AbsolutePosition
from graphtyper_tpu_torch.io.bgzf import BgzfWriter
from graphtyper_tpu_torch.io.tabix import TabixWriter
from graphtyper_tpu_torch.models.genotype_model import get_haplotype_phred
from graphtyper_tpu_torch.typer.sample_call import SampleCall
from graphtyper_tpu_torch.typer.variant import Variant

# PL binning table (binned_pl.hpp): PLs are quantized before output
BINNED_PL = np.array(
    [0] + [1] * 2 + [3] * 2 + [6] * 3 + [9] * 3 + [12] * 3 + [15] * 4 + [20] * 5
    + [25] * 5 + [30] * 5 + [35] * 5 + [40] * 7 + [50] * 10 + [60] * 13 + [75] * 12
    + [99] * 33 + [125] * 25 + [150] * 37 + [200] * 53 + [255] * 28,
    dtype=np.int64,
)
assert len(BINNED_PL) == 256

GRAPHTYPER_VERSION = "2.7.5"  # feature-parity target version of the reference


@dataclass
class VcfOutput:
    sample_names: list[str] = field(default_factory=list)
    variants: list[Variant] = field(default_factory=list)

    # ------------------------------------------------------------------

    def add_haplotype(self, site, phase_set: int, graph) -> None:
        """vcf.cpp:1507-1612 — convert a scored HaplotypeSite to a Variant."""
        var = Variant()
        var.seqs = list(graph.get_genotype_seqs(site.gt))
        # absolute position = contig offset + contig-local 1-based site order
        # (vcf.cpp:1510 via genomic_region.get_absolute_position)
        var.abs_pos = graph.abs_pos.get_absolute_position(graph.genomic_region.chr, site.gt.id)
        var.hap_id = phase_set
        # --suffix_id tag on every record ID (vcf.cpp:1602-1607)
        from graphtyper_tpu_torch.config import current_options as _vopts

        suffix_id = getattr(_vopts(), "variant_suffix_id", "")
        if suffix_id:
            var.suffix_id = suffix_id
        var.stats = site.var_stats
        hs = site.hap_samples
        ls_mat = getattr(site, "log_scores", None)
        cov_mat = getattr(site, "gt_coverages", None)
        if (
            len(hs) >= 2
            and ls_mat is not None
            and cov_mat is not None
            and len(ls_mat) == len(hs)
            and len(cov_mat) == len(hs)
        ):
            # batched PL + depth derivation straight off the site's backing
            # matrices — every hap_sample's log_score/gt_coverage is a row
            # view of these, so no re-stacking (the scalar path below is the
            # oracle — identical by construction: per-row max/all-equal/rint
            # and the same 0xFFFF caps)
            from graphtyper_tpu_torch.constants import LOG10_HALF_TIMES_10

            mx = ls_mat.max(axis=1, keepdims=True)
            phred = np.minimum(
                np.rint((mx - ls_mat) * LOG10_HALF_TIMES_10).astype(np.int64), 255
            )
            phred[(ls_mat == mx).all(axis=1)] = 0
            amb = np.fromiter((h.ambiguous_depth for h in hs), dtype=np.int64, count=len(hs))
            amb_alt = np.fromiter(
                (h.ambiguous_depth_alt for h in hs), dtype=np.int64, count=len(hs)
            )
            ref_total = np.minimum(0xFFFF, cov_mat[:, 0] + amb - amb_alt)
            alt_total = np.minimum(0xFFFF, cov_mat[:, 1:].sum(axis=1) + amb)
            for s, h in enumerate(hs):
                var.calls.append(
                    SampleCall(
                        phred=phred[s],
                        coverage=cov_mat[s],
                        ambiguous_depth=int(amb[s]),
                        alt_proper_pair_depth=h.alt_proper_pair_depth,
                        ref_total_depth=int(ref_total[s]),
                        alt_total_depth=int(alt_total[s]),
                    )
                )
        else:
            for hap_sample in hs:
                phred = get_haplotype_phred(hap_sample)
                var.calls.append(
                    SampleCall.create(
                        phred,
                        hap_sample.gt_coverage,
                        hap_sample.ambiguous_depth,
                        hap_sample.ambiguous_depth_alt,
                        hap_sample.alt_proper_pair_depth,
                    )
                )
        self.variants.append(var)

    # ------------------------------------------------------------------
    # serialization of pool batches (replaces cereal save_vcf/load_vcf)
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load(cls, path: str) -> "VcfOutput":
        with open(path, "rb") as f:
            return pickle.load(f)

    # -- batched pool serialization (replaces cereal save_vcf/load_vcf;
    # vcf.cpp:1662+, batch size options.hpp:109 num_alleles_in_batch) -------

    def save_batched(self, path: str, num_alleles_in_batch: int = 250) -> None:
        """Serialize as a pickle stream: sample names first, then variant
        batches of ~`num_alleles_in_batch` alleles each, so cohort merges can
        stream pool files batch-by-batch with bounded memory."""
        with open(path, "wb") as f:
            pickle.dump(list(self.sample_names), f, protocol=pickle.HIGHEST_PROTOCOL)
            batch: list = []
            alleles = 0
            for var in self.variants:
                batch.append(var)
                alleles += len(var.seqs)
                if alleles >= num_alleles_in_batch:
                    pickle.dump(batch, f, protocol=pickle.HIGHEST_PROTOCOL)
                    batch = []
                    alleles = 0
            if batch:
                pickle.dump(batch, f, protocol=pickle.HIGHEST_PROTOCOL)
            pickle.dump(None, f, protocol=pickle.HIGHEST_PROTOCOL)  # end marker

    @staticmethod
    def open_batched(path: str):
        """Returns (sample_names, batch_generator)."""
        f = open(path, "rb")
        sample_names = pickle.load(f)

        def gen():
            try:
                while True:
                    batch = pickle.load(f)
                    if batch is None:
                        break
                    yield batch
            finally:
                f.close()

        return sample_names, gen()

    # ------------------------------------------------------------------
    # text output
    # ------------------------------------------------------------------

    def header_lines(self, contigs, is_dropping_genotypes: bool = False) -> list[str]:
        lines = [
            "##fileformat=VCFv4.2",
            f"##fileDate={date.today().strftime('%Y%m%d')}",
            "##source=Graphtyper",
            f"##graphtyperVersion={GRAPHTYPER_VERSION}",
        ]
        for c in contigs:
            lines.append(f"##contig=<ID={c.name},length={c.length}>")
        lines += _INFO_HEADER_LINES + _FORMAT_HEADER_LINES + _FILTER_HEADER_LINES
        cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        if not is_dropping_genotypes and self.sample_names:
            cols += "\tFORMAT\t" + "\t".join(self.sample_names)
        lines.append(cols)
        return lines

    def format_record(
        self,
        var: Variant,
        abs_pos: AbsolutePosition,
        suffix: str = "",
        filter_zero_qual: bool = False,
        is_dropping_genotypes: bool = False,
        is_sv_graph: bool = False,
        output_all_variants: bool = False,
    ) -> str | None:
        """One VCF line (or None if the record is skipped)."""
        from graphtyper_tpu_torch.config import current_options as _gopts

        # the global force flag overrides the write-time zero-qual filter
        # (vcf.cpp:813)
        if _gopts().force_no_filter_zero_qual:
            filter_zero_qual = False
        chrom, pos = abs_pos.get_contig_position(var.abs_pos)
        if not output_all_variants:
            if len(var.calls) > 0 and len(var.seqs) > 80:
                return None
            if sum(len(s) for s in var.seqs) > 16000:
                return None

        # native finisher output (typer/native_finisher.py): the INFO/FILTER/
        # FORMAT columns and QUAL/VarType were computed in C++; assemble the
        # line without touching the Python INFO path (byte-identical — the
        # differential test is tests/typer/test_native_finisher.py)
        fin = getattr(var, "_fin", None)
        if fin is not None and fin[3]:
            _good, qual, vartype, info_str, filter_str, fmt_str = fin
            if filter_zero_qual and self.sample_names and qual == 0:
                return None
            vid = f"{chrom}:{pos}:{vartype}"
            if var.suffix_id:
                vid += f"[{var.suffix_id}]"
            vid += suffix
            out = [
                chrom,
                str(pos),
                vid,
                var.seqs[0].decode(),
                ",".join(s.decode() for s in var.seqs[1:]),
                str(qual),
                filter_str,
                info_str,
            ]
            if not is_dropping_genotypes and fmt_str:
                out.append(fmt_str)
            return "\t".join(out)

        qual = var.get_qual()
        if filter_zero_qual and self.sample_names and qual == 0:
            return None
        is_sv = var.is_sv()

        out = [chrom, str(pos)]
        vid = f"{chrom}:{pos}:{var.determine_variant_type()}"
        if var.suffix_id:
            vid += f"[{var.suffix_id}]"
        vid += suffix
        out.append(vid)
        out.append(var.seqs[0].decode())
        out.append(",".join(s.decode() for s in var.seqs[1:]))
        out.append(str(qual))
        out.append(self._filter_field(var, qual, is_sv))

        if not var.infos:
            out.append(".")
        else:
            parts = []
            for k in sorted(var.infos):
                v = var.infos[k]
                parts.append(f"{k}={v}" if v else k)
            out.append(";".join(parts))

        if not is_dropping_genotypes and var.calls:
            # segment-calling <...> records carry no depth fields
            # (vcf.cpp:1027-1036 GT:GQ:PL when is_segment_calling/
            # force_ignore_segment and REF starts with '<')
            from graphtyper_tpu_torch.config import current_options as _copts

            _o = _copts()
            seg_mode = (
                (_o.is_segment_calling or _o.force_ignore_segment)
                and len(var.seqs[0]) > 0
                and var.seqs[0][0:1] == b"<"
            )
            if is_sv:
                out.append("GT:FT:AD:MD:DP:RA:PP:GQ:PL")
            elif seg_mode:
                out.append("GT:GQ:PL")
            else:
                out.append("GT:AD:MD:DP:GQ:PL")
            for call in var.calls:
                fields = []
                if (call.phred == 0).all():
                    fields.append("./.")
                else:
                    g1, g2 = call.get_gt_call()
                    fields.append(f"{g1}/{g2}")
                gq = call.get_gq()
                if is_sv:
                    filt = call.check_filter(gq)
                    fields.append("PASS" if filt == 0 else f"FAIL{filt}")
                if not seg_mode:
                    fields.append(",".join(map(str, np.asarray(call.coverage).tolist())))
                    fields.append(str(call.ambiguous_depth))
                    fields.append(str(call.get_depth()))
                if is_sv:
                    fields.append(f"{call.ref_total_depth},{call.alt_total_depth}")
                    fields.append(str(call.alt_proper_pair_depth))
                fields.append(str(min(99, int(BINNED_PL[min(gq, 255)]))))
                binned = BINNED_PL[np.minimum(np.asarray(call.phred, dtype=np.int64), 255)]
                fields.append(",".join(map(str, binned.tolist())))
                out.append(":".join(fields))
        return "\t".join(out)

    @staticmethod
    def _filter_field(var: Variant, qual: int, is_sv: bool) -> str:
        # vcf.cpp:860: FILTER is "." without samples and for ploidy>2 /
        # segment / long-read calling modes
        from graphtyper_tpu_torch.config import current_options

        o = current_options()
        if not var.calls or o.ploidy > 2 or o.is_segment_calling or o.is_lr_calling:
            return "."
        infos = var.infos
        filters: list[str] = []
        if is_sv:
            if "QD" in infos and float(infos["QD"]) < 6.0:
                filters.append("LowQD")
            if qual < 10:
                filters.append("LowQUAL")
            if (
                "AN" in infos
                and "PASS_AC" in infos
                and "PASS_ratio" in infos
                and int(infos["AN"]) >= 100
                and (infos["PASS_AC"] == "0" or float(infos["PASS_ratio"]) < 0.01)
            ):
                filters.append("LowPratio")
        else:
            if "ABHet" in infos and infos["ABHet"] != "-1" and float(infos["ABHet"]) < 0.175:
                filters.append("LowABHet")
            if "ABHom" in infos and infos["ABHom"] != "-1" and float(infos["ABHom"]) < 0.85:
                filters.append("LowABHom")
            if "AN" in infos and int(infos["AN"]) >= 6 and "QD" in infos and float(infos["QD"]) < 6.0:
                filters.append("LowQD")
            if "AN" in infos and int(infos["AN"]) >= 6 and "AAScore" in infos:
                # `if x` guards the alt-free edge (A==1 emits an empty list)
                if not any(float(x) > 0.15 for x in infos["AAScore"].split(",") if x):
                    filters.append("LowAAScore")
            if qual < 10:
                filters.append("LowQUAL")
            if (
                "AN" in infos
                and "PASS_ratio" in infos
                and int(infos["AN"]) >= 500
                and float(infos["PASS_ratio"]) < 0.05
            ):
                filters.append("LowPratio")
        return ";".join(filters) if filters else "PASS"

    def write(
        self,
        path: str,
        contigs,
        abs_pos: AbsolutePosition,
        region=None,
        filter_zero_qual: bool = True,
        is_dropping_genotypes: bool = False,
        is_sv_graph: bool = False,
        output_all_variants: bool = False,
        write_tbi: bool = True,
    ) -> None:
        """Write bgzf-compressed VCF (+ .tbi). Duplicate positions get .N
        ID suffixes (vcf.cpp:1243-1273)."""
        from graphtyper_tpu_torch.config import current_options as _opts

        use_csi = getattr(_opts(), "is_csi", False)
        if write_tbi and use_csi:
            from graphtyper_tpu_torch.io.tabix import CsiWriter

            tbi = CsiWriter()
        elif write_tbi:
            tbi = TabixWriter()
        else:
            tbi = None
        # bounded-memory threaded writer: records are rendered and streamed
        # through the native multi-threaded bgzf compressor; the tabix index
        # is built from uncompressed offsets translated after compression
        # (vcf.cpp writes through threaded bgzf; io/bgzf.py gt_bgzf_compress)
        from graphtyper_tpu_torch.io.bgzf import ThreadedBgzfWriter

        w = ThreadedBgzfWriter(path)
        record_spans: list[tuple[str, int, int, int, int]] = []  # chrom,beg,end,u0,u1
        lines = self.header_lines(contigs, is_dropping_genotypes)
        if (
            getattr(_opts(), "uncompressed_sample_names", False)
            and self.sample_names
            and not is_dropping_genotypes
        ):
            # --uncompressed_sample_names (vcf.cpp:700-749): the sample-name
            # span of the #CHROM line lands in standalone 0-level BGZF
            # blocks, with its byte range written to <prefix>.samples_byte_range
            # so external tools can patch sample names without re-encoding
            for line in lines[:-1]:
                w.write(line.encode() + b"\n")
            w.write(b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t")
            level = w._level
            begin = w.hard_boundary(new_level=0) + 1
            w.write(("\t".join(self.sample_names) + "\n").encode())
            end = w.hard_boundary(new_level=level)
            import os as _os

            base = _os.path.basename(path)
            stem = base.split(".", 1)[0]
            prefix = _os.path.join(_os.path.dirname(path), stem)
            with open(prefix + ".samples_byte_range", "w") as brf:
                brf.write(f"{begin} {end}\n")
        else:
            for line in lines:
                w.write(line.encode() + b"\n")
        variants = sorted(self.variants, key=lambda v: (v.abs_pos, v.seqs))
        if region is not None:
            lo = abs_pos.get_absolute_position(region.chr, region.begin) + 1
            hi = abs_pos.get_absolute_position(region.chr, region.end)
            variants = [v for v in variants if lo <= v.abs_pos <= hi]
        prev_key = None
        dup = 0
        for var in variants:
            key = (var.abs_pos, tuple(var.seqs))
            if prev_key is not None and key[0] == prev_key[0] and key[1] == prev_key[1]:
                dup += 1
                suffix = f".{dup}"
            else:
                dup = 0
                suffix = ""
            prev_key = key
            line = self.format_record(
                var,
                abs_pos,
                suffix=suffix,
                filter_zero_qual=filter_zero_qual,
                is_dropping_genotypes=is_dropping_genotypes,
                is_sv_graph=is_sv_graph,
                output_all_variants=output_all_variants,
            )
            if line is None:
                continue
            u0 = w.u_offset
            w.write(line.encode() + b"\n")
            if tbi is not None:
                chrom, pos = abs_pos.get_contig_position(var.abs_pos)
                record_spans.append((chrom, pos - 1, pos - 1 + len(var.seqs[0]), u0, w.u_offset))
        w.close()
        if tbi is not None:
            for chrom, beg, end, u0, u1 in record_spans:
                tbi.add(chrom, beg, end, w.virtual_offset_of(u0), w.virtual_offset_of(u1))
            tbi.save(path + (".csi" if use_csi else ".tbi"))


_INFO_HEADER_LINES = [
    '##INFO=<ID=AAScore,Number=A,Type=Float,Description="Alternative allele confidence score in range [0.0,1.0]. The score is determined by a logistic regression model which was trained on GIAB truth data using other INFOs metrics as covariates.">',
    '##INFO=<ID=ABHet,Number=1,Type=Float,Description="Allele Balance for heterozygouscalls (read count of call2/(call1+call2)) where the called genotype is call1/call2. -1 if no heterozygous calls.">',
    '##INFO=<ID=ABHom,Number=1,Type=Float,Description="Allele Balance for homozygous calls(read count of A/(A+O)) where A is the called allele and O is anything else. -1 if no homozygous calls.">',
    '##INFO=<ID=ABHetMulti,Number=R,Type=Float,Description="List of Allele Balance values for heterozygous calls (alt/(ref+alt)). -1 if not available.">',
    '##INFO=<ID=ABHomMulti,Number=R,Type=Float,Description="List of Allele Balance values for homozygous calls (A/(A+0)) where A is the called allele and O is anything else. -1 if not available.">',
    '##INFO=<ID=AC,Number=A,Type=Integer,Description="Number of alternate alleles in called genotypes.">',
    '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency.">',
    '##INFO=<ID=AN,Number=1,Type=Integer,Description="Number of alleles in called genotypes.">',
    '##INFO=<ID=CR,Number=1,Type=Integer,Description="Number of clipped reads in the graph alignment.">',
    '##INFO=<ID=CRal,Number=.,Type=String,Description="Number of clipped bp per allele.">',
    '##INFO=<ID=CRalt,Number=A,Type=Float,Description="Percent of clipped reads per allele.">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of an SV.">',
    '##INFO=<ID=FEATURE,Number=1,Type=String,Description="Gene feature.">',
    '##INFO=<ID=GT_ANTI_HAPLOTYPE,Number=.,Type=String,Description="Haplotype string with downstream variants  with no (or very low) evidence of being in the same haplotype. Used internally by Graphtyper.">',
    '##INFO=<ID=GT_HAPLOTYPE,Number=.,Type=String,Description="Haplotype string with downstream variants  with high evidence of being always in the same haplotype. Used internally by Graphtyper.">',
    '##INFO=<ID=GT_ID,Number=.,Type=String,Description="ID for variant. Used internally by Graphtyper.">',
    '##INFO=<ID=HOMSEQ,Number=.,Type=String,Description="Sequence of base pair identical homology at event breakpoints.">',
    '##INFO=<ID=INV3,Number=0,Type=Flag,Description="Inversion breakends open 3\' of reported location">',
    '##INFO=<ID=INV5,Number=0,Type=Flag,Description="Inversion breakends open 5\' of reported location">',
    '##INFO=<ID=LEFT_SVINSSEQ,Number=.,Type=String,Description="Known left side of insertion for an insertion of unknown length.">',
    '##INFO=<ID=LOGF,Number=1,Type=Float,Description="Output from logistic regression model.">',
    '##INFO=<ID=MaxAAS,Number=A,Type=Integer,Description="Maximum alternative allele support per alt. allele.">',
    '##INFO=<ID=MaxAASR,Number=A,Type=Float,Description="Maximum alternative allele support ratio per alt. allele.">',
    '##INFO=<ID=MaxAltPP,Number=1,Type=Integer,Description="Maximum number of proper pairs support the alternative allele.">',
    '##INFO=<ID=MMal,Number=.,Type=String,Description="Scaled mismatch count per allele.">',
    '##INFO=<ID=MMalt,Number=A,Type=Float,Description="Mismatch percent per alternative allele.">',
    '##INFO=<ID=MQ,Number=1,Type=Integer,Description="Root-mean-square mapping quality.">',
    '##INFO=<ID=MQalt,Number=A,Type=Integer,Description="Mapping qualities per alternative allele.">',
    '##INFO=<ID=MQSal,Number=.,Type=String,Description="Sum of squared mapping qualities per allele.">',
    '##INFO=<ID=MQsquared,Number=.,Type=String,Description="Sum of squared mapping qualities. Used to calculate MQ.">',
    '##INFO=<ID=NCLUSTERS,Number=1,Type=Integer,Description="Number of SV candidates in cluster.">',
    '##INFO=<ID=NGT,Number=3,Type=Integer,Description="Number of REF/REF, REF/ALT and ALT/ALTgenotypes, respectively.">',
    '##INFO=<ID=NHet,Number=A,Type=Integer,Description="Number of heterozygous genotype calls.">',
    '##INFO=<ID=NHomRef,Number=A,Type=Integer,Description="Number of homozygous reference genotype calls.">',
    '##INFO=<ID=NHomAlt,Number=A,Type=Integer,Description="Number of homozygous alternative genotype calls.">',
    '##INFO=<ID=NUM_MERGED_SVS,Number=1,Type=Integer,Description="Number of SVs merged.">',
    '##INFO=<ID=OLD_VARIANT_ID,Number=1,Type=String,Description="Variant ID from a VCF (SVs only).">',
    '##INFO=<ID=ORSTART,Number=1,Type=Integer,Description="Start coordinate of sequence origin.">',
    '##INFO=<ID=OREND,Number=1,Type=Integer,Description="End coordinate of sequence origin.">',
    '##INFO=<ID=QD,Number=1,Type=Float,Description="QUAL divided by NonReferenceSeqDepth.">',
    '##INFO=<ID=QDalt,Number=A,Type=Float,Description="Simplified QD calculated separately for each allele against all other alleles.">',
    '##INFO=<ID=PASS_AC,Number=A,Type=Integer,Description="Number of alternate alleles in called genotyped that have FT = PASS.">',
    '##INFO=<ID=PASS_AN,Number=1,Type=Integer,Description="Number of genotype calls that haveFT = PASS.">',
    '##INFO=<ID=PASS_ratio,Number=1,Type=Float,Description="Ratio of genotype calls that haveFT = PASS.">',
    '##INFO=<ID=PexcessHet,Number=A,Type=Float,Description="Pval of excess heterozygous calls.">',
    '##INFO=<ID=RefLen,Number=1,Type=Integer,Description="Length of the reference allele.">',
    '##INFO=<ID=RELATED_SV_ID,Number=1,Type=Integer,Description="GraphTyper ID of a related SV.">',
    '##INFO=<ID=RIGHT_SVINSSEQ,Number=.,Type=String,Description="Known right side of insertion for an insertion of unknown length.">',
    '##INFO=<ID=SB,Number=1,Type=Float,Description="Strand bias (F/(F+R)) where F and R are forward and reverse strands, respectively. -1 if not available.">',
    '##INFO=<ID=SBAlt,Number=1,Type=Float,Description="Strand bias of alternative alleles only. -1 if not available.">',
    '##INFO=<ID=SBF,Number=R,Type=Integer,Description="Number of forward stranded reads per allele.">',
    '##INFO=<ID=SBF1,Number=R,Type=Integer,Description="Number of first forward stranded reads per allele.">',
    '##INFO=<ID=SBF2,Number=R,Type=Integer,Description="Number of second forward stranded reads per allele.">',
    '##INFO=<ID=SBR,Number=R,Type=Integer,Description="Number of reverse stranded reads per allele.">',
    '##INFO=<ID=SBR1,Number=R,Type=Integer,Description="Number of first reverse stranded reads per allele.">',
    '##INFO=<ID=SBR2,Number=R,Type=Integer,Description="Number of second reverse stranded reads per allele.">',
    '##INFO=<ID=SDal,Number=.,Type=String,Description="Score difference of AS and XS tags per allele.">',
    '##INFO=<ID=SDalt,Number=A,Type=Float,Description="Avergae score difference of AS and XS tags per alternative allele.">',
    '##INFO=<ID=SEQ,Number=1,Type=String,Description="Inserted sequence at variant site.">',
    '##INFO=<ID=SeqDepth,Number=1,Type=Integer,Description="Total accumulated sequencing depth over all the samples.">',
    '##INFO=<ID=SV_ID,Number=1,Type=Integer,Description="GraphTyper\'s ID on SV.">',
    '##INFO=<ID=SVINSSEQ,Number=.,Type=String,Description="Sequence of insertion.">',
    '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length of structural variant in bp. Negative lengths indicate a deletion.">',
    '##INFO=<ID=SVMODEL,Number=1,Type=String,Description="Model used for SV genotyping.">',
    '##INFO=<ID=SVSIZE,Number=1,Type=Integer,Description="Size of structural variant in bp. Always 50 or more.">',
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant.">',
    '##INFO=<ID=VarType,Number=1,Type=String,Description="First letter is program identifier,the second letter is variant type.">',
]

_FORMAT_HEADER_LINES = [
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="GenoType call. ./. is called if there is no coverage at the variant site.">',
    '##FORMAT=<ID=FT,Number=1,Type=String,Description="Filter. PASS or FAILN where N is a number.">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths for the ref and alt alleles in the order listed.">',
    '##FORMAT=<ID=MD,Number=1,Type=Integer,Description="Read depth of multiple alleles.">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth.">',
    '##FORMAT=<ID=RA,Number=2,Type=Integer,Description="Total read depth of the reference allele and all alternative alleles, including reads that support more than one allele.">',
    '##FORMAT=<ID=PP,Number=1,Type=Integer,Description="Number of reads that support non-reference haplotype that are proper pairs.">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality.">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="PHRED-scaled genotype likelihoods.">',
]

_FILTER_HEADER_LINES = [
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FILTER=<ID=LowAAScore,Description="Alternative alleles have a low score.">',
    '##FILTER=<ID=LowABHet,Description="Allele balance of heterozygous carriers is below 17.5%.">',
    '##FILTER=<ID=LowABHom,Description="Allele balance of homozygous carriers is below 90%.">',
    '##FILTER=<ID=LowQD,Description="QD (quality by depth) is below 6.0.">',
    '##FILTER=<ID=LowQUAL,Description="QUAL score is less than 10.">',
    '##FILTER=<ID=LowPratio,Description="Ratio of PASSed calls was too low.">',
]
