"""Variant records with calls: INFO generation, QUAL, normalization,
decomposition into SNPs/indels.

Reference semantics: src/typer/variant.cpp — scan_calls (:237-429),
generate_infos (:430-1096), QUAL = sum of PL[hom-ref] (:1522-1532),
normalize/left-align (:1256-1315), break_down_variant (:1652-1713),
break_multi_snps (:1996), make_biallelic (:1577). The skyr MSA decomposition
is replaced by our own pairwise-alignment edit extraction (utils/msa.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.models.genotype_model import ReadStrand, VarStats, to_index
from graphtyper_tpu_torch.models.hwe import p_hwe_excess_het
from graphtyper_tpu_torch.models.logistic import get_aa_score, get_logf
from graphtyper_tpu_torch.typer.sample_call import SampleCall


def fmt_g(x: float, precision: int = 4) -> str:
    """C++ ostringstream default-float formatting with given precision."""
    s = f"{x:.{precision}g}"
    # C++ prints exponents as e+06 / e-05 (2+ digits); Python matches already
    if "e" in s:
        mant, _, exp = s.partition("e")
        sign = "+" if not exp.startswith("-") else "-"
        exp = exp.lstrip("+-")
        s = f"{mant}e{sign}{int(exp):02d}"
    return s


def to_index_safe(x: int, y: int) -> int:
    return to_index(x, y) if x <= y else to_index(y, x)


@dataclass
class Variant:
    abs_pos: int = 0
    seqs: list[bytes] = field(default_factory=list)
    calls: list[SampleCall] = field(default_factory=list)
    stats: VarStats = field(default_factory=VarStats)
    infos: dict[str, str] = field(default_factory=dict)
    suffix_id: str = ""
    hap_id: int = -1
    type: str = ""

    def __eq__(self, o) -> bool:
        return self.abs_pos == o.abs_pos and self.seqs == o.seqs

    def __lt__(self, o) -> bool:
        return (self.abs_pos, self.type, self.seqs) < (o.abs_pos, o.type, o.seqs)

    # ------------------------------------------------------------------

    def is_sv(self) -> bool:
        for seq in self.seqs[1:]:
            if len(seq) < 5:
                continue
            if seq[0:1] == b"<" or (len(seq) > 100 and b"<" in seq):
                return True
        return False

    def is_snp_or_snps(self) -> bool:
        return all(len(s) == len(self.seqs[0]) for s in self.seqs[1:])

    def is_with_matching_first_bases(self) -> bool:
        fb = self.seqs[0][0:1]
        return all(s[0:1] == fb for s in self.seqs[1:])

    def get_qual(self) -> int:
        return sum(int(c.phred[0]) for c in self.calls if len(c.phred) > 0)

    def get_qual_by_depth(self) -> float:
        total_qual = 0
        total_depth = 0
        for c in self.calls:
            if len(c.phred) > 0 and c.phred[0] > 0:
                depth = min(10, c.get_alt_depth())
                if depth > 0:
                    total_qual += min(25 * depth, int(c.phred[0]))
                    total_depth += depth
        return total_qual / total_depth if total_depth else 0.0

    def get_qual_by_depth_per_alt_allele(self) -> list[float]:
        out = []
        for s in range(1, len(self.seqs)):
            pa = self.stats.per_allele[s]
            out.append(pa.qd_qual / pa.qd_depth if pa.qd_depth > 0 else 0.0)
        return out

    # ------------------------------------------------------------------
    # reference-sequence edits (need graph for flanking bases)
    # ------------------------------------------------------------------

    def _ref_base_at(self, graph, abs_pos: int) -> bytes | None:
        """One reference base at a global absolute 1-based position."""
        region = graph.genomic_region
        local = abs_pos - graph.abs_pos.chromosome_to_offset.get(region.chr, 0)
        idx = local - (region.begin + 1)
        if 0 <= idx < len(graph.reference):
            return graph.reference[idx : idx + 1]
        return None

    def add_base_in_front(self, graph, add_N: bool = False) -> bool:
        base = self._ref_base_at(graph, self.abs_pos - 1)
        if base is None:
            return False
        if base not in (b"A", b"C", b"G", b"T"):
            if not add_N:
                return False
            base = b"N"
        self.seqs = [
            base + s if (len(s) == 0 or len(s) > 1 or s[0:1] != b"*") else s for s in self.seqs
        ]
        self.abs_pos -= 1
        return True

    def add_base_in_back(self, graph, add_N: bool = False) -> bool:
        base = self._ref_base_at(graph, self.abs_pos + len(self.seqs[0]))
        if base is None:
            return False
        if base == b"N" and not add_N:
            return False
        self.seqs = [s + base for s in self.seqs]
        return True

    def normalize(self, graph) -> int:
        """Left-align (variant.cpp:1256-1315)."""
        if len(self.seqs) < 2:
            return 0
        ref = self.seqs[0]
        for i, seq in enumerate(self.seqs):
            if len(seq) == 0 or seq[0:1] != ref[0:1]:
                return 0
            if i > 0 and seq == ref:
                return 0
        self._remove_common_suffix()
        distance = 0
        while all(s[-1:] == self.seqs[0][-1:] for s in self.seqs[1:]):
            if not self.add_base_in_front(graph):
                break
            distance += 1
            self._remove_common_suffix()
        self._remove_common_prefix(False)
        return distance

    def _remove_common_suffix(self) -> None:
        seqs = self.seqs
        if len(seqs) <= 1 or len(seqs[0]) <= 1:
            return
        while len(seqs[0]) > 1 and all(
            len(s) > 1 and s[-1:] == seqs[0][-1:] for s in seqs[1:]
        ):
            seqs = [s[:-1] for s in seqs]
        self.seqs = seqs

    def _remove_common_prefix(self, keep_one_match: bool) -> None:
        seqs = self.seqs
        if len(seqs) <= 1 or len(seqs[0]) <= 1:
            return
        pos = self.abs_pos
        while len(seqs[0]) > 1:
            ok = all(
                len(s) > 1 and s[0:1] == seqs[0][0:1] and (not keep_one_match or s[1:2] == seqs[0][1:2])
                for s in seqs[1:]
            )
            if not ok:
                break
            pos += 1
            seqs = [s[1:] for s in seqs]
        self.seqs = seqs
        self.abs_pos = pos

    def trim_sequences(self, graph, keep_one_match: bool) -> None:
        self.add_base_in_front(graph)
        if not self.is_sv():
            self._remove_common_suffix()
        self._remove_common_prefix(keep_one_match)

    # ------------------------------------------------------------------
    # INFO generation (variant.cpp scan_calls + generate_infos)
    # ------------------------------------------------------------------

    def scan_calls(self, is_sv_graph: bool = False, is_lr_calling: bool | None = None) -> None:
        if is_lr_calling is None:
            # the reference reads the global option inside scan_calls
            # (variant.cpp:334 copts.is_lr_calling); genotype_lr sets it
            from graphtyper_tpu_torch.config import current_options

            is_lr_calling = current_options().is_lr_calling
        st = self.stats
        if st.seqdepth > 0 or st.n_calls > 0:
            return
        if not st.per_allele:
            st.per_allele = VarStats.sized(len(self.seqs)).per_allele
            st.read_strand = VarStats.sized(len(self.seqs)).read_strand
        num_alts = len(self.seqs) - 1
        if len(self.calls) >= 8 and self._scan_calls_vectorized(is_lr_calling):
            return
        st.n_calls += len(self.calls)

        for sc in self.calls:
            if len(sc.phred) > 0 and sc.phred[0] > 0:
                gt1, gt2 = sc.get_gt_call()
                if gt1 > 0:
                    pa = st.per_allele[gt1]
                    depth = min(10, int(sc.coverage[gt1]) + sc.ambiguous_depth)
                    if depth > 0:
                        pa.qd_qual += min(25 * depth, sc.get_lowest_phred_not_with(gt1))
                        pa.qd_depth += depth
                if gt1 != gt2:
                    pa = st.per_allele[gt2]
                    depth = min(10, int(sc.coverage[gt2]) + sc.ambiguous_depth)
                    if depth > 0:
                        pa.qd_qual += min(25 * depth, sc.get_lowest_phred_not_with(gt2))
                        pa.qd_depth += depth

            st.n_max_alt_proper_pairs = max(st.n_max_alt_proper_pairs, sc.alt_proper_pair_depth)
            total_depth = int(sc.coverage.sum())
            c1, c2 = sc.get_gt_call()

            for c in range(num_alts):
                pa = st.per_allele[c + 1]
                pa.maximum_alt_support = max(pa.maximum_alt_support, int(sc.coverage[c + 1]))
                if total_depth > 0:
                    ratio = int(sc.coverage[c + 1]) / total_depth
                    pa.maximum_alt_support_ratio = max(pa.maximum_alt_support_ratio, ratio)
                if c1 == c + 1 or c2 == c + 1:
                    if c1 == c2:
                        pa.n_alt_alt += 1
                    else:
                        pa.n_ref_alt += 1
                else:
                    pa.n_ref_ref += 1

            gq = sc.get_gq()
            if is_lr_calling:
                gq += 10
            filt = sc.check_filter(gq)
            if (sc.phred != 0).any():
                st.n_genotyped += 1
            if filt == 0:
                st.n_passed_calls += 1

            if c1 != c2:
                st.het_allele_depth[0] += int(sc.coverage[c1])
                st.het_allele_depth[1] += int(sc.coverage[c2])
            else:
                st.hom_allele_depth[0] += int(sc.coverage[c1])
                st.hom_allele_depth[1] += int(sc.coverage.sum()) - int(sc.coverage[c1])

            call_depth = sc.get_unique_depth()
            if c1 != c2:
                for cc in (c1, c2):
                    pa = st.per_allele[cc]
                    h = list(pa.het_multi_allele_depth)
                    h[0] += int(sc.coverage[cc])
                    h[1] += call_depth - int(sc.coverage[cc])
                    pa.het_multi_allele_depth = (h[0], h[1])
            else:
                pa = st.per_allele[c1]
                h = list(pa.hom_multi_allele_depth)
                h[0] += int(sc.coverage[c1])
                h[1] += call_depth - int(sc.coverage[c1])
                pa.hom_multi_allele_depth = (h[0], h[1])

            if len(sc.coverage) > 0:
                st.seqdepth += sc.get_depth()
                for c in range(1, len(sc.coverage)):
                    st.per_allele[c].total_depth += int(sc.coverage[c])

            st.per_allele[c1].ac += 1
            st.per_allele[c2].ac += 1
            if filt == 0:
                st.per_allele[c1].pass_ac += 1
                st.per_allele[c2].pass_ac += 1

    def _scan_calls_vectorized(self, is_lr_calling: bool) -> bool:
        """Batched twin of the scalar loop below over [S, P] phred / [S, A]
        coverage matrices — every accumulation is an order-free sum/max, so
        the results are identical (tests/typer/test_scan_calls_vec.py fuzzes
        parity). Returns False (caller falls back) on ragged shapes."""
        st = self.stats
        A = len(self.seqs)
        P = A * (A + 1) // 2
        calls = self.calls
        S = len(calls)
        for sc in calls:
            if len(sc.phred) != P or len(sc.coverage) != A:
                return False
        phred = np.stack([sc.phred for sc in calls]).astype(np.int64)  # [S, P]
        cov = np.stack([sc.coverage for sc in calls]).astype(np.int64)  # [S, A]
        amb = np.array([sc.ambiguous_depth for sc in calls], dtype=np.int64)
        app = np.array([sc.alt_proper_pair_depth for sc in calls], dtype=np.int64)
        filt_pre = np.array([sc.filter for sc in calls], dtype=np.int64)

        # PL-triangle coordinate tables (x <= y per entry, row-major by y)
        tri_x = np.empty(P, dtype=np.int64)
        tri_y = np.empty(P, dtype=np.int64)
        i = 0
        for y in range(A):
            for x in range(y + 1):
                tri_x[i] = x
                tri_y[i] = y
                i += 1

        # get_gt_call: first zero entry (or 0/0 when none)
        is_zero = phred == 0
        first_zero = np.argmax(is_zero, axis=1)
        has_zero = is_zero[np.arange(S), first_zero]
        c1 = np.where(has_zero, tri_x[first_zero], 0)
        c2 = np.where(has_zero, tri_y[first_zero], 0)

        # get_gq: 0 when two zero entries, else min over nonzero (255 cap)
        n_zero = is_zero.sum(axis=1)
        nz_min = np.where(is_zero, 255, np.minimum(phred, 255)).min(axis=1)
        gq = np.where(n_zero >= 2, 0, nz_min)
        if is_lr_calling:
            gq = gq + 10
        # check_filter with memoized values preserved
        bucket = np.select([gq >= 30, gq >= 20, gq >= 10], [0, 1, 2], default=3)
        filt = np.where(filt_pre >= 0, filt_pre, bucket)
        for sc, f in zip(calls, filt):
            sc.filter = int(f)

        # get_lowest_phred_not_with(a): min over entries avoiding allele a
        notwith = (tri_x[None, :] != np.arange(A)[:, None]) & (
            tri_y[None, :] != np.arange(A)[:, None]
        )  # [A, P]
        low_notwith = np.empty((S, A), dtype=np.int64)
        for a in range(A):  # per-allele keeps peak memory at [S, P]
            low_notwith[:, a] = np.where(notwith[a], phred, 255).min(axis=1)

        # qd accumulation: calls with phred[0] > 0 contribute for gt1 (and
        # gt2 when het), depth-capped at 10
        qd_active = phred[:, 0] > 0
        sidx = np.arange(S)
        pa = st.per_allele
        for which, gt, other in ((0, c1, None), (1, c2, c1)):
            m = qd_active & (gt > 0)
            if other is not None:
                m &= c1 != c2
            depth = np.minimum(10, cov[sidx, gt] + amb)
            m &= depth > 0
            if m.any():
                contrib = np.minimum(25 * depth, low_notwith[sidx, gt])
                qd_q = np.zeros(A, dtype=np.int64)
                qd_d = np.zeros(A, dtype=np.int64)
                np.add.at(qd_q, gt[m], contrib[m])
                np.add.at(qd_d, gt[m], depth[m])
                for a in range(1, A):
                    pa[a].qd_qual += int(qd_q[a])
                    pa[a].qd_depth += int(qd_d[a])

        st.n_max_alt_proper_pairs = max(st.n_max_alt_proper_pairs, int(app.max()))
        total_depth = cov.sum(axis=1)

        # per-alt genotype-class counts and support maxima
        alt_ids = np.arange(1, A)
        called = (c1[:, None] == alt_ids[None, :]) | (c2[:, None] == alt_ids[None, :])
        hom = c1 == c2
        for c in range(num_alts := A - 1):
            p = pa[c + 1]
            p.maximum_alt_support = max(p.maximum_alt_support, int(cov[:, c + 1].max()))
            nz = total_depth > 0
            if nz.any():
                ratios = cov[nz, c + 1] / total_depth[nz]
                p.maximum_alt_support_ratio = max(p.maximum_alt_support_ratio, float(ratios.max()))
            cc = called[:, c]
            p.n_alt_alt += int((cc & hom).sum())
            p.n_ref_alt += int((cc & ~hom).sum())
            p.n_ref_ref += int((~cc).sum())

        genotyped = (phred != 0).any(axis=1)
        st.n_genotyped += int(genotyped.sum())
        st.n_passed_calls += int((filt == 0).sum())

        het = c1 != c2
        cov_c1 = cov[sidx, c1]
        cov_c2 = cov[sidx, c2]
        st.het_allele_depth[0] += int(cov_c1[het].sum())
        st.het_allele_depth[1] += int(cov_c2[het].sum())
        st.hom_allele_depth[0] += int(cov_c1[~het].sum())
        st.hom_allele_depth[1] += int((total_depth[~het] - cov_c1[~het]).sum())

        # per-allele het/hom multi-allele depths
        call_depth = total_depth
        h0 = np.zeros(A, dtype=np.int64)
        h1 = np.zeros(A, dtype=np.int64)
        for gt in (c1, c2):
            np.add.at(h0, gt[het], cov[sidx, gt][het])
            np.add.at(h1, gt[het], (call_depth - cov[sidx, gt])[het])
        m0 = np.zeros(A, dtype=np.int64)
        m1 = np.zeros(A, dtype=np.int64)
        np.add.at(m0, c1[~het], cov_c1[~het])
        np.add.at(m1, c1[~het], (call_depth - cov_c1)[~het])
        for a in range(A):
            hh = pa[a].het_multi_allele_depth
            pa[a].het_multi_allele_depth = (hh[0] + int(h0[a]), hh[1] + int(h1[a]))
            mm = pa[a].hom_multi_allele_depth
            pa[a].hom_multi_allele_depth = (mm[0] + int(m0[a]), mm[1] + int(m1[a]))

        if A > 0:
            st.seqdepth += int((total_depth + amb).sum())
            for c in range(1, A):
                pa[c].total_depth += int(cov[:, c].sum())

        ac = np.zeros(A, dtype=np.int64)
        np.add.at(ac, c1, 1)
        np.add.at(ac, c2, 1)
        pass_ac = np.zeros(A, dtype=np.int64)
        pm = filt == 0
        np.add.at(pass_ac, c1[pm], 1)
        np.add.at(pass_ac, c2[pm], 1)
        for a in range(A):
            pa[a].ac += int(ac[a])
            pa[a].pass_ac += int(pass_ac[a])

        st.n_calls += S
        return True

    def _write_stats_infos(self) -> None:
        """VarStats::write_stats (var_stats.cpp)."""
        st = self.stats
        if len(st.per_allele) <= 1:
            return
        infos = self.infos
        infos["CR"] = str(st.clipped_reads)
        infos["MQsquared"] = str(st.mapq_squared)
        rs = st.read_strand
        infos["SBF"] = ",".join(str(x.r1_forward + x.r2_forward) for x in rs)
        infos["SBR"] = ",".join(str(x.r1_reverse + x.r2_reverse) for x in rs)
        infos["SBF1"] = ",".join(str(x.r1_forward) for x in rs)
        infos["SBF2"] = ",".join(str(x.r2_forward) for x in rs)
        infos["SBR1"] = ",".join(str(x.r1_reverse) for x in rs)
        infos["SBR2"] = ",".join(str(x.r2_reverse) for x in rs)
        pa = st.per_allele
        infos["CRal"] = ",".join(str(x.clipped_bp) for x in pa)
        infos["MQSal"] = ",".join(str(x.mapq_squared) for x in pa)
        infos["SDal"] = ",".join(str(x.score_diff) for x in pa)
        infos["MMal"] = ",".join(str(x.mismatches) for x in pa)

    def generate_infos(self, graph=None, is_sv_graph: bool = False) -> list[int]:
        """variant.cpp:430-1096. Returns per-alt is_good_alt flags."""
        num_seqs = len(self.seqs)
        num_alts = num_seqs - 1
        st = self.stats
        is_stats = len(st.per_allele) != 0
        if is_stats and len(st.per_allele) != num_seqs:
            raise ValueError("per_allele size mismatch")
        if is_stats:
            self.scan_calls(is_sv_graph)
            self._write_stats_infos()
        else:
            st.per_allele = VarStats.sized(num_seqs).per_allele
            st.read_strand = VarStats.sized(num_seqs).read_strand
            self.scan_calls(is_sv_graph)

        infos = self.infos
        is_good_alt = [1] * num_alts
        infos["RefLen"] = str(len(self.seqs[0]))

        if "END" in infos and graph is not None:
            contig_pos = graph.abs_pos.get_contig_position(self.abs_pos)[1] if hasattr(graph, "abs_pos") else self.abs_pos
            end = int(float(infos["END"]))
            if end < contig_pos:
                end = contig_pos
            infos["END"] = str(end)

        pa = st.per_allele
        # one pass over the alt alleles builds every per-allele column (the
        # dozen separate generator joins were a measured hot spot)
        maxaas, maxaasr, nhomref, nhet, nhomalt, pexc, acs, afs, pacs = (
            [], [], [], [], [], [], [], [], []
        )
        an2 = 2 * st.n_genotyped
        for e in range(1, num_seqs):
            p = pa[e]
            maxaas.append(str(p.maximum_alt_support))
            maxaasr.append(fmt_g(p.maximum_alt_support_ratio))
            nhomref.append(str(p.n_ref_ref))
            nhet.append(str(p.n_ref_alt))
            nhomalt.append(str(p.n_alt_alt))
            pexc.append(fmt_g(p_hwe_excess_het(p.n_ref_alt, p.n_ref_ref, p.n_alt_alt), 6))
            acs.append(str(p.ac))
            afs.append(fmt_g(p.ac / an2) if an2 > 0 else "0.0")
            pacs.append(str(p.pass_ac))
        infos["MaxAAS"] = ",".join(maxaas)
        infos["MaxAASR"] = ",".join(maxaasr)
        infos["NHomRef"] = ",".join(nhomref)
        infos["NHet"] = ",".join(nhet)
        infos["NHomAlt"] = ",".join(nhomalt)
        infos["PexcessHet"] = ",".join(pexc)
        if self.is_sv():
            infos["MaxAltPP"] = str(st.n_max_alt_proper_pairs)
        infos["AC"] = ",".join(acs)
        infos["AN"] = str(an2)
        infos["AF"] = ",".join(afs)
        infos["PASS_AC"] = ",".join(pacs)
        infos["PASS_AN"] = str(2 * st.n_passed_calls)
        info_pass_ratio = 0.0
        if st.n_genotyped > 0:
            info_pass_ratio = st.n_passed_calls / st.n_genotyped
            infos["PASS_ratio"] = fmt_g(info_pass_ratio)
        infos["SeqDepth"] = str(st.seqdepth)

        info_ab_het = 0.5
        total_het = st.het_allele_depth[0] + st.het_allele_depth[1]
        if total_het > 0:
            info_ab_het = st.het_allele_depth[1] / total_het
            infos["ABHet"] = fmt_g(info_ab_het)
        else:
            infos["ABHet"] = "-1"

        info_abhom = 0.985
        total_hom = st.hom_allele_depth[0] + st.hom_allele_depth[1]
        if total_hom > 0:
            info_abhom = st.hom_allele_depth[0] / total_hom
            infos["ABHom"] = fmt_g(info_abhom)
        else:
            infos["ABHom"] = "-1"

        # SB / SBAlt from the (already written) SBF/SBR infos
        def _acc(key: str, skip_first: bool) -> int:
            if key not in infos:
                return 0
            vals = [int(x) for x in infos[key].split(",") if x]
            return sum(vals[1:]) if skip_first else sum(vals)

        total_f = _acc("SBF", False)
        total_r = _acc("SBR", False)
        infos["SB"] = fmt_g(total_f / (total_f + total_r)) if total_f + total_r else "-1"
        info_sbalt = 0.0
        alt_f = _acc("SBF", True)
        alt_r = _acc("SBR", True)
        if alt_f + alt_r:
            info_sbalt = alt_f / (alt_f + alt_r)
            infos["SBAlt"] = fmt_g(info_sbalt)
        else:
            infos["SBAlt"] = "-1"

        def _ratio_or_neg1(a: int, b: int, first: bool) -> str:
            t = a + b
            if t > 0:
                return fmt_g((a if first else b) / t)
            return "-1"

        infos["ABHetMulti"] = ",".join(
            _ratio_or_neg1(pa[i].het_multi_allele_depth[0], pa[i].het_multi_allele_depth[1], False)
            for i in range(num_seqs)
        )
        infos["ABHomMulti"] = ",".join(
            _ratio_or_neg1(pa[i].hom_multi_allele_depth[0], pa[i].hom_multi_allele_depth[1], True)
            for i in range(num_seqs)
        )
        infos["VarType"] = self.determine_variant_type()

        info_qd = self.get_qual_by_depth()
        infos["QD"] = fmt_g(info_qd)
        qd_alt = self.get_qual_by_depth_per_alt_allele()
        infos["QDalt"] = ",".join(fmt_g(q) for q in qd_alt)

        info_mq = 60
        if st.seqdepth > 0:
            info_mq = round(math.sqrt(st.mapq_squared / st.seqdepth))
            infos["MQ"] = str(info_mq)
        else:
            infos["MQ"] = "0"

        if is_sv_graph:
            for a in range(1, num_seqs):
                is_good_alt[a - 1] = int(pa[a].ac > 0)
            for key in (
                "ABHetMulti", "ABHomMulti", "CR", "QDalt", "MQ", "MQsquared",
                "SB", "SBAlt", "SBF", "SBR", "SBF1", "SBF2", "SBR1", "SBR2",
            ):
                infos.pop(key, None)
            return is_good_alt

        # SDalt, MMalt, CRalt, MQalt
        aa_score = [0.0] * num_alts
        if is_stats:
            sd_l, mm_l, cr_l, mq_l = [], [], [], []
            for s in range(1, num_seqs):
                p = pa[s]
                if p.total_depth > 0:
                    d = float(p.total_depth)
                    sd_l.append(fmt_g(p.score_diff / d, 6))
                    mm_l.append(fmt_g(p.mismatches / d / 10.0, 6))
                    cr_l.append(fmt_g(p.clipped_bp / d / 10.0, 6))
                    mq_l.append(str(round(math.sqrt(p.mapq_squared / d))))
                else:
                    sd_l.append("0.0")
                    mm_l.append("0.0")
                    cr_l.append("0.0")
                    mq_l.append("0")
            infos["SDalt"] = ",".join(sd_l)
            infos["MMalt"] = ",".join(mm_l)
            infos["CRalt"] = ",".join(cr_l)
            infos["MQalt"] = ",".join(mq_l)

            sb_alt = [st.read_strand[s + 1].r1_reverse + st.read_strand[s + 1].r2_reverse for s in range(num_alts)]
            for s in range(num_alts):
                p = pa[s + 1]
                qd = qd_alt[s]
                if p.total_depth > 0 and qd > 0.1 and p.maximum_alt_support >= 2 and p.maximum_alt_support_ratio >= 0.15:
                    d = float(p.total_depth)
                    _sb = 2.0 * ((sb_alt[s] / d) - 0.5)
                    sb = abs(_sb)
                    mm = p.mismatches / d / 10.0
                    sd = round(p.score_diff / d)
                    cr = p.clipped_bp / d / 10.0
                    mq = round(math.sqrt(p.mapq_squared / d))
                    score = get_aa_score(info_abhom, sb, mm, sd, qd, cr, mq)
                    if mm > 1.5:
                        m = max(0.5, 1.0 - ((mm - 1.5) / 20.0))
                        score *= m
                    if (cr + mm) > 2.5:
                        m = max(0.5, 1.0 - ((cr + mm - 2.5) / 40.0))
                        score *= m
                    aa_score[s] = score
                else:
                    aa_score[s] = 0.0
            infos["AAScore"] = ",".join(fmt_g(x) for x in aa_score)

            # LOGF
            info_cr = int(infos["CR"]) if "CR" in infos else 0
            ab_het_bin = int(info_ab_het * 10.0 + 0.00001)
            sbalt_bin = int(info_sbalt * 10.0 + 0.00001)
            cr_by_seqdepth = info_cr / st.seqdepth if st.seqdepth else 0.0
            gt_yield = st.n_genotyped / st.n_calls if st.n_calls else 0.0
            logf = get_logf(info_abhom, cr_by_seqdepth, info_mq, info_pass_ratio, gt_yield, info_qd, ab_het_bin, sbalt_bin)
            infos["LOGF"] = fmt_g(logf)

        for a in range(num_alts):
            p = pa[a + 1]
            if p.total_depth == 0:
                is_good_alt[a] = 0
                continue
            qd = qd_alt[a]
            is_good_alt[a] = int(
                qd >= 1.0
                and p.maximum_alt_support >= 2
                and (num_seqs < 71 or (qd >= 1.5 and p.maximum_alt_support_ratio >= 0.2))
                and (num_seqs < 131 or (qd >= 2.0 and p.maximum_alt_support_ratio >= 0.225))
            )
        return is_good_alt

    def determine_variant_type(self) -> str:
        """variant.cpp:1430-1520 — two-letter VarType code."""
        num_non_ones = 0
        sv_type = None
        for seq in self.seqs:
            if len(seq) > 1:
                if len(seq) > 4 and seq[0:1] == b"<":
                    t = seq[1:4].decode()
                    if t == "DEL" and sv_type in (None, "DEL"):
                        sv_type = "DEL"
                    elif t == "DUP" and sv_type in (None, "DUP"):
                        sv_type = "DUP"
                    elif t == "INS" and sv_type in (None, "INS"):
                        sv_type = "INS"
                    else:
                        sv_type = "OTHER"
                elif b"[" in seq or b"]" in seq:
                    sv_type = "BND" if sv_type in (None, "BND") else "OTHER"
                else:
                    num_non_ones += 1
        if sv_type is not None:
            return {"DEL": "DG", "DUP": "UG", "INS": "FG", "INV": "NG", "BND": "OG"}.get(sv_type, "TG")
        if num_non_ones == 0:
            return "SG"
        if len(self.seqs) - num_non_ones == 1:
            return "IG"
        if len(self.seqs) - num_non_ones == 2 and self.seqs[-1] == b"*":
            return "IG"
        return "XG"


def _remap_call(old_call: SampleCall, n_old: int, n_new: int, old2new: list[int]) -> SampleCall:
    """Project a call through an allele mapping (min-PL, summed AD)."""
    new_phred = np.full(n_new * (n_new + 1) // 2, 255, dtype=np.int64)
    new_cov = np.zeros(n_new, dtype=np.int64)
    for y in range(n_old):
        ny = old2new[y]
        for x in range(y + 1):
            nx = old2new[x]
            idx = to_index(x, y)
            nidx = to_index_safe(nx, ny)
            new_phred[nidx] = min(new_phred[nidx], int(old_call.phred[idx]))
        new_cov[ny] = min(0xFFFF, new_cov[ny] + int(old_call.coverage[y]))
    return SampleCall(
        phred=new_phred,
        coverage=new_cov,
        ambiguous_depth=old_call.ambiguous_depth,
        alt_proper_pair_depth=old_call.alt_proper_pair_depth,
        ref_total_depth=old_call.ref_total_depth,
        alt_total_depth=old_call.alt_total_depth,
    )


def _remap_calls_batch(calls: list, n_old: int, n_new: int, old2new: list[int]) -> list:
    """All samples' calls projected through one allele mapping in a single
    vectorized pass — cohort-scale twin of the per-call loop above (exact:
    the per-step 0xFFFF AD ceiling equals clip-of-sum for non-negative
    addends, and min-PL is order-free). Falls back per call on ragged
    shapes."""
    P_old = n_old * (n_old + 1) // 2
    # small cohorts: the scalar loop beats the ufunc.at dispatch overhead
    if len(calls) < 4 or any(len(c.phred) != P_old or len(c.coverage) != n_old for c in calls):
        return [_remap_call(c, n_old, n_new, old2new) for c in calls]
    # old pair index -> new pair index (same for every sample)
    nidx = np.empty(P_old, dtype=np.int64)
    for y in range(n_old):
        ny = old2new[y]
        for x in range(y + 1):
            nidx[to_index(x, y)] = to_index_safe(old2new[x], ny)
    phred = np.stack([c.phred for c in calls]).astype(np.int64)  # [S, P_old]
    cov = np.stack([c.coverage for c in calls]).astype(np.int64)  # [S, n_old]
    S = len(calls)
    P_new = n_new * (n_new + 1) // 2
    new_phred = np.full((S, P_new), 255, dtype=np.int64)
    np.minimum.at(new_phred, (np.arange(S)[:, None], nidx[None, :]), phred)
    new_cov = np.zeros((S, n_new), dtype=np.int64)
    o2n = np.asarray(old2new, dtype=np.int64)
    np.add.at(new_cov, (np.arange(S)[:, None], o2n[None, :]), cov)
    np.minimum(new_cov, 0xFFFF, out=new_cov)
    return [
        SampleCall(
            phred=new_phred[s],
            coverage=new_cov[s],
            ambiguous_depth=c.ambiguous_depth,
            alt_proper_pair_depth=c.alt_proper_pair_depth,
            ref_total_depth=c.ref_total_depth,
            alt_total_depth=c.alt_total_depth,
        )
        for s, c in enumerate(calls)
    ]


def _update_per_allele_stats(n_old: int, n_new: int, old2new: list[int], old_var: Variant, new_var: Variant) -> None:
    """Project VarStats through an allele mapping (variant.cpp:34-80
    update_per_allele_stats): the new stats are freshly sized, the
    whole-variant scalars (clipped_reads, mapq_squared) copy over, and the
    per-allele alignment accumulators (clipped_bp/mapq_squared/score_diff/
    mismatches) plus read-strand counters merge through the map. The
    scan-derived per-allele fields (qd_*, ac, depths) are NOT carried —
    scan_calls regenerates them on the decomposed record, like the
    reference."""
    if len(old_var.stats.per_allele) != n_old or len(old_var.stats.read_strand) != n_old:
        return
    st = VarStats.sized(n_new)
    st.clipped_reads = old_var.stats.clipped_reads
    st.mapq_squared = old_var.stats.mapq_squared
    for old_a in range(n_old):
        new_a = old2new[old_a]
        oa = old_var.stats.per_allele[old_a]
        na = st.per_allele[new_a]
        na.clipped_bp += oa.clipped_bp
        na.mapq_squared += oa.mapq_squared
        na.score_diff += oa.score_diff
        na.mismatches += oa.mismatches
        st.read_strand[new_a].merge_with(old_var.stats.read_strand[old_a])
    new_var.stats = st


def make_biallelic(var: Variant) -> list[Variant]:
    """variant.cpp:1577-1650."""
    if len(var.seqs) == 2:
        return [var]
    out = []
    for a in range(1, len(var.seqs)):
        nv = Variant(
            abs_pos=var.abs_pos,
            seqs=[var.seqs[0], var.seqs[a]],
            infos=dict(var.infos),
            suffix_id=var.suffix_id,
        )
        old2new = [0] * len(var.seqs)
        old2new[a] = 1
        nv.calls.extend(_remap_calls_batch(var.calls, len(var.seqs), 2, old2new))
        _update_per_allele_stats(len(var.seqs), 2, old2new, var, nv)
        out.append(nv)
    return out


def break_multi_snps(var: Variant) -> list[Variant]:
    """variant.cpp:1996-2110: decompose aligned same-length alleles into
    per-column SNPs, dropping uncalled alleles."""
    seqs = var.seqs
    new_vars: list[Variant] = []
    ac = [0] * len(seqs)
    for call in var.calls:
        g1, g2 = call.get_gt_call()
        ac[g1] += 1
        ac[g2] += 1
    for j in range(len(seqs[0])):
        new_bases = [seqs[0][j : j + 1]]
        old2new = [0]
        for k in range(1, len(seqs)):
            if ac[k] == 0:
                old2new.append(0)
                continue
            b = seqs[k][j : j + 1]
            if b not in new_bases:
                old2new.append(len(new_bases))
                new_bases.append(b)
            else:
                old2new.append(new_bases.index(b))
        if len(new_bases) == 1:
            continue
        nv = Variant(
            abs_pos=var.abs_pos + j,
            seqs=list(new_bases),
            infos=dict(var.infos),
            suffix_id=var.suffix_id,
        )
        nv.calls.extend(_remap_calls_batch(var.calls, len(seqs), len(new_bases), old2new))
        _update_per_allele_stats(len(seqs), len(new_bases), old2new, var, nv)
        new_vars.append(nv)
    return new_vars


def break_down_variant(
    var: Variant,
    graph,
    is_no_variant_overlapping: bool,
    is_all_biallelic: bool,
    no_decompose: bool = False,
) -> list[Variant]:
    """variant.cpp:1652-1713."""
    out: list[Variant] = []
    if no_decompose or (
        len(var.seqs) == 2 and any(c in var.seqs[1] for c in b"<[]")
    ):
        out.append(var)
        return out

    all_same_size = all(len(s) == len(var.seqs[0]) for s in var.seqs[1:])
    if all_same_size:
        if not var.is_with_matching_first_bases():
            var.add_base_in_front(graph, add_N=True)
        out.extend(break_multi_snps(var))
    elif not is_no_variant_overlapping:
        out.extend(break_down_alignment(var, graph))
    else:
        out.append(var)

    if is_all_biallelic:
        out2: list[Variant] = []
        for v in out:
            out2.extend(make_biallelic(v))
        out = out2
    return out


def break_down_alignment(var: Variant, graph) -> list[Variant]:
    """Replacement for break_down_skyr (variant.cpp:2113-2230): align each
    alt against the ref, extract normalized edit events, group them into
    variants, and project PL/AD through the allele->edit mapping."""
    from graphtyper_tpu_torch.utils.msa import extract_variants_from_alignment

    # extend context so left-alignment is possible
    for _ in range(50):
        if not var.add_base_in_front(graph, add_N=False):
            break

    ac = [0] * len(var.seqs)
    for call in var.calls:
        g1, g2 = call.get_gt_call()
        ac[g1] += 1
        ac[g2] += 1

    # treat uncalled alleles as reference (skyr.seqs[i] = skyr.seqs[0])
    eff_seqs = [var.seqs[0]] + [
        var.seqs[i] if ac[i] > 0 else var.seqs[0] for i in range(1, len(var.seqs))
    ]
    events = extract_variants_from_alignment(eff_seqs)

    new_vars: list[Variant] = []
    for pos_offset, ev_seqs, old2new in events:
        nv = Variant(
            abs_pos=var.abs_pos + pos_offset,
            seqs=list(ev_seqs),
            infos=dict(var.infos),
            suffix_id=var.suffix_id,
        )
        if not nv.is_snp_or_snps():
            nv.add_base_in_front(graph, add_N=True)
        nv.calls.extend(_remap_calls_batch(var.calls, len(var.seqs), len(ev_seqs), old2new))
        _update_per_allele_stats(len(var.seqs), len(ev_seqs), old2new, var, nv)
        new_vars.append(nv)
    return new_vars
