"""The pangenome graph: an acyclic chain of alternating reference segments
and variant-site bubbles.

Reference semantics: src/graph/graph.cpp (add_genomic_region merge windows,
add_reference/add_variants chain construction, special positions, check).
Data layout is ours: nodes are built as light Python objects on the host and
`finalize()` exports dense numpy arrays (GraphTensors) — the device-facing
form used by the k-mer index and the alignment/genotyping kernels.

Node topology invariant (node.hpp): ref_nodes[r] --> var_nodes[v..v+deg) -->
ref_nodes[r+1]; var node labels all share `order` = site position (1-based,
contig-local), variant_num = allele index; the LAST ref node has out_degree 0.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.constants import (
    MAX_INDEL_MERGE_DIST,
    MAX_NUMBER_OF_HAPLOTYPES,
    MAX_VAR_MERGE_DIST,
    SPECIAL_START,
)
from graphtyper_tpu_torch.graph.coords import AbsolutePosition, Contig, GenomicRegion
from graphtyper_tpu_torch.graph.records import Allele, VarRecord
from graphtyper_tpu_torch.utils.dna import encode

_ACGTN_OK = np.zeros(256, dtype=bool)
_ACGTN_OK[list(b"ACGTN")] = True


@dataclass
class Label:
    order: int  # 1-based contig-local start position
    dna: bytes
    variant_num: int = 0

    def reach(self) -> int:
        """Last position this label covers (label.hpp reach = order+len-1)."""
        return self.order + len(self.dna) - 1


@dataclass
class RefNode:
    label: Label
    out_var_ids: list[int] = field(default_factory=list)

    @property
    def out_degree(self) -> int:
        return len(self.out_var_ids)


@dataclass
class VarNode:
    label: Label
    out_ref_id: int = 0
    events: set[int] = field(default_factory=set)
    anti_events: set[int] = field(default_factory=set)


@dataclass
class Genotype:
    """A variant site (graph 'genotype'): position, allele count, first var
    node id (genotype.hpp)."""

    id: int  # order of the site
    num: int  # number of alleles (out_degree of the ref node)
    first_variant_node: int


class Graph:
    def __init__(self) -> None:
        self._ref_nodes: list[RefNode] | None = []
        self._var_nodes: list[VarNode] | None = []
        self.is_sv_graph = False
        self.genomic_region = GenomicRegion()
        self.reference: bytes = b""
        self.contigs: list[Contig] = []
        self.svs: list = []  # SV records (graph/sv.py)
        # special positions (graph.cpp:384-411)
        self.ref_reach_poses: list[int] = []
        self.actual_poses: list[int] = []
        self.ref_reach_to_special_pos: dict[int, list[int]] = {}
        self._abs_pos: AbsolutePosition | None = None
        self._flat: GraphFlat | None = None

    # ------------------------------------------------------------------
    # Node views: graphs built by add_genomic_region are flat-first (arrays
    # are canonical); Python node objects materialize lazily for the
    # oracle/test consumers (dfs walk, hla, path.py, cli).
    # ------------------------------------------------------------------

    @property
    def ref_nodes(self) -> list[RefNode]:
        if self._ref_nodes is None:
            self._materialize_nodes()
        return self._ref_nodes

    @property
    def var_nodes(self) -> list[VarNode]:
        if self._var_nodes is None:
            self._materialize_nodes()
        return self._var_nodes

    def _materialize_nodes(self) -> None:
        f = self._flat
        assert f is not None
        ref_nodes: list[RefNode] = []
        var_nodes: list[VarNode] = []
        rb, vb = f.ref_bytes, f.var_bytes
        for r in range(len(f.ref_order)):
            s = int(f.ref_dna_start[r])
            dna = rb[s : s + int(f.ref_dna_len[r])]
            ref_nodes.append(
                RefNode(
                    Label(int(f.ref_order[r]), dna, 0),
                    list(range(int(f.ref_var_first[r]), int(f.ref_var_first[r + 1]))),
                )
            )
        prev_ref = -1
        variant_num = 0
        for v in range(len(f.var_order)):
            s = int(f.var_dna_start[v])
            dna = vb[s : s + int(f.var_dna_len[v])]
            out_ref = int(f.var_out_ref[v])
            if out_ref != prev_ref:
                variant_num = 0
                prev_ref = out_ref
            var_nodes.append(
                VarNode(
                    Label(int(f.var_order[v]), dna, variant_num),
                    out_ref,
                    set(int(x) for x in f.ev_vals[f.ev_off[v] : f.ev_off[v + 1]]),
                    set(int(x) for x in f.anti_vals[f.anti_off[v] : f.anti_off[v + 1]]),
                )
            )
            variant_num += 1
        self._ref_nodes = ref_nodes
        self._var_nodes = var_nodes

    @property
    def abs_pos(self) -> AbsolutePosition:
        """Contig-offset coordinate converter (reference's global
        gyper::absolute_pos, built from this graph's contigs)."""
        if self._abs_pos is None or len(self._abs_pos.offsets) != len(self.contigs):
            self._abs_pos = AbsolutePosition(self.contigs)
        return self._abs_pos

    @abs_pos.setter
    def abs_pos(self, value: AbsolutePosition) -> None:
        self._abs_pos = value

    # ------------------------------------------------------------------
    # Construction (graph.cpp add_genomic_region)
    # ------------------------------------------------------------------

    def add_genomic_region(
        self,
        reference_sequence: bytes,
        var_records: list[VarRecord],
        region: GenomicRegion,
        add_all_variants: bool = False,
    ) -> None:
        self.genomic_region = region

        # Drop alt alleles containing N or empty (graph.cpp:49-58)
        for var in var_records:
            var.alts = [a for a in var.alts if a.seq and b"N" not in a.seq]
        # Drop records with N/* in ref, no alts, or before region begin
        var_records = [
            r
            for r in var_records
            if b"N" not in r.ref.seq and b"*" not in r.ref.seq and r.alts and r.pos >= region.begin
        ]
        # Truncate records at/after region end (graph.cpp:73-80)
        for v, rec in enumerate(var_records):
            if rec.pos >= region.end:
                var_records = var_records[:v]
                break

        if add_all_variants:
            self._merge_overlapping_all(var_records, reference_sequence, region)
        elif self.is_sv_graph:
            self._merge_overlapping_sv(var_records)
        else:
            self._merge_overlapping_plain(var_records)

        # Erase alts identical to ref; then empty records (graph.cpp:243-258)
        for rec in var_records:
            rec.alts = [a for a in rec.alts if a.seq != rec.ref.seq]
        var_records = [r for r in var_records if r.alts]

        for rec in var_records:
            if len(rec.alts) >= MAX_NUMBER_OF_HAPLOTYPES - 1:
                rec.alts = rec.alts[: MAX_NUMBER_OF_HAPLOTYPES - 2]

        for rec in var_records:
            rec.trim_common_suffix()

        assert all(
            var_records[i].pos <= var_records[i + 1].pos for i in range(len(var_records) - 1)
        )
        for rec in var_records:
            rec.alts.sort(key=lambda a: a.seq)

        self._build_flat(reference_sequence, var_records, region)
        self.reference = reference_sequence

    def _build_flat(
        self, reference_sequence: bytes, var_records: list[VarRecord], region: GenomicRegion
    ) -> None:
        """Array-form equivalent of the _add_reference/_add_variants chain
        loop (graph.cpp:548-625): records are sorted and non-overlapping
        here, so ref node r spans [prev record end, record r start)."""
        begin = region.begin
        ref_limit = len(reference_sequence) + begin
        n = len(var_records)
        ref_order = np.empty(n + 1, dtype=np.int64)
        ref_parts: list[bytes] = []
        ref_len = np.empty(n + 1, dtype=np.int64)
        ref_var_first = np.empty(n + 2, dtype=np.int64)
        ref_var_first[0] = 0
        nv = sum(len(r.alts) + 1 for r in var_records)
        var_order = np.empty(nv, dtype=np.int64)
        var_parts: list[bytes] = []
        var_len = np.empty(nv, dtype=np.int64)
        var_out_ref = np.empty(nv, dtype=np.int64)
        ev_lists: list[list[int]] = []
        anti_lists: list[list[int]] = []
        prev_end = begin
        v = 0
        for i, rec in enumerate(var_records):
            start = min(max(prev_end, begin), ref_limit)
            end = min(max(rec.pos, start), ref_limit)
            ref_order[i] = start + 1
            dna = reference_sequence[start - begin : end - begin]
            ref_parts.append(dna)
            ref_len[i] = len(dna)
            ref_var_first[i + 1] = ref_var_first[i] + len(rec.alts) + 1
            for allele in (rec.ref, *rec.alts):
                var_order[v] = rec.pos + 1
                var_parts.append(allele.seq)
                var_len[v] = len(allele.seq)
                var_out_ref[v] = i + 1
                ev_lists.append(sorted(allele.events))
                anti_lists.append(sorted(allele.anti_events))
                v += 1
            prev_end = rec.pos + len(rec.ref.seq)
        start = min(max(prev_end, begin), ref_limit)
        ref_order[n] = start + 1
        dna = reference_sequence[start - begin :]
        ref_parts.append(dna)
        ref_len[n] = len(dna)
        ref_var_first[n + 1] = ref_var_first[n]

        ref_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ref_len[:-1], out=ref_start[1:])
        var_start = np.zeros(nv, dtype=np.int64)
        if nv:
            np.cumsum(var_len[:-1], out=var_start[1:])
        ev_off = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum([len(x) for x in ev_lists], out=ev_off[1:])
        anti_off = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum([len(x) for x in anti_lists], out=anti_off[1:])
        self._flat = GraphFlat(
            ref_order=ref_order,
            ref_dna_start=ref_start,
            ref_dna_len=ref_len,
            ref_var_first=ref_var_first,
            ref_bytes=b"".join(ref_parts),
            var_order=var_order,
            var_dna_start=var_start,
            var_dna_len=var_len,
            var_out_ref=var_out_ref,
            var_bytes=b"".join(var_parts),
            sp_ref_reach=np.zeros(0, dtype=np.int64),
            sp_actual=np.zeros(0, dtype=np.int64),
            ev_off=ev_off,
            ev_vals=np.array([x for xs in ev_lists for x in xs], dtype=np.int64),
            anti_off=anti_off,
            anti_vals=np.array([x for xs in anti_lists for x in xs], dtype=np.int64),
        )
        self._ref_nodes = None
        self._var_nodes = None

    def _merge_overlapping_all(
        self, var_records: list[VarRecord], reference_sequence: bytes, region: GenomicRegion
    ) -> None:
        """add-all-variants merge pass (graph.cpp:82-170): merge records within
        MAX_VAR_MERGE_DIST (SNPs) / MAX_INDEL_MERGE_DIST (others)."""
        i = 0
        n = len(var_records)
        while i < n:
            while i + 1 < n:
                curr = var_records[i]
                nxt = var_records[i + 1]
                if nxt.pos > curr.pos + len(curr.ref.seq) + MAX_VAR_MERGE_DIST:
                    break
                if (not curr.is_snp_or_snps() or not nxt.is_snp_or_snps()) and nxt.pos > (
                    curr.pos + len(curr.ref.seq) + MAX_INDEL_MERGE_DIST
                ):
                    break
                if nxt.pos >= curr.end_pos() and (
                    len(curr.alts) > 42
                    or len(nxt.alts) > 42
                    or curr.is_any_seq_larger_than(20)
                    or nxt.is_any_seq_larger_than(20)
                ):
                    break
                if (len(curr.alts) + 1) * (len(nxt.alts) + 1) >= (MAX_NUMBER_OF_HAPLOTYPES - 1):
                    nxt.merge_one_path(curr)
                else:
                    if nxt.pos > curr.end_pos():
                        start = curr.end_pos() - region.begin
                        end = nxt.pos - region.begin
                        curr.add_suffix(reference_sequence[start:end])
                        assert nxt.pos == curr.end_pos()
                    nxt.merge_all(curr)
                if len(nxt.alts) >= MAX_NUMBER_OF_HAPLOTYPES - 1:
                    nxt.alts = nxt.alts[: MAX_NUMBER_OF_HAPLOTYPES - 1]
                var_records[i] = VarRecord()  # cleared
                i += 1
            i += 1
        var_records[:] = [r for r in var_records if r.alts]

    def _merge_overlapping_plain(self, var_records: list[VarRecord]) -> None:
        """Default merge pass (graph.cpp:216-240): merge only true overlaps;
        within 4bp or >100 alts use one-path merge, else suffix merge(4)."""
        i = 0
        n = len(var_records)
        while i < n:
            while i + 1 < n and var_records[i + 1].pos < var_records[i].end_pos():
                curr = var_records[i]
                nxt = var_records[i + 1]
                if len(curr.alts) > 100 or (nxt.pos - curr.pos) < 4:
                    nxt.merge_one_path(curr)
                else:
                    nxt.merge(curr, 4)
                var_records[i] = VarRecord()
                i += 1
            i += 1
        var_records[:] = [r for r in var_records if r.alts]

    def _merge_overlapping_sv(self, var_records: list[VarRecord]) -> None:
        """SV-graph merge pass (graph.cpp:174-213)."""
        i = 0
        n = len(var_records)
        while i < n:
            while i + 1 < n and var_records[i + 1].pos < var_records[i].end_pos():
                curr = var_records[i]
                nxt = var_records[i + 1]
                if curr.is_sv and nxt.is_sv:
                    nxt.merge_one_path(curr)
                elif curr.is_sv:
                    var_records[i + 1] = curr  # SV wins, drop small variant
                elif nxt.is_sv:
                    pass  # drop previous small variant
                elif len(curr.alts) > 100 or (nxt.pos - curr.pos) < 4:
                    nxt.merge_one_path(curr)
                else:
                    nxt.merge(curr, 4)
                var_records[i] = VarRecord()
                i += 1
            i += 1
        var_records[:] = [r for r in var_records if r.alts]

    def _add_reference(self, end_pos: int, num_var: int, reference_sequence: bytes) -> None:
        """graph.cpp:585-625. Legacy node-object chain builder — production
        builds flat arrays (_build_flat); this stays as the differential
        oracle (tests/graph/test_build_flat_fuzz.py LegacyGraph)."""
        begin = self.genomic_region.begin
        if end_pos > len(reference_sequence) + begin:
            end_pos = len(reference_sequence) + begin
        start_pos = begin
        if self.var_nodes:
            prev_label = self.var_nodes[self.ref_nodes[-1].out_var_ids[0]].label
            start_pos = prev_label.order - 1 + len(prev_label.dna)
        end_pos = max(start_pos, end_pos)
        dna = reference_sequence[start_pos - begin : end_pos - begin]
        var_ids = [len(self.var_nodes) + i for i in range(num_var)]
        self.ref_nodes.append(RefNode(Label(start_pos + 1, dna, 0), var_ids))

    def _add_variants(self, record: VarRecord) -> None:
        """graph.cpp:548-582."""
        ref_allele: Allele = record.ref
        self.var_nodes.append(
            VarNode(
                Label(record.pos + 1, ref_allele.seq, 0),
                len(self.ref_nodes),
                set(ref_allele.events),
                set(ref_allele.anti_events),
            )
        )
        for i, alt in enumerate(record.alts):
            self.var_nodes.append(
                VarNode(Label(record.pos + 1, alt.seq, i + 1), len(self.ref_nodes), set(alt.events), set(alt.anti_events))
            )

    # ------------------------------------------------------------------
    # Special positions (graph.cpp:384-411, 1712-1760)
    # ------------------------------------------------------------------

    def create_special_positions(self) -> None:
        self.ref_reach_to_special_pos.clear()
        self.ref_reach_poses.clear()
        self.actual_poses.clear()
        if self._ref_nodes is None and self._flat is not None:
            f = self._flat
            reach = f.var_order + f.var_dna_len - 1  # label reach per var node
            for r in range(len(f.ref_order) - 1):
                lo, hi = int(f.ref_var_first[r]), int(f.ref_var_first[r + 1])
                if hi - lo <= 1:
                    continue
                ref_label_reach = int(reach[lo])
                max_var_reach = int(reach[lo + 1 : hi].max())
                for p in range(ref_label_reach + 1, max_var_reach + 1):
                    self.add_special_pos(p, ref_label_reach)
            f.sp_ref_reach = np.asarray(self.ref_reach_poses, dtype=np.int64)
            f.sp_actual = np.asarray(self.actual_poses, dtype=np.int64)
            return
        for r in range(len(self.ref_nodes) - 1):
            rn = self.ref_nodes[r]
            if rn.out_degree <= 1:
                continue
            out_vars = rn.out_var_ids
            ref_label_reach = self.var_nodes[out_vars[0]].label.reach()
            max_var_reach = max(self.var_nodes[v].label.reach() for v in out_vars[1:])
            for reach in range(ref_label_reach + 1, max_var_reach + 1):
                self.add_special_pos(reach, ref_label_reach)
        if self._flat is not None:
            self._flat.sp_ref_reach = np.asarray(self.ref_reach_poses, dtype=np.int64)
            self._flat.sp_actual = np.asarray(self.actual_poses, dtype=np.int64)

    def add_special_pos(self, actual_pos: int, ref_reach: int) -> None:
        self.ref_reach_poses.append(ref_reach)
        self.actual_poses.append(actual_pos)
        self.ref_reach_to_special_pos.setdefault(ref_reach, []).append(
            SPECIAL_START + len(self.ref_reach_poses) - 1
        )

    def get_special_pos(self, pos: int, ref_reach: int) -> int:
        return self.ref_reach_to_special_pos[ref_reach][pos - ref_reach - 1]

    def is_special_pos(self, pos: int) -> bool:
        return pos >= SPECIAL_START and (pos - SPECIAL_START) < len(self.ref_reach_poses)

    def get_ref_reach_pos(self, pos: int) -> int:
        return self.ref_reach_poses[pos - SPECIAL_START] if self.is_special_pos(pos) else pos

    def get_actual_pos(self, pos: int) -> int:
        return self.actual_poses[pos - SPECIAL_START] if self.is_special_pos(pos) else pos

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    def first_ref_order(self) -> int:
        """Order of the first ref node (0 for an empty graph) without
        materializing node objects."""
        if self._ref_nodes is None and self._flat is not None:
            return int(self._flat.ref_order[0]) if len(self._flat.ref_order) else 0
        return self.ref_nodes[0].label.order if self.ref_nodes else 0

    def size(self) -> int:
        if self._ref_nodes is None and self._flat is not None:
            return len(self._flat.ref_order) + len(self._flat.var_order)
        return len(self.ref_nodes) + len(self.var_nodes)

    def get_all_ref(self) -> bytes:
        """Reconstruct the region reference by walking ref + ref-allele var
        nodes (graph.cpp:352-375)."""
        if not self.ref_nodes:
            return b""
        out = bytearray()
        v = 0
        r = 0
        while self.ref_nodes[r].out_degree != 0:
            out += self.ref_nodes[r].label.dna
            out += self.var_nodes[v].label.dna
            v += self.ref_nodes[r].out_degree
            r += 1
        out += self.ref_nodes[r].label.dna
        return bytes(out)

    def genotypes(self) -> list[Genotype]:
        """One Genotype per variant site (graph.cpp get_all_haplotypes)."""
        if self._ref_nodes is None and self._flat is not None:
            f = self._flat
            return [
                Genotype(
                    int(f.var_order[f.ref_var_first[r]]),
                    int(f.ref_var_first[r + 1] - f.ref_var_first[r]),
                    int(f.ref_var_first[r]),
                )
                for r in range(len(f.ref_order) - 1)
            ]
        out = []
        v = 0
        for r in range(len(self.ref_nodes) - 1):
            rn = self.ref_nodes[r]
            out.append(Genotype(self.var_nodes[v].label.order, rn.out_degree, v))
            v += rn.out_degree
        return out

    def get_genotype_seqs(self, gt: Genotype) -> list[bytes]:
        """All allele sequences of a site (graph.cpp:822-843)."""
        if self._ref_nodes is None and self._flat is not None:
            f = self._flat
            r = int(f.var_out_ref[gt.first_variant_node]) - 1
            return [
                f.var_bytes[int(f.var_dna_start[v]) : int(f.var_dna_start[v]) + int(f.var_dna_len[v])]
                for v in range(int(f.ref_var_first[r]), int(f.ref_var_first[r + 1]))
            ]
        r = self.var_nodes[gt.first_variant_node].out_ref_id - 1
        return [self.var_nodes[v].label.dna for v in self.ref_nodes[r].out_var_ids]

    def get_variant_num(self, v: int) -> int:
        if self._ref_nodes is None and self._flat is not None:
            f = self._flat
            return v - int(f.ref_var_first[int(f.var_out_ref[v]) - 1])
        return v - self.ref_nodes[self.var_nodes[v].out_ref_id - 1].out_var_ids[0]

    def is_snp(self, gt: Genotype) -> bool:
        """True iff every allele of the site is a single base (graph.cpp:2026)."""
        if self._ref_nodes is None and self._flat is not None:
            f = self._flat
            v = gt.first_variant_node
            r = int(f.var_out_ref[v]) - 1
            return bool(
                (f.var_dna_len[f.ref_var_first[r] : f.ref_var_first[r + 1]] == 1).all()
            )
        v = gt.first_variant_node
        if len(self.var_nodes[v].label.dna) > 1:
            return False
        r = self.var_nodes[v].out_ref_id - 1
        for o in range(1, self.ref_nodes[r].out_degree):
            if len(self.var_nodes[v + o].label.dna) > 1:
                return False
        return True

    def check(self) -> bool:
        """ACGTN-only (tags allowed in var nodes), nonempty var dna,
        increasing order (graph.cpp:1809-1813)."""
        if self._ref_nodes is None and self._flat is not None:
            f = self._flat
            ref_arena, var_arena = f.ref_bytes, f.var_bytes
            orders = f.ref_order
            var_slices = lambda: (  # noqa: E731 — lazy per-node views
                var_arena[int(f.var_dna_start[v]) : int(f.var_dna_start[v]) + int(f.var_dna_len[v])]
                for v in range(len(f.var_order))
            )
            any_empty_var = bool((f.var_dna_len == 0).any()) if len(f.var_dna_len) else False
        else:
            ref_arena = b"".join(rn.label.dna for rn in self.ref_nodes)
            var_arena = b"".join(vn.label.dna for vn in self.var_nodes)
            orders = np.fromiter(
                (rn.label.order for rn in self.ref_nodes), dtype=np.int64, count=len(self.ref_nodes)
            )
            var_slices = lambda: (vn.label.dna for vn in self.var_nodes)  # noqa: E731
            any_empty_var = any(len(vn.label.dna) == 0 for vn in self.var_nodes)
        if ref_arena and not _ACGTN_OK[np.frombuffer(ref_arena, dtype=np.uint8)].all():
            return False
        if any_empty_var:
            return False
        if var_arena and not _ACGTN_OK[np.frombuffer(var_arena, dtype=np.uint8)].all():
            # Slow path only when a non-ACGTN byte exists: SV tag spans
            # (`<...>`) never cross node boundaries, so scan per node.
            for dna in var_slices():
                i = 0
                while i < len(dna):
                    c = dna[i]
                    if c == ord("<"):
                        while i < len(dna) and dna[i] != ord(">"):
                            i += 1
                    elif c not in b"ACGTN":
                        return False
                    i += 1
        return bool((np.diff(orders) >= 0).all()) if len(orders) else True

    # ------------------------------------------------------------------
    # Serialization (replaces cereal; graph_serialization.hpp)
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        meta = {
            "is_sv_graph": self.is_sv_graph,
            "region": [self.genomic_region.chr, self.genomic_region.begin, self.genomic_region.end],
            "contigs": [[c.name, c.length] for c in self.contigs],
            "svs": [sv.to_dict() for sv in self.svs],
        }
        f = self.flat()
        ref_orders = f.ref_order
        ref_dna = np.frombuffer(f.ref_bytes, dtype=np.uint8)
        ref_dna_len = f.ref_dna_len
        ref_out_deg = np.diff(f.ref_var_first)
        var_orders = f.var_order
        var_dna = np.frombuffer(f.var_bytes, dtype=np.uint8)
        var_dna_len = f.var_dna_len
        var_out_ref = f.var_out_ref
        events_json = json.dumps(
            [
                [
                    [int(x) for x in f.ev_vals[f.ev_off[v] : f.ev_off[v + 1]]],
                    [int(x) for x in f.anti_vals[f.anti_off[v] : f.anti_off[v + 1]]],
                ]
                for v in range(len(f.var_order))
            ]
        )
        np.savez_compressed(
            path,
            meta=json.dumps(meta),
            ref_orders=ref_orders,
            ref_dna=ref_dna,
            ref_dna_len=ref_dna_len,
            ref_out_deg=ref_out_deg,
            var_orders=var_orders,
            var_dna=var_dna,
            var_dna_len=var_dna_len,
            var_out_ref=var_out_ref,
            events=events_json,
            reference=np.frombuffer(self.reference, dtype=np.uint8),
            ref_reach_poses=np.array(self.ref_reach_poses, dtype=np.int64),
            actual_poses=np.array(self.actual_poses, dtype=np.int64),
        )

    @classmethod
    def load(cls, path: str) -> "Graph":
        z = np.load(path, allow_pickle=False)
        g = cls()
        meta = json.loads(str(z["meta"]))
        g.is_sv_graph = meta["is_sv_graph"]
        g.genomic_region = GenomicRegion(meta["region"][0], meta["region"][1], meta["region"][2])
        g.contigs = [Contig(n, l) for n, l in meta["contigs"]]
        from graphtyper_tpu_torch.graph.sv import SV

        g.svs = [SV.from_dict(d) for d in meta.get("svs", [])]
        events = json.loads(str(z["events"]))
        ref_dna = z["ref_dna"].tobytes()
        var_dna = z["var_dna"].tobytes()
        ro = 0
        var_id = 0
        for i, (order, dlen, deg) in enumerate(
            zip(z["ref_orders"], z["ref_dna_len"], z["ref_out_deg"])
        ):
            dna = ref_dna[ro : ro + int(dlen)]
            ro += int(dlen)
            g.ref_nodes.append(RefNode(Label(int(order), dna, 0), [var_id + k for k in range(int(deg))]))
            var_id += int(deg)
        vo = 0
        variant_num = 0
        prev_ref = -1
        for i, (order, dlen, out_ref) in enumerate(
            zip(z["var_orders"], z["var_dna_len"], z["var_out_ref"])
        ):
            dna = var_dna[vo : vo + int(dlen)]
            vo += int(dlen)
            if int(out_ref) != prev_ref:
                variant_num = 0
                prev_ref = int(out_ref)
            ev, aev = events[i]
            g.var_nodes.append(
                VarNode(Label(int(order), dna, variant_num), int(out_ref), set(ev), set(aev))
            )
            variant_num += 1
        g.reference = z["reference"].tobytes()
        for rr, ap in zip(z["ref_reach_poses"], z["actual_poses"]):
            g.add_special_pos(int(ap), int(rr))
        return g

    # ------------------------------------------------------------------
    # Device export
    # ------------------------------------------------------------------

    def finalize(self) -> "GraphTensors":
        return GraphTensors.from_graph(self)

    def flat(self) -> "GraphFlat":
        """Cached flat-array view shared by the native aligner and the native
        index builder (one flatten pass per graph instead of one per
        consumer). Invalidated never: graphs are immutable after
        construct_graph returns."""
        if getattr(self, "_flat", None) is None:
            self._flat = GraphFlat.from_nodes(self)
        return self._flat


@dataclass
class GraphFlat:
    """Flat host-side arrays of the graph chain — the layout every native
    entry point consumes (see native/gt_align.cpp gt_align_batch and
    native/gt_native.cpp gt_index_graph). DNA arenas are kept as raw bytes;
    the two encodings used downstream (graph-label vs index) are derived
    lazily and cached."""

    ref_order: np.ndarray  # [R] int64
    ref_dna_start: np.ndarray  # [R] int64
    ref_dna_len: np.ndarray  # [R] int64
    ref_var_first: np.ndarray  # [R+1] int64 (cumsum of out-degrees)
    ref_bytes: bytes
    var_order: np.ndarray  # [V] int64
    var_dna_start: np.ndarray  # [V] int64
    var_dna_len: np.ndarray  # [V] int64
    var_out_ref: np.ndarray  # [V] int64
    var_bytes: bytes
    sp_ref_reach: np.ndarray  # [P] int64
    sp_actual: np.ndarray  # [P] int64
    ev_off: np.ndarray  # [V+1] int64
    ev_vals: np.ndarray  # int64 (sorted within each node)
    anti_off: np.ndarray  # [V+1] int64
    anti_vals: np.ndarray  # int64

    _arena_cache: dict = field(default_factory=dict)

    @classmethod
    def from_nodes(cls, g: "Graph") -> "GraphFlat":
        ref_len = np.fromiter(
            (len(rn.label.dna) for rn in g.ref_nodes), dtype=np.int64, count=len(g.ref_nodes)
        )
        ref_start = np.zeros(len(ref_len), dtype=np.int64)
        if len(ref_len):
            np.cumsum(ref_len[:-1], out=ref_start[1:])
        deg = np.fromiter(
            (rn.out_degree for rn in g.ref_nodes), dtype=np.int64, count=len(g.ref_nodes)
        )
        ref_var_first = np.zeros(len(deg) + 1, dtype=np.int64)
        np.cumsum(deg, out=ref_var_first[1:])
        var_len = np.fromiter(
            (len(vn.label.dna) for vn in g.var_nodes), dtype=np.int64, count=len(g.var_nodes)
        )
        var_start = np.zeros(len(var_len), dtype=np.int64)
        if len(var_len):
            np.cumsum(var_len[:-1], out=var_start[1:])
        ev_lists = [sorted(vn.events) for vn in g.var_nodes]
        anti_lists = [sorted(vn.anti_events) for vn in g.var_nodes]
        ev_off = np.zeros(len(ev_lists) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in ev_lists], out=ev_off[1:])
        anti_off = np.zeros(len(anti_lists) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in anti_lists], out=anti_off[1:])
        return cls(
            ref_order=np.fromiter(
                (rn.label.order for rn in g.ref_nodes), dtype=np.int64, count=len(g.ref_nodes)
            ),
            ref_dna_start=ref_start,
            ref_dna_len=ref_len,
            ref_var_first=ref_var_first,
            ref_bytes=b"".join(rn.label.dna for rn in g.ref_nodes),
            var_order=np.fromiter(
                (vn.label.order for vn in g.var_nodes), dtype=np.int64, count=len(g.var_nodes)
            ),
            var_dna_start=var_start,
            var_dna_len=var_len,
            var_out_ref=np.fromiter(
                (vn.out_ref_id for vn in g.var_nodes), dtype=np.int64, count=len(g.var_nodes)
            ),
            var_bytes=b"".join(vn.label.dna for vn in g.var_nodes),
            sp_ref_reach=np.asarray(g.ref_reach_poses, dtype=np.int64),
            sp_actual=np.asarray(g.actual_poses, dtype=np.int64),
            ev_off=ev_off,
            ev_vals=np.array([x for xs in ev_lists for x in xs], dtype=np.int64),
            anti_off=anti_off,
            anti_vals=np.array([x for xs in anti_lists for x in xs], dtype=np.int64),
        )

    def arena(self, which: str, encoding) -> np.ndarray:
        """Encoded DNA arena, cached per (which, encoding)."""
        key = (which, encoding)
        hit = self._arena_cache.get(key)
        if hit is None:
            raw = self.ref_bytes if which == "ref" else self.var_bytes
            hit = np.ascontiguousarray(encoding(raw))
            self._arena_cache[key] = hit
        return hit


@dataclass
class GraphTensors:
    """Dense-array view of the graph for device-side ops.

    DNA arenas hold uint8 codes; node tables are flat int arrays. Variant
    sites are the unit of genotyping: site s covers var nodes
    [site_var_start[s], site_var_start[s] + site_num_alleles[s]).
    """

    ref_order: np.ndarray  # [R] int64 1-based start positions
    ref_dna_start: np.ndarray  # [R] into ref_arena
    ref_dna_len: np.ndarray  # [R]
    ref_out_deg: np.ndarray  # [R]
    ref_arena: np.ndarray  # uint8 codes
    var_order: np.ndarray  # [V]
    var_dna_start: np.ndarray  # [V] into var_arena
    var_dna_len: np.ndarray  # [V]
    var_out_ref: np.ndarray  # [V]
    var_arena: np.ndarray  # uint8 codes
    site_order: np.ndarray  # [S] site positions
    site_num_alleles: np.ndarray  # [S]
    site_var_start: np.ndarray  # [S] first var node id

    @classmethod
    def from_graph(cls, g: Graph) -> "GraphTensors":
        f = g.flat()
        sites = g.genotypes()
        return cls(
            ref_order=f.ref_order,
            ref_dna_start=f.ref_dna_start,
            ref_dna_len=f.ref_dna_len,
            ref_out_deg=np.diff(f.ref_var_first),
            ref_arena=f.arena("ref", encode),
            var_order=f.var_order,
            var_dna_start=f.var_dna_start,
            var_dna_len=f.var_dna_len,
            var_out_ref=f.var_out_ref,
            var_arena=f.arena("var", encode),
            site_order=np.array([s.id for s in sites], dtype=np.int64),
            site_num_alleles=np.array([s.num for s in sites], dtype=np.int64),
            site_var_start=np.array([s.first_variant_node for s in sites], dtype=np.int64),
        )
