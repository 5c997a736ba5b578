"""Amplicon primer masking.

Reference semantics: src/typer/primers.cpp — read BEDPE left/right primer
regions; mask allele support of variants whose path endpoint lies in a
primer region (check_left for forward reads via path.start, check_right for
reverse reads via path.end; erase_ref_support drops the site if the path
supports the reference there). Hooked before scoring
(vcf_writer.cpp:88-143).
"""

from __future__ import annotations

from graphtyper_tpu_torch.constants import IS_REVERSED
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.graph.dfs import get_locations_of_a_position

PADDING = 5


class Primers:
    def __init__(self, primer_bedpe: str, graph):
        self.left: list[GenomicRegion] = []
        self.right: list[GenomicRegion] = []
        self.graph = graph
        with open(primer_bedpe) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 6:
                    raise ValueError(f"BEDPE line needs >= 6 fields: {line!r}")
                self.left.append(GenomicRegion.make(fields[0], int(fields[1]), int(fields[2])))
                self.right.append(GenomicRegion.make(fields[3], int(fields[4]), int(fields[5])))

    def _var_orders_in(self, abs_begin: int, abs_end: int) -> list[int]:
        """graph.get_var_orders: site orders within [abs_begin, abs_end]."""
        out = []
        for gt in self.graph.genotypes():
            if abs_begin <= gt.id <= abs_end:
                out.append(gt.id)
        return out

    def check(self, genos) -> None:
        if genos.flags & IS_REVERSED:
            self._check_side(genos, right_side=True)
        else:
            self._check_side(genos, right_side=False)

    def _check_side(self, genos, right_side: bool) -> None:
        regions = self.right if right_side else self.left
        for path in genos.paths:
            if not path.var_order:
                continue
            pos_attr = path.end if right_side else path.start
            locs = get_locations_of_a_position(self.graph, pos_attr, path)
            for region in regions:
                if right_side:
                    abs_begin = region.begin + 1
                    abs_end = region.end + PADDING
                else:
                    abs_begin = max(region.begin + 1 - PADDING, 1)
                    abs_end = region.end
                for loc in locs:
                    pos = loc.node_order + loc.offset
                    if abs_begin <= pos <= abs_end:
                        var_orders = self._var_orders_in(abs_begin, abs_end)
                        for i in range(len(path.var_order) - 1, -1, -1):
                            if path.var_order[i] in var_orders:
                                # erase site if the path supports reference
                                if 0 in path.nums[i]:
                                    path.erase_var_order(i)
