"""Alignment paths through the graph.

Reference semantics: src/typer/path.cpp / include/graphtyper/typer/path.hpp.
A Path covers read[read_start_index..read_end_index] and maps it to graph
positions [start, end] (possibly special positions); `var_order`/`nums` hold,
per overlapped variant site, the set of allele numbers consistent with the
read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from graphtyper_tpu_torch.constants import INVALID_ID


@dataclass
class Path:
    start: int = 0
    end: int = 0
    read_start_index: int = 0
    read_end_index: int = 0
    var_order: list[int] = field(default_factory=list)
    nums: list[set[int]] = field(default_factory=list)
    mismatches: int = 0

    @classmethod
    def from_label(cls, graph, start: int, end: int, var_id: int, read_start: int, read_end: int, mismatches: int = 0) -> "Path":
        p = cls(start=start, end=end, read_start_index=read_start, read_end_index=read_end, mismatches=mismatches)
        if var_id != INVALID_ID:
            p.var_order.append(graph.var_nodes[var_id].label.order)
            p.nums.append({graph.get_variant_num(var_id)})
        return p

    @classmethod
    def merge(cls, graph, p1: "Path", p2: "Path") -> "Path":
        """Path(p1, p2) c'tor (path.cpp:38-82): take p2, intersect shared
        sites, union the rest; adopt p1's start. If an intersection empties,
        the merge failed (detectable by read_start_index mismatch)."""
        np_ = cls(
            start=p2.start,
            end=p2.end,
            read_start_index=p2.read_start_index,
            read_end_index=p2.read_end_index,
            var_order=list(p2.var_order),
            nums=[set(s) for s in p2.nums],
            mismatches=p2.mismatches,
        )
        for i in range(len(p1.var_order)):
            found = False
            for j in range(len(np_.var_order)):
                if p1.var_order[i] == np_.var_order[j]:
                    np_.nums[j] &= p1.nums[i]
                    if not np_.nums[j]:
                        return np_  # failed merge: read_start_index stays p2's
                    found = True
                    break
            if not found:
                np_.var_order.append(p1.var_order[i])
                np_.nums.append(set(p1.nums[i]))
        np_.read_start_index = p1.read_start_index
        np_.start = p1.start
        np_.mismatches += p1.mismatches
        return np_

    def merge_with_current(self, graph, var_id: int) -> None:
        if var_id == INVALID_ID:
            return
        order = graph.var_nodes[var_id].label.order
        num = graph.get_variant_num(var_id)
        for i, vo in enumerate(self.var_order):
            if vo == order:
                self.nums[i].add(num)
                return
        self.var_order.append(order)
        self.nums.append({num})

    def erase_var_order(self, index: int) -> None:
        del self.var_order[index]
        del self.nums[index]

    def clone(self) -> "Path":
        """Fast deep copy (the per-read dedup path in the caller clones the
        shared alignment once per duplicate read; deepcopy is ~10x slower)."""
        return Path(
            self.start,
            self.end,
            self.read_start_index,
            self.read_end_index,
            list(self.var_order),
            [set(s) for s in self.nums],
            self.mismatches,
        )

    def size(self) -> int:
        return self.read_end_index - self.read_start_index + 1

    def start_ref_reach_pos(self, graph) -> int:
        return graph.get_ref_reach_pos(self.start)

    def end_ref_reach_pos(self, graph) -> int:
        return graph.get_ref_reach_pos(self.end)

    def start_correct_pos(self, graph) -> int:
        return graph.get_actual_pos(self.start)

    def end_correct_pos(self, graph) -> int:
        return graph.get_actual_pos(self.end)

    def is_reference(self) -> bool:
        return all(0 in num for num in self.nums)

    def is_purely_reference(self) -> bool:
        return all(0 in num and len(num) == 1 for num in self.nums)

    def is_empty(self) -> bool:
        return self.start == self.end


def find_all_nonduplicated_paths(graph, labels, read_start: int, read_end: int, mismatches: int) -> list[Path]:
    """genotype_paths.cpp:32-67 — group labels with identical (start,end)
    into one path whose nums accumulate allele numbers."""
    if not labels:
        return []
    paths = [Path.from_label(graph, labels[0][0], labels[0][1], labels[0][2], read_start, read_end, mismatches)]
    for start, end, var_id in labels[1:]:
        for p in paths:
            if start == p.start and end == p.end:
                p.merge_with_current(graph, var_id)
                break
        else:
            paths.append(Path.from_label(graph, start, end, var_id, read_start, read_end, mismatches))
    return paths
