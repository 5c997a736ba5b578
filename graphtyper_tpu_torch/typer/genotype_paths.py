"""GenotypePaths: the per-read (per-orientation) path set and its merge /
walk / filter pipeline.

Reference semantics: src/typer/genotype_paths.cpp — add_next/prev_kmer_labels
(:230-345), walk_read_starts/ends (:484-621), filters (:355-480),
compare_pair_of_genotype_paths (:943-1169).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.constants import (
    INSERT_SIZE_WHEN_NOT_PROPER_PAIR,
    K,
    MAX_NUM_LOCATIONS_PER_PATH,
    MAX_SEED_NUMBER_ALLOWING_MISMATCHES,
    MAX_SEED_NUMBER_FOR_WALKING,
)
from graphtyper_tpu_torch.graph.dfs import (
    UNAVAILABLE,
    get_locations_of_a_position,
    iterative_dfs,
)
from graphtyper_tpu_torch.typer.path import Path, find_all_nonduplicated_paths


@dataclass
class GenotypePaths:
    flags: int = 0
    read_length: int = 0
    paths: list[Path] = field(default_factory=list)
    longest_path_length: int = 0
    original_pos: int = 0
    score_diff: int = 0
    mapq: int = 255
    ml_insert_size: int = INSERT_SIZE_WHEN_NOT_PROPER_PAIR
    read2: np.ndarray | None = None  # read codes (set after alignment)
    qual2: np.ndarray | None = None

    def clone(self) -> "GenotypePaths":
        """Fast deep copy; read2/qual2 arrays are shared (only reassigned,
        never mutated in place, by update_paths)."""
        return GenotypePaths(
            flags=self.flags,
            read_length=self.read_length,
            paths=[p.clone() for p in self.paths],
            longest_path_length=self.longest_path_length,
            original_pos=self.original_pos,
            score_diff=self.score_diff,
            mapq=self.mapq,
            ml_insert_size=self.ml_insert_size,
            read2=self.read2,
            qual2=self.qual2,
        )

    def longest_path_size(self) -> int:
        return self.longest_path_length

    def all_paths_unique(self) -> bool:
        for i in range(1, len(self.paths)):
            if (
                self.paths[0].start != self.paths[i].start
                and self.paths[0].end != self.paths[i].end
            ):
                return False
        return True

    def all_paths_fully_aligned(self) -> bool:
        return all(p.size() == self.read_length for p in self.paths)

    def is_purely_reference(self) -> bool:
        return all(p.is_purely_reference() for p in self.paths)

    # -- label merging ---------------------------------------------------

    def add_next_kmer_labels(self, graph, labels, read_start: int, read_end: int, mismatches: int) -> None:
        pp = find_all_nonduplicated_paths(graph, labels, read_start, read_end, mismatches)
        original_size = len(self.paths)
        matched = [False] * len(pp)
        for i in range(original_size):
            if self.paths[i].read_end_index != read_start:
                continue
            matched_once = False
            original_path = self.paths[i]
            for j, p in enumerate(pp):
                if original_path.end == p.start and original_path.read_end_index == p.read_start_index:
                    np_ = Path.merge(graph, original_path, p)
                    if np_.start != original_path.start or np_.read_start_index != original_path.read_start_index:
                        continue
                    matched[j] = True
                    if matched_once:
                        self.paths.append(np_)
                    else:
                        self.longest_path_length = max(np_.size(), self.longest_path_length)
                        self.paths[i] = np_
                        matched_once = True
        for j, m in enumerate(matched):
            if not m:
                self.longest_path_length = max(pp[j].size(), self.longest_path_length)
                self.paths.append(pp[j])

    def add_prev_kmer_labels(self, graph, labels, read_start: int, read_end: int, mismatches: int) -> None:
        pp = find_all_nonduplicated_paths(graph, labels, read_start, read_end, mismatches)
        original_size = len(self.paths)
        matched = [False] * len(pp)
        for i in range(original_size):
            if self.paths[i].read_start_index != read_end:
                continue
            matched_once = False
            original_path = self.paths[i]
            for j, p in enumerate(pp):
                if p.end == original_path.start and p.read_end_index == original_path.read_start_index:
                    np_ = Path.merge(graph, p, original_path)
                    if np_.read_start_index != p.read_start_index:
                        continue
                    matched[j] = True
                    if matched_once:
                        self.paths.append(np_)
                    else:
                        self.longest_path_length = max(np_.size(), self.longest_path_length)
                        self.paths[i] = np_
                        matched_once = True
        for j, m in enumerate(matched):
            if not m:
                self.longest_path_length = max(pp[j].size(), self.longest_path_length)
                self.paths.append(pp[j])

    # -- walks -----------------------------------------------------------

    def walk_read_ends(self, graph, seq: np.ndarray, maximum_mismatches: int = -1) -> None:
        if not self.paths or self.paths[0].size() == len(seq):
            return
        if len(self.paths) > MAX_SEED_NUMBER_FOR_WALKING:
            return
        if len(self.paths) > MAX_SEED_NUMBER_ALLOWING_MISMATCHES:
            maximum_mismatches = 0
        best_mismatches = 7
        best_end_indexes: list[int] = []
        best_labels: list[list] = []
        for path in self.paths:
            if path.read_end_index == len(seq) - 1:
                continue
            s_locs = get_locations_of_a_position(graph, path.end, path)
            if not s_locs or len(s_locs) > MAX_NUM_LOCATIONS_PER_PATH:
                continue
            kmer = seq[path.read_end_index :]
            mismatches = (
                min(2 + len(kmer) // 11, best_mismatches) if maximum_mismatches < 0 else maximum_mismatches
            )
            new_labels, mismatches = iterative_dfs(graph, s_locs, [UNAVAILABLE], kmer, mismatches)
            if new_labels:
                if mismatches < best_mismatches:
                    best_labels = [new_labels]
                    best_end_indexes = [path.read_end_index]
                    best_mismatches = mismatches
                elif mismatches == best_mismatches:
                    best_labels.append(new_labels)
                    best_end_indexes.append(path.read_end_index)
        for labels, end_idx in zip(best_labels, best_end_indexes):
            self.add_next_kmer_labels(graph, labels, end_idx, len(seq) - 1, best_mismatches)

    def walk_read_starts(self, graph, seq: np.ndarray, maximum_mismatches: int = -1) -> None:
        if not self.paths or self.paths[0].size() == len(seq):
            return
        if len(self.paths) > MAX_SEED_NUMBER_FOR_WALKING:
            return
        if len(self.paths) > MAX_SEED_NUMBER_ALLOWING_MISMATCHES:
            maximum_mismatches = 0
        best_mismatches = 7
        best_start_indexes: list[int] = []
        best_labels: list[list] = []
        for path in self.paths:
            if path.read_start_index == 0:
                continue
            kmer = seq[: path.read_start_index + 1]
            e_locs = get_locations_of_a_position(graph, path.start, path)
            if not e_locs or len(e_locs) > MAX_NUM_LOCATIONS_PER_PATH:
                continue
            mismatches = (
                min(2 + len(kmer) // 11, best_mismatches) if maximum_mismatches < 0 else maximum_mismatches
            )
            new_labels, mismatches = iterative_dfs(graph, [UNAVAILABLE], e_locs, kmer, mismatches)
            if new_labels:
                if mismatches < best_mismatches:
                    best_labels = [new_labels]
                    best_start_indexes = [path.read_start_index]
                    best_mismatches = mismatches
                elif mismatches == best_mismatches:
                    best_labels.append(new_labels)
                    best_start_indexes.append(path.read_start_index)
        for labels, start_idx in zip(best_labels, best_start_indexes):
            self.add_prev_kmer_labels(graph, labels, 0, start_idx, best_mismatches)

    # -- filters ---------------------------------------------------------

    def update_longest_path_size(self) -> None:
        self.longest_path_length = max((p.size() for p in self.paths), default=0)

    def remove_short_paths(self) -> None:
        self.paths = [p for p in self.paths if p.size() >= self.longest_path_length]

    def remove_paths_with_too_many_mismatches(self) -> None:
        if not self.paths:
            return
        min_mismatches = min(10, min(p.mismatches for p in self.paths))
        self.paths = [p for p in self.paths if p.mismatches <= min_mismatches]

    def remove_non_ref_paths_when_read_matches_ref(self) -> None:
        if self.all_paths_unique():
            return
        if any(p.is_reference() for p in self.paths):
            self.paths = [p for p in self.paths if p.is_reference()]

    def remove_fully_special_paths(self, graph) -> None:
        self.paths = [
            p for p in self.paths if p.start_ref_reach_pos(graph) != p.end_ref_reach_pos(graph)
        ]

    def remove_support_from_read_ends(self, graph) -> None:
        """SV-mode trimming of allele support near special-position path ends
        (genotype_paths.cpp:370-430)."""
        MIN_OFFSET = 4
        for path in self.paths:
            if not path.var_order:
                continue
            if not graph.is_special_pos(path.start) and not graph.is_special_pos(path.end):
                continue
            min_vo = min(path.var_order)
            max_vo = max(path.var_order)
            if graph.is_special_pos(path.end) and path.end_correct_pos(graph) <= max_vo + MIN_OFFSET:
                idx = path.var_order.index(max_vo)
                path.nums[idx].clear()
            if graph.is_special_pos(path.start):
                if graph.is_special_pos(path.start + MIN_OFFSET):
                    ambiguous = path.start_ref_reach_pos(graph) != graph.get_ref_reach_pos(path.start + MIN_OFFSET)
                else:
                    ambiguous = True
                if ambiguous:
                    idx = path.var_order.index(min_vo)
                    path.nums[idx].clear()


def compare_single(geno1: GenotypePaths, geno2: GenotypePaths) -> int:
    """Single-read orientation choice (genotype_paths.cpp:943-974)."""
    m1 = geno1.longest_path_size()
    m2 = geno2.longest_path_size()
    MINIMUM_PATH_SIZE = 94
    if m1 > m2 and m1 > MINIMUM_PATH_SIZE:
        return 1
    if m2 > m1 and m2 > MINIMUM_PATH_SIZE:
        return 2
    if m1 == m2 and m1 > MINIMUM_PATH_SIZE:
        return 1 if geno1.paths[0].mismatches <= geno2.paths[0].mismatches else 2
    return 0


def compare_pairs(g1f: GenotypePaths, g1s: GenotypePaths, g2f: GenotypePaths, g2s: GenotypePaths) -> int:
    """Pair orientation choice (genotype_paths.cpp:976-1160)."""
    m11 = g1f.longest_path_size() if g1f.paths else 0
    m12 = g1s.longest_path_size() if g1s.paths else 0
    m21 = g2f.longest_path_size() if g2f.paths else 0
    m22 = g2s.longest_path_size() if g2s.paths else 0
    max1 = max(m11, m12)
    max2 = max(m21, m22)
    perfect1 = g1f.read_length
    perfect2 = g1s.read_length
    MINIMUM_PATH_SIZE = 94

    if (m11 >= perfect1 and m12 >= perfect2) or (m21 >= perfect1 and m22 >= perfect2):
        if (m11 >= perfect1 and m12 >= perfect2) and (m21 >= perfect1 and m22 >= perfect2):
            mm1 = g1f.paths[0].mismatches + g1s.paths[0].mismatches
            mm2 = g2f.paths[0].mismatches + g2s.paths[0].mismatches
            if mm1 < mm2:
                return 1
            if mm2 < mm1:
                return 2
            np1 = len(g1f.paths) + len(g1s.paths)
            np2 = len(g2f.paths) + len(g2s.paths)
            if np1 < np2:
                return 1
            if np2 < np1:
                return 2

            def alt_count(paths: list[Path]) -> int:
                return sum(1 for p in paths for num in p.nums if 0 not in num)

            c1 = alt_count(g1f.paths) + alt_count(g1s.paths)
            c2 = alt_count(g2f.paths) + alt_count(g2s.paths)
            return 1 if c1 >= c2 else 2
        if m11 >= perfect1 and m12 >= perfect2:
            return 1
        return 2
    if max2 >= MINIMUM_PATH_SIZE and max2 > max1:
        return 2
    if max1 >= MINIMUM_PATH_SIZE and max1 > max2:
        return 1
    if max1 >= MINIMUM_PATH_SIZE and max2 >= MINIMUM_PATH_SIZE:
        mm1 = 10
        if m11 == max1 and g1f.paths:
            mm1 = min(mm1, g1f.paths[0].mismatches)
        if m12 == max1 and g1s.paths:
            mm1 = min(mm1, g1s.paths[0].mismatches)
        mm2 = 10
        if m21 == max2 and g2f.paths:
            mm2 = min(mm2, g2f.paths[0].mismatches)
        if m22 == max2 and g2s.paths:
            mm2 = min(mm2, g2s.paths[0].mismatches)
        if mm1 < mm2:
            return 1
        if mm2 < mm1:
            return 2
        if min(m11, m12) < min(m21, m22):
            return 1
        if min(m21, m22) < min(m11, m12):
            return 2
        return 0
    if max2 == 0 and m11 >= 63 and m12 >= 63:
        return 1
    if max1 == 0 and m21 >= 63 and m22 >= 63:
        return 2
    return 1  # fallback needed for SV calling
