"""Bounded path-enumeration extension ("DFS") over the graph.

Reference semantics: src/graph/graph.cpp — get_locations_of_a_position
(:931-1184), get_labels_forward (:1187), get_labels_backward (:1441),
iterative_dfs (:1703). The reference's "DFS" is bounded sequence
enumeration: expand <=128 candidate var+ref sequences from a location and
mismatch-count each against the read tail — already shaped like batched
read-vs-haplotype comparison (the TPU ops build on the same structure).

Sequences are uint8 code arrays (tag chars = 6 reject paths;
N = 4 matches anything) — see count_mismatches (graph_utils.hpp:7-69).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from graphtyper_tpu_torch.constants import INVALID_ID
from graphtyper_tpu_torch.utils.dna import encode_graph

MAX_VAR_AND_REFS = 128
MAX_LOCATIONS = 1024


@dataclass(frozen=True)
class Location:
    node_type: str = "U"  # 'R', 'V', or 'U' (unavailable)
    node_index: int = 0
    node_order: int = 0
    offset: int = 0

    def is_unavailable(self) -> bool:
        return self.node_type == "U"


UNAVAILABLE = Location()


def _ref_codes(graph, r: int) -> np.ndarray:
    cache = getattr(graph, "_ref_codes", None)
    if cache is None:
        cache = {}
        graph._ref_codes = cache
    if r not in cache:
        cache[r] = encode_graph(graph.ref_nodes[r].label.dna)
    return cache[r]


def _var_codes(graph, v: int) -> np.ndarray:
    cache = getattr(graph, "_var_codes", None)
    if cache is None:
        cache = {}
        graph._var_codes = cache
    if v not in cache:
        cache[v] = encode_graph(graph.var_nodes[v].label.dna)
    return cache[v]


def count_mismatches(read: np.ndarray, seq: np.ndarray, max_mismatches: int) -> int:
    """Forward mismatch count over the overlap; tags reject
    (graph_utils.hpp:7-37)."""
    n = min(len(read), len(seq))
    a, b = read[:n], seq[:n]
    if (b == 6).any():
        return max_mismatches + 1
    mism = int(((a != b) & (a < 4) & (b < 4)).sum())  # any ambiguity code matches freely
    return mism


def count_mismatches_backward(read: np.ndarray, seq: np.ndarray, max_mismatches: int) -> int:
    n = min(len(read), len(seq))
    a, b = read[len(read) - n :], seq[len(seq) - n :]
    if (b == 6).any():
        return max_mismatches + 1
    return int(((a != b) & (a < 4) & (b < 4)).sum())


def get_locations_of_a_position(graph, pos: int, path) -> list[Location]:
    is_special = graph.is_special_pos(pos)
    if is_special:
        pos = graph.get_actual_pos(pos)
    return get_locations_of_an_actual_position(graph, pos, path, is_special)


def get_locations_of_an_actual_position(graph, pos: int, path, is_special: bool) -> list[Location]:
    ref_nodes = graph.ref_nodes
    var_nodes = graph.var_nodes
    locs: list[Location] = []
    if not ref_nodes or pos < ref_nodes[0].label.order:
        return locs
    if len(ref_nodes) == 1:
        lbl = ref_nodes[0].label
        locs.append(Location("R", 0, lbl.order, pos - lbl.order))
        return locs

    for r in range(1, len(ref_nodes) + 1):
        if r < len(ref_nodes) and ref_nodes[r].label.order <= pos:
            continue
        rr = r - 1
        lbl = ref_nodes[rr].label
        if pos < lbl.order + len(lbl.dna):
            if not is_special:
                locs.append(Location("R", rr, lbl.order, pos - lbl.order))
                break
            rr -= 1

        padding = 1000000 if graph.is_sv_graph else 1000
        while rr >= 0 and ref_nodes[rr].label.reach() + padding > pos:
            for i, v in enumerate(ref_nodes[rr].out_var_ids):
                vl = var_nodes[v].label
                if vl.order <= pos <= vl.reach():
                    try:
                        j = path.var_order.index(vl.order)
                    except ValueError:
                        continue
                    if path.is_empty() or (j < len(path.nums) and i in path.nums[j]):
                        locs.append(Location("V", v, vl.order, pos - vl.order))
            rr -= 1
        break
    return locs


def _site_ref_reach(graph, v: int) -> int:
    """Reach of the reference allele of v's site."""
    r = graph.var_nodes[v].out_ref_id - 1
    return graph.var_nodes[graph.ref_nodes[r].out_var_ids[0]].label.reach()


def get_labels_forward(graph, s: Location, read: np.ndarray, max_mismatches: int) -> tuple[list, int]:
    """graph.cpp:1187-1438. Returns (labels, updated_max_mismatches); labels
    are (start, end, var_id) tuples."""
    ref_nodes = graph.ref_nodes
    var_nodes = graph.var_nodes
    read_len = len(read)

    seqs: list[np.ndarray] = [None]  # type: ignore
    var_ids: list[list[int]] = [[]]
    end_pos: list[int] = [0]
    vars_: list[int] = []

    if s.node_type == "V":
        var = var_nodes[s.node_index]
        var_ids[0] = [s.node_index]
        seqs[0] = _var_codes(graph, s.node_index)[s.offset :]
        if len(seqs[0]) >= read_len:
            ep = var.label.reach() - (len(seqs[0]) - read_len)
            rr = _site_ref_reach(graph, s.node_index)
            if ep > rr:
                ep = graph.get_special_pos(ep, rr)
            end_pos[0] = ep
        else:
            ref = ref_nodes[var.out_ref_id]
            vars_ = list(ref.out_var_ids)
            seqs[0] = np.concatenate([seqs[0], _ref_codes(graph, var.out_ref_id)])
            end_pos[0] = ref.label.reach() - (len(seqs[0]) - read_len)
    else:
        ref = ref_nodes[s.node_index]
        vars_ = list(ref.out_var_ids)
        seqs[0] = _ref_codes(graph, s.node_index)[s.offset :]
        end_pos[0] = ref.label.reach() - (len(seqs[0]) - read_len)

    if vars_ and len(seqs[0]) < read_len:
        r = var_nodes[vars_[0]].out_ref_id
        all_long_enough = False
        while not all_long_enough and len(seqs) < MAX_VAR_AND_REFS and vars_:
            all_long_enough = True
            ref = ref_nodes[r]
            ref_codes = _ref_codes(graph, r)
            original_size = len(seqs)
            j = 0
            while j < original_size:
                if len(seqs[j]) >= read_len:
                    j += 1
                    continue
                for i in range(len(vars_) - 1):
                    var = var_nodes[vars_[i]]
                    new_seq = np.concatenate([seqs[j], _var_codes(graph, vars_[i])])
                    variant_is_enough = len(new_seq) >= read_len
                    if not variant_is_enough:
                        new_seq = np.concatenate([new_seq, ref_codes])
                    if count_mismatches(read, new_seq, max_mismatches) <= max_mismatches:
                        var_ids.append(var_ids[j] + [vars_[i]])
                        if len(new_seq) < read_len:
                            all_long_enough = False
                        if variant_is_enough:
                            ep = var.label.reach() - (len(new_seq) - read_len)
                            rr_reach = _site_ref_reach(graph, vars_[i])
                            if ep > rr_reach:
                                ep = graph.get_special_pos(ep, rr_reach)
                            end_pos.append(ep)
                        else:
                            end_pos.append(ref.label.reach() - (len(new_seq) - read_len))
                        seqs.append(new_seq)
                # last variant replaces the old seq
                last_v = vars_[-1]
                var = var_nodes[last_v]
                seqs[j] = np.concatenate([seqs[j], _var_codes(graph, last_v)])
                variant_is_enough = len(seqs[j]) >= read_len
                if not variant_is_enough:
                    seqs[j] = np.concatenate([seqs[j], ref_codes])
                if count_mismatches(read, seqs[j], max_mismatches) <= max_mismatches:
                    var_ids[j].append(last_v)
                    if len(seqs[j]) < read_len:
                        all_long_enough = False
                    if variant_is_enough:
                        ep = var.label.reach() - (len(seqs[j]) - read_len)
                        rr_reach = _site_ref_reach(graph, last_v)
                        if ep > rr_reach:
                            ep = graph.get_special_pos(ep, rr_reach)
                        end_pos[j] = ep
                    else:
                        end_pos[j] = ref.label.reach() - (len(seqs[j]) - read_len)
                    j += 1
                else:
                    del seqs[j]
                    del var_ids[j]
                    del end_pos[j]
                    original_size -= 1
            if not all_long_enough:
                vars_ = list(ref_nodes[r].out_var_ids)
                r += 1
            else:
                break

    # choose best candidates
    best_var_ids: list[list[int]] = []
    best_end_pos: list[int] = []
    for j in range(len(seqs)):
        if len(seqs[j]) < read_len:
            continue
        mism = count_mismatches(read, seqs[j], max_mismatches)
        if mism > max_mismatches:
            continue
        if mism < max_mismatches:
            max_mismatches = mism
            best_var_ids = [var_ids[j]]
            best_end_pos = [end_pos[j]]
        else:
            best_var_ids.append(var_ids[j])
            best_end_pos.append(end_pos[j])

    labels = []
    if best_var_ids:
        start_pos = s.node_order + s.offset
        if s.node_type == "V":
            rr = _site_ref_reach(graph, s.node_index)
            if start_pos > rr:
                start_pos = graph.get_special_pos(start_pos, rr)
        for ids, ep in zip(best_var_ids, best_end_pos):
            if not ids:
                labels.append((start_pos, ep, INVALID_ID))
            else:
                for good_var in ids:
                    labels.append((start_pos, ep, good_var))
    return labels, max_mismatches


def get_labels_backward(graph, e: Location, read: np.ndarray, max_mismatches: int) -> tuple[list, int]:
    """graph.cpp:1441-1700 (mirror of forward)."""
    ref_nodes = graph.ref_nodes
    var_nodes = graph.var_nodes
    read_len = len(read)

    seqs: list[np.ndarray] = [None]  # type: ignore
    var_ids: list[list[int]] = [[]]
    start_pos: list[int] = [0]
    vars_: list[int] = []

    if e.node_type == "V":
        var = var_nodes[e.node_index]
        var_ids[0] = [e.node_index]
        seqs[0] = _var_codes(graph, e.node_index)[: e.offset + 1]
        if len(seqs[0]) >= read_len:
            sp = var.label.order + (len(seqs[0]) - read_len)
            rr = _site_ref_reach(graph, e.node_index)
            if sp > rr:
                sp = graph.get_special_pos(sp, rr)
            start_pos[0] = sp
        else:
            r = var.out_ref_id - 1
            ref = ref_nodes[r]
            seqs[0] = np.concatenate([_ref_codes(graph, r), seqs[0]])
            start_pos[0] = ref.label.order + (len(seqs[0]) - read_len)
            if r != 0:
                vars_ = list(ref_nodes[r - 1].out_var_ids)
    else:
        ref = ref_nodes[e.node_index]
        if e.node_index != 0:
            vars_ = list(ref_nodes[e.node_index - 1].out_var_ids)
        seqs[0] = _ref_codes(graph, e.node_index)[: e.offset + 1]
        start_pos[0] = ref.label.order + (len(seqs[0]) - read_len)

    if vars_ and len(seqs[0]) < read_len:
        r = var_nodes[vars_[0]].out_ref_id - 1
        all_long_enough = False
        while not all_long_enough and len(seqs) < MAX_VAR_AND_REFS and vars_:
            all_long_enough = True
            ref = ref_nodes[r]
            ref_codes = _ref_codes(graph, r)
            original_size = len(seqs)
            j = 0
            while j < original_size:
                if len(seqs[j]) >= read_len:
                    j += 1
                    continue
                for i in range(len(vars_) - 1):
                    if len(seqs[j]) < read_len:
                        var = var_nodes[vars_[i]]
                        new_seq = np.concatenate([_var_codes(graph, vars_[i]), seqs[j]])
                        variant_is_enough = len(new_seq) >= read_len
                        if not variant_is_enough:
                            new_seq = np.concatenate([ref_codes, new_seq])
                        if count_mismatches_backward(read, new_seq, max_mismatches) <= max_mismatches:
                            var_ids.append(var_ids[j] + [vars_[i]])
                            if len(new_seq) < read_len:
                                all_long_enough = False
                            if variant_is_enough:
                                sp = var.label.order + (len(new_seq) - read_len)
                                rr_reach = _site_ref_reach(graph, vars_[i])
                                if sp > rr_reach:
                                    sp = graph.get_special_pos(sp, rr_reach)
                                start_pos.append(sp)
                            else:
                                start_pos.append(ref.label.order + (len(new_seq) - read_len))
                            seqs.append(new_seq)
                last_v = vars_[-1]
                var = var_nodes[last_v]
                seqs[j] = np.concatenate([_var_codes(graph, last_v), seqs[j]])
                variant_is_enough = len(seqs[j]) >= read_len
                if not variant_is_enough:
                    seqs[j] = np.concatenate([ref_codes, seqs[j]])
                if count_mismatches_backward(read, seqs[j], max_mismatches) <= max_mismatches:
                    var_ids[j].append(last_v)
                    if len(seqs[j]) < read_len:
                        all_long_enough = False
                    if variant_is_enough:
                        sp = var.label.order + (len(seqs[j]) - read_len)
                        rr_reach = _site_ref_reach(graph, last_v)
                        if sp > rr_reach:
                            sp = graph.get_special_pos(sp, rr_reach)
                        start_pos[j] = sp
                    else:
                        start_pos[j] = ref.label.order + (len(seqs[j]) - read_len)
                    j += 1
                else:
                    del seqs[j]
                    del var_ids[j]
                    del start_pos[j]
                    original_size -= 1
            if not all_long_enough:
                if r != 0:
                    r -= 1
                    vars_ = list(ref_nodes[r].out_var_ids)
                else:
                    vars_ = []
                    break
            else:
                break

    best_var_ids: list[list[int]] = []
    best_start_pos: list[int] = []
    for j in range(len(seqs)):
        if len(seqs[j]) < read_len:
            continue
        mism = count_mismatches_backward(read, seqs[j], max_mismatches)
        if mism < max_mismatches:
            max_mismatches = mism
            best_var_ids = [var_ids[j]]
            best_start_pos = [start_pos[j]]
        elif mism == max_mismatches:
            best_var_ids.append(var_ids[j])
            best_start_pos.append(start_pos[j])

    labels = []
    if best_var_ids:
        end_pos = e.node_order + e.offset
        if e.node_type == "V":
            rr = _site_ref_reach(graph, e.node_index)
            if end_pos > rr:
                end_pos = graph.get_special_pos(end_pos, rr)
        for ids, sp in zip(best_var_ids, best_start_pos):
            if not ids:
                labels.append((sp, end_pos, INVALID_ID))
            else:
                for good_var in ids:
                    labels.append((sp, end_pos, good_var))
    return labels, max_mismatches


def iterative_dfs(graph, start_locations: list[Location], end_locations: list[Location], subread: np.ndarray, max_mismatches: int) -> tuple[list, int]:
    """graph.cpp:1703-1760."""
    labels: list = []
    if len(start_locations) > MAX_LOCATIONS or len(end_locations) > MAX_LOCATIONS:
        return labels, max_mismatches

    def add_if_better(new_labels, mism):
        nonlocal labels, max_mismatches
        if new_labels:
            if mism < max_mismatches:
                max_mismatches = mism
                labels = new_labels
            elif mism == max_mismatches:
                labels = labels + new_labels

    if len(start_locations) == 1 and start_locations[0].is_unavailable():
        for e in end_locations:
            new_labels, mism = get_labels_backward(graph, e, subread, max_mismatches)
            add_if_better(new_labels, mism)
    else:
        for s in start_locations:
            new_labels, mism = get_labels_forward(graph, s, subread, max_mismatches)
            add_if_better(new_labels, mism)
    return labels, max_mismatches
