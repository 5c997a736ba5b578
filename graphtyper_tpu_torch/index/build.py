"""K-mer index construction over the pangenome graph.

Reference semantics: src/index/indexer.cpp — a rolling list of partial k-mer
entries walks every ref/var label; entries crossing variant bubbles fork per
allele (with path-explosion caps MAX_TOTAL_VAR_NUM=181 / MAX_TOTAL_VAR_COUNT=4,
indexer.cpp:15-19), honor anti-event phasing constraints (:114-140), and var-
node-internal end positions map to special positions (:147). Each completed
32-mer emits KmerLabel(start_index, end_index, variant_id) per traversed var
node.

Our layout: emission goes straight into flat arrays; `finalize` sorts them
into a device-friendly (sorted kmers + CSR labels) structure instead of the
reference's hash map. Long pure-reference stretches are emitted vectorized
(numpy) instead of walking base-by-base.
"""

from __future__ import annotations


import numpy as np

from graphtyper_tpu_torch.constants import INVALID_ID, K, MAX_TOTAL_VAR_COUNT, MAX_TOTAL_VAR_NUM
from graphtyper_tpu_torch.graph.graph import Graph
from graphtyper_tpu_torch.index.kmer_index import KmerIndex
from graphtyper_tpu_torch.utils.dna import encode, pack_kmers

_MASK = (1 << (2 * K)) - 1


class IndexEntry:
    """A partial k-mer being extended (index_entry.cpp)."""

    __slots__ = ("start_index", "dna", "length", "valid", "variant_ids", "events", "anti_events", "total_var_num", "total_var_count")

    def __init__(self, start_index: int, var_id: int | None = None, is_reference: bool = True, var_num: int = 1):
        self.start_index = start_index
        self.dna = 0
        self.length = 0
        self.valid = 0
        self.variant_ids: set[int] = set() if var_id is None else {var_id}
        self.events: set[int] = set()
        self.anti_events: set[int] = set()
        self.total_var_num = var_num if var_id is not None else 1
        self.total_var_count = 0 if (var_id is None or is_reference) else 1

    def copy(self) -> "IndexEntry":
        e = IndexEntry(self.start_index)
        e.dna = self.dna
        e.length = self.length
        e.valid = self.valid
        e.variant_ids = set(self.variant_ids)
        e.events = set(self.events)
        e.anti_events = set(self.anti_events)
        e.total_var_num = self.total_var_num
        e.total_var_count = self.total_var_count
        return e

    def add_to_dna(self, code: int) -> None:
        self.dna = ((self.dna << 2) & _MASK)
        self.length += 1
        if self.valid > 0:
            self.valid -= 1
        elif code < 4:
            self.dna += code
        else:
            self.valid = K


class _Emitter:
    """Accumulates (kmer, start, end, var_id) label tuples in flat lists."""

    def __init__(self) -> None:
        self.kmers: list[int] = []
        self.starts: list[int] = []
        self.ends: list[int] = []
        self.var_ids: list[int] = []

    def emit_entry(self, entry: IndexEntry, end_index: int) -> None:
        if entry.valid > 0:
            return
        if not entry.variant_ids:
            self.kmers.append(entry.dna)
            self.starts.append(entry.start_index)
            self.ends.append(end_index)
            self.var_ids.append(INVALID_ID)
        else:
            for var_id in sorted(entry.variant_ids):
                self.kmers.append(entry.dna)
                self.starts.append(entry.start_index)
                self.ends.append(end_index)
                self.var_ids.append(var_id)

    def emit_bulk(self, kmers: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> None:
        self.kmers.extend(kmers.tolist())
        self.starts.extend(starts.tolist())
        self.ends.extend(ends.tolist())
        self.var_ids.extend([INVALID_ID] * len(kmers))


def _entry_has_too_many_nonrefs(entry: IndexEntry) -> bool:
    return entry.total_var_count > 1 and (
        entry.total_var_num > MAX_TOTAL_VAR_NUM or entry.total_var_count > MAX_TOTAL_VAR_COUNT
    )


def index_reference_label(em: _Emitter, mers: list[list[IndexEntry]], order: int, codes: np.ndarray) -> None:
    """indexer.cpp:26-81 with a vectorized fast path for long labels."""
    L = len(codes)
    d = 0
    # generic walk over the first min(K-1, L) bases to complete older entries
    walk_until = min(K - 1, L)
    _walk_ref(em, mers, order, codes, 0, walk_until)
    d = walk_until
    if L - d >= K:
        # All kmers starting at positions [p0, L-K] lie fully inside the label.
        # Entries currently in mers all started inside this label too (older
        # ones completed during the walk) and are pure-reference — the bulk
        # emission covers them. Reset and emit vectorized.
        mers.clear()
        kmers, valid = pack_kmers(codes, K)
        pos = np.flatnonzero(valid)
        starts = order + pos
        em.emit_bulk(kmers[pos], starts, starts + K - 1)
        # Re-seed partial entries for the trailing K-1 bases (after any N)
        tail_start = L - (K - 1)
        bad = np.flatnonzero(codes[tail_start:] >= 4)
        if len(bad):
            tail_start = tail_start + int(bad[-1]) + 1
        mers.clear()
        codes_l = codes.tolist()
        val = 0
        tail_entries = []
        for i in range(L - 1, tail_start - 1, -1):
            # entry starting at i has bases codes[i:L]; its packed dna is the
            # big-endian suffix value (no N past tail_start, so valid=0)
            val |= codes_l[i] << (2 * (L - 1 - i))
            e = IndexEntry(order + i)
            e.dna = val
            e.length = L - i
            tail_entries.append([e])
        mers.extend(tail_entries)
        # mers[0] = newest (length 1) ... mers[-1] = oldest
    else:
        _walk_ref(em, mers, order, codes, d, L)


def _walk_ref(em: _Emitter, mers: list[list[IndexEntry]], order: int, codes: np.ndarray, begin: int, end: int) -> None:
    for d in range(begin, end):
        code = int(codes[d])
        if code >= 4:
            mers.clear()
            continue
        for sublist in mers:
            for e in sublist:
                e.add_to_dna(code)
        e = IndexEntry(order + d)
        e.add_to_dna(code)
        mers.insert(0, [e])
        if len(mers) >= K:
            for q in mers[-1]:
                if q.valid > 0:
                    continue
                em.emit_entry(q, order + d)
            mers.pop()


def insert_variant_label(
    em: _Emitter,
    mers: list[list[IndexEntry]],
    graph: Graph,
    v: int,
    is_reference: bool,
    var_count: int,
    ref_reach: int,
) -> None:
    """indexer.cpp:84-177."""
    var_node = graph.var_nodes[v]
    label = var_node.label
    codes = encode(label.dna)
    for d in range(len(codes)):
        code = int(codes[d])
        if code >= 4:
            mers.clear()
            continue
        for sublist in mers:
            kept = []
            for e in sublist:
                if e.anti_events & var_node.events:
                    continue  # anti-phased: drop this partial kmer
                e.add_to_dna(code)
                e.events |= var_node.events
                e.anti_events |= var_node.anti_events
                e.variant_ids.add(v)
                kept.append(e)
            sublist[:] = kept
        pos = label.order + d
        if pos > ref_reach:
            pos = graph.get_special_pos(pos, ref_reach)
        e = IndexEntry(pos, v, is_reference, var_count)
        e.add_to_dna(code)
        e.events = set(var_node.events)
        e.anti_events = set(var_node.anti_events)
        mers.insert(0, [e])
        if len(mers) >= K:
            for q in mers[-1]:
                if q.valid > 0:
                    continue
                em.emit_entry(q, pos)
            mers.pop()


def _append_list(mers: list[list[IndexEntry]], other: list[list[IndexEntry]]) -> None:
    while len(mers) < len(other):
        mers.append([])
    for i, sub in enumerate(other):
        mers[i].extend(sub)


def index_variant(em: _Emitter, graph: Graph, mers: list[list[IndexEntry]], var_count: int, v: int) -> None:
    """indexer.cpp:213-244."""
    clean_list = [[e.copy() for e in sub] for sub in mers]
    ref_label_reach = graph.var_nodes[v].label.reach()
    insert_variant_label(em, mers, graph, v, True, 1, ref_label_reach)

    # penalize entries that will traverse an alt allele
    for sub in clean_list:
        for e in sub:
            e.total_var_num *= var_count
            e.total_var_count += 1
        sub[:] = [e for e in sub if not _entry_has_too_many_nonrefs(e)]
    var_num = var_count

    while var_count > 2:
        var_count -= 1
        v += 1
        new_list = [[e.copy() for e in sub] for sub in clean_list]
        insert_variant_label(em, new_list, graph, v, False, var_num, ref_label_reach)
        _append_list(mers, new_list)

    v += 1
    insert_variant_label(em, clean_list, graph, v, False, var_num, ref_label_reach)
    _append_list(mers, clean_list)


def index_graph(graph: Graph, seed_filter_donor=None) -> KmerIndex:
    """indexer.cpp:246-290. Uses the native builder when available (label-
    level parity asserted by tests/index/test_native_index.py); the Python
    walk below is the oracle/fallback. `seed_filter_donor` is a previous
    iteration's index whose (additive-only, superset-safe) seed-filter
    bitsets this index may adopt instead of rebuilding."""
    from graphtyper_tpu_torch.config import current_options

    if current_options().native_aligner != "off":
        native = _index_graph_native(graph)
        if native is not None:
            if seed_filter_donor is not None:
                native._seed_filter_donor = seed_filter_donor
            _prefetch_seed_filter(native)
            return native
    idx = index_graph_py(graph)
    if current_options().native_aligner != "off":
        if seed_filter_donor is not None:
            idx._seed_filter_donor = seed_filter_donor
        _prefetch_seed_filter(idx)
    return idx


def _prefetch_seed_filter(index) -> None:
    """Kick off the native seed-filter build (exact + Hamming-neighborhood
    bitsets) in the background so callers find it ready; see
    typer/native_align.py seed_filter_prefetch."""
    try:
        from graphtyper_tpu_torch.typer.native_align import seed_filter_prefetch

        seed_filter_prefetch(index)
    except Exception:
        pass


def _index_graph_native(graph: Graph) -> KmerIndex | None:
    import ctypes

    from graphtyper_tpu_torch.io.native import get_lib

    lib = get_lib()
    if not getattr(lib, "_index_ready", False):
        lib.gt_index_graph.restype = ctypes.c_void_p
        lib.gt_index_graph.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 4
            + [ctypes.POINTER(ctypes.c_int64)]
        )
        lib.gt_index_fetch.restype = ctypes.c_int32
        lib.gt_index_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.gt_index_sort.restype = ctypes.c_int64
        lib.gt_index_sort.argtypes = [ctypes.c_void_p]
        lib.gt_index_fetch_sorted.restype = ctypes.c_int32
        lib.gt_index_fetch_sorted.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.gt_index_free.restype = None
        lib.gt_index_free.argtypes = [ctypes.c_void_p]
        lib._index_ready = True

    flat = graph.flat()
    ref_order = flat.ref_order
    ref_start = flat.ref_dna_start
    ref_len = flat.ref_dna_len
    # index-build encoding (encode, not encode_graph: the Python builder
    # resets on any code >= 4, tags included)
    ref_arena = flat.arena("ref", encode)
    ref_var_first = flat.ref_var_first
    var_order = flat.var_order
    var_start = flat.var_dna_start
    var_len = flat.var_dna_len
    var_arena = flat.arena("var", encode)
    var_out_ref = flat.var_out_ref
    sp_ref_reach = flat.sp_ref_reach
    sp_actual = flat.sp_actual
    ev_off, ev_vals = flat.ev_off, flat.ev_vals
    anti_off, anti_vals = flat.anti_off, flat.anti_vals

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    n_labels = ctypes.c_int64()
    handle = lib.gt_index_graph(
        ptr(ref_order), ptr(ref_start), ptr(ref_len), ptr(ref_var_first),
        len(ref_order), ptr(ref_arena),
        ptr(var_order), ptr(var_start), ptr(var_len), ptr(var_out_ref),
        len(var_order), ptr(var_arena),
        ptr(sp_ref_reach), ptr(sp_actual), len(sp_ref_reach),
        ptr(ev_off), ptr(ev_vals), ptr(anti_off), ptr(anti_vals),
        ctypes.byref(n_labels),
    )
    try:
        # sort + CSR layout in C++ (stable radix by key — the exact
        # permutation of the stable numpy argsort in KmerIndex.build)
        n_keys = lib.gt_index_sort(handle)
        if n_keys < 0:
            return None
        keys = np.zeros(max(1, n_keys), dtype=np.uint64)
        offsets = np.zeros(n_keys + 1, dtype=np.int64)
        starts = np.zeros(max(1, n_labels.value), dtype=np.int64)
        ends = np.zeros(max(1, n_labels.value), dtype=np.int64)
        var_ids = np.zeros(max(1, n_labels.value), dtype=np.int64)
        rc = lib.gt_index_fetch_sorted(
            handle, ptr(keys), ptr(offsets), ptr(starts), ptr(ends), ptr(var_ids)
        )
        if rc != 0:
            return None
    finally:
        lib.gt_index_free(handle)
    return KmerIndex(
        keys=keys[:n_keys],
        offsets=offsets,
        label_start=starts[: n_labels.value],
        label_end=ends[: n_labels.value],
        label_var_id=var_ids[: n_labels.value],
    )


def index_graph_py(graph: Graph) -> KmerIndex:
    """Pure-Python index build (the parity oracle)."""
    em = _Emitter()
    mers: list[list[IndexEntry]] = []
    for r in range(len(graph.ref_nodes) - 1):
        rn = graph.ref_nodes[r]
        index_reference_label(em, mers, rn.label.order, encode(rn.label.dna))
        if rn.out_degree > 0:
            index_variant(em, graph, mers, rn.out_degree, rn.out_var_ids[0])
    last = graph.ref_nodes[-1]
    index_reference_label(em, mers, last.label.order, encode(last.label.dna))
    return KmerIndex.build(
        np.array(em.kmers, dtype=np.uint64),
        np.array(em.starts, dtype=np.int64),
        np.array(em.ends, dtype=np.int64),
        np.array(em.var_ids, dtype=np.int64),
    )
