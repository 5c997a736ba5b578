"""ctypes wrapper for the native batch aligner (native/gt_align.cpp).

Prepares flat graph/index arrays once per (graph, index) pair, sends whole
batches of reads through the C++ seeding/lattice/walk pipeline, and
materializes the resulting paths back into GenotypePaths objects. Path-level
parity with the Python aligner (typer/alignment.py) is asserted by
tests/typer/test_native_align.py; the Python implementation is the oracle.
"""

from __future__ import annotations

import ctypes

import numpy as np

from graphtyper_tpu_torch.constants import IS_PAIRED, K
from graphtyper_tpu_torch.io.native import get_lib
from graphtyper_tpu_torch.typer.genotype_paths import GenotypePaths
from graphtyper_tpu_torch.typer.path import Path
from graphtyper_tpu_torch.utils.dna import encode, encode_graph, revcomp_codes

_p64 = ctypes.POINTER(ctypes.c_int64)


def _setup_lib(lib) -> None:
    if getattr(lib, "_align_ready", False):
        return
    lib.gt_align_batch.restype = ctypes.c_void_p
    lib.gt_align_batch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]  # special+sv
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4  # index
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # reads
        + [ctypes.c_void_p] * 3  # flags/tlen/same_ref
        + [ctypes.c_int32, ctypes.c_int32]  # force_both, n_threads
        + [ctypes.c_void_p]  # seed filter
        + [_p64] * 3
    )
    lib.gt_align_fetch.restype = ctypes.c_int32
    lib.gt_align_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
    lib.gt_align_free.restype = None
    lib.gt_align_free.argtypes = [ctypes.c_void_p]
    lib.gt_seed_filter_build.restype = ctypes.c_void_p
    lib.gt_seed_filter_build.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    lib.gt_seed_filter_add.restype = None
    lib.gt_seed_filter_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.gt_seed_filter_free.restype = None
    lib.gt_seed_filter_free.argtypes = [ctypes.c_void_p]
    lib.gt_seed_filter_bucket.restype = None
    lib.gt_seed_filter_bucket.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib._align_ready = True


class _SeedFilterHandle:
    """Owns one native SeedFilter (exact + Hamming-1-neighborhood membership
    bitsets over an index's keys, native/gt_align.cpp gt_seed_filter_build);
    cached on the index object so it is built once and freed with it."""

    def __init__(self, lib, handle):
        self._lib = lib
        self.handle = handle

    def __del__(self):
        try:
            self._lib.gt_seed_filter_free(self.handle)
        except Exception:
            pass


_seed_filter_lock = __import__("threading").Lock()


def seed_filter_prefetch(index, n_threads: int = 0) -> None:
    """Start building the index's seed filter on a background thread (the
    ~100ms Hamming-neighborhood build overlaps graph finalize / pool prep);
    seed_filter_handle() joins it via the build lock."""
    if getattr(index, "_seed_filter", None) is not None:
        return
    lib = get_lib()
    import threading

    t = threading.Thread(
        target=seed_filter_handle, args=(index, lib, n_threads), daemon=True
    )
    index._seed_filter_thread = t
    t.start()


def seed_filter_handle(index, lib, n_threads: int = 0):
    """Build (once) and return the native seed-filter handle for `index`.
    The filter only prunes provably-absent probes, so every consumer stays
    bit-identical with or without it. Double-checked locking: concurrent
    pool threads share one index, and a duplicate build would free the
    first handle mid-use."""
    sf = getattr(index, "_seed_filter", None)
    if sf is None:
        with _seed_filter_lock:
            sf = getattr(index, "_seed_filter", None)
            if sf is None:
                _setup_lib(lib)
                keys = np.ascontiguousarray(np.asarray(index.keys, dtype=np.uint64))
                sf = _adopt_donor_filter(index, keys, lib)
                if sf is None:
                    if n_threads <= 0:
                        from graphtyper_tpu_torch.io.native import native_thread_count

                        n_threads = native_thread_count()
                    handle = lib.gt_seed_filter_build(
                        keys.ctypes.data_as(ctypes.c_void_p), len(keys), n_threads
                    )
                    sf = _SeedFilterHandle(lib, handle)
                index._seed_filter = sf
    return sf.handle


class _RefFilterDonor:
    """Duck-typed donor for _adopt_donor_filter: the reference backbone's
    k-mers with a prebuilt filter. Built on a background thread launched
    BEFORE discovery runs, so by the time iteration 2's index exists the
    bulk of its seed filter (the ~95% reference-derived keys) is already
    paid for — the adopt step just ORs in the variant k-mers."""

    def __init__(self):
        self.keys = None
        self._seed_filter = None
        self._seed_filter_thread = None


def prebuild_reference_seed_filter(ref_codes: np.ndarray):
    """Kick off the reference-kmer filter build in the background; returns a
    donor consumable by index_graph(seed_filter_donor=...)."""
    lib = get_lib()
    import threading

    donor = _RefFilterDonor()

    def build():
        import os as _os

        from graphtyper_tpu_torch.utils.dna import pack_kmers

        kmers, valid = pack_kmers(np.asarray(ref_codes, dtype=np.uint8), 32)
        # sorted-with-duplicates suffices: the filter is a bitset (dup keys
        # set the same bits) and the adopt step only needs sorted order —
        # np.sort skips unique's mask+copy passes
        keys = np.ascontiguousarray(np.sort(kmers[valid]))
        _setup_lib(lib)
        handle = lib.gt_seed_filter_build(
            keys.ctypes.data_as(ctypes.c_void_p), len(keys), min(8, _os.cpu_count() or 1)
        )
        donor.keys = keys
        donor._seed_filter = _SeedFilterHandle(lib, handle)

    t = threading.Thread(target=build, daemon=True)
    donor._seed_filter_thread = t
    t.start()
    return donor


def _adopt_donor_filter(index, keys: np.ndarray, lib):
    """Reuse the previous iteration's filter: the bitsets are additive-only,
    so a superset filter is still exact-pruning-correct for ANY index — OR in
    the (few) keys the donor lacks instead of rebuilding from scratch
    (gt_seed_filter_add). Ownership moves to this index; the donor must be
    idle (the genotyping loop's iterations are sequential)."""
    donor = getattr(index, "_seed_filter_donor", None)
    if donor is None:
        return None
    index._seed_filter_donor = None  # consume once
    t = getattr(donor, "_seed_filter_thread", None)
    if t is not None:
        t.join()
    dsf = getattr(donor, "_seed_filter", None)
    if dsf is None:
        return None
    donor_keys = np.asarray(donor.keys, dtype=np.uint64)
    if len(keys) > 2 * max(1, len(donor_keys)):
        return None  # bitsets sized for the donor: rebuild to keep FP rates
    pos = np.searchsorted(donor_keys, keys)
    pos_c = np.minimum(pos, max(0, len(donor_keys) - 1))
    present = (pos < len(donor_keys)) & (donor_keys[pos_c] == keys) if len(donor_keys) else np.zeros(len(keys), bool)
    new_keys = np.ascontiguousarray(keys[~present])
    if len(new_keys):
        lib.gt_seed_filter_add(
            dsf.handle, new_keys.ctypes.data_as(ctypes.c_void_p), len(new_keys)
        )
    # the bitsets are superset-safe under adoption, but the prefix-bucket
    # accelerator is exact — re-attach it to THIS index's key array
    lib.gt_seed_filter_bucket(dsf.handle, keys.ctypes.data_as(ctypes.c_void_p), len(keys))
    donor._seed_filter = None  # transfer ownership (single free via wrapper)
    return dsf


class NativeAligner:
    """Holds the flat array views of one graph + index (cheap to build; DNA
    arenas use the graph-label encoding where tag characters reject)."""

    def __init__(self, graph, index):
        self.graph = graph
        self.index = index
        flat = graph.flat()
        self.ref_order = flat.ref_order
        self.ref_dna_len = flat.ref_dna_len
        self.ref_dna_start = flat.ref_dna_start
        self.ref_arena = flat.arena("ref", encode_graph)
        self.ref_var_first = flat.ref_var_first
        self.var_order = flat.var_order
        self.var_dna_len = flat.var_dna_len
        self.var_dna_start = flat.var_dna_start
        self.var_arena = flat.arena("var", encode_graph)
        self.var_out_ref = flat.var_out_ref
        self.sp_ref_reach = flat.sp_ref_reach
        self.sp_actual = flat.sp_actual

        self.keys = np.ascontiguousarray(index.keys.astype(np.uint64))
        self.offsets = np.ascontiguousarray(index.offsets.astype(np.int64))
        self.lab_start = np.ascontiguousarray(index.label_start.astype(np.int64))
        self.lab_end = np.ascontiguousarray(index.label_end.astype(np.int64))
        self.lab_var = np.ascontiguousarray(index.label_var_id.astype(np.int64))

    def align_rows_raw(self, seqs: list[bytes], n_threads: int = 0) -> dict:
        """find_genotype_paths for each oriented row sequence (codes exactly
        as given — no reverse complement, no pair geometry), returning the
        serialized Geno table in the gt_align_fetch layout. This is the work
        unit of the rep-sharded distributed exchange (parallel/rep_shard.py):
        a host aligns its share of the cohort's deduplicated oriented
        sequences and ships these arrays; gt_call_finish imports them so the
        receiving host's align stage skips the walk for resolved rows."""
        import ctypes as ct

        lib = get_lib()
        _setup_lib(lib)
        n = len(seqs)
        read_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=read_off[1:])
        read_codes = (
            np.frombuffer(b"".join(seqs), dtype=np.uint8).copy()
            if n
            else np.zeros(0, dtype=np.uint8)
        )
        flags = np.zeros(n, dtype=np.int32)  # unpaired: forward only
        tlen = np.zeros(n, dtype=np.int32)
        same_ref = np.ones(n, dtype=np.uint8)
        if n_threads <= 0:
            from graphtyper_tpu_torch.io.native import native_thread_count

            n_threads = native_thread_count()

        n_paths = ct.c_int64()
        n_sites = ct.c_int64()
        n_nums = ct.c_int64()

        def ptr(a):
            return a.ctypes.data_as(ct.c_void_p)

        handle = lib.gt_align_batch(
            ptr(self.ref_order), ptr(self.ref_dna_start), ptr(self.ref_dna_len),
            ptr(self.ref_var_first), len(self.ref_order), ptr(self.ref_arena),
            ptr(self.var_order), ptr(self.var_dna_start), ptr(self.var_dna_len),
            ptr(self.var_out_ref), len(self.var_order), ptr(self.var_arena),
            ptr(self.sp_ref_reach), ptr(self.sp_actual), len(self.sp_ref_reach),
            1 if self.graph.is_sv_graph else 0,
            ptr(self.keys), len(self.keys), ptr(self.offsets),
            ptr(self.lab_start), ptr(self.lab_end), ptr(self.lab_var),
            ptr(read_codes), ptr(read_off), n,
            ptr(flags), ptr(tlen), ptr(same_ref),
            0, n_threads,
            seed_filter_handle(self.index, lib, n_threads),
            ct.byref(n_paths), ct.byref(n_sites), ct.byref(n_nums),
        )
        try:
            path_count = np.zeros(2 * n, dtype=np.int32)
            longest = np.zeros(2 * n, dtype=np.int32)
            p_start = np.zeros(n_paths.value, dtype=np.int64)
            p_end = np.zeros(n_paths.value, dtype=np.int64)
            p_rsi = np.zeros(n_paths.value, dtype=np.int32)
            p_rei = np.zeros(n_paths.value, dtype=np.int32)
            p_mm = np.zeros(n_paths.value, dtype=np.int32)
            p_nsites = np.zeros(n_paths.value, dtype=np.int32)
            s_vorder = np.zeros(n_sites.value, dtype=np.int64)
            s_ncount = np.zeros(n_sites.value, dtype=np.int32)
            num_vals = np.zeros(n_nums.value, dtype=np.uint16)
            rc = lib.gt_align_fetch(
                handle,
                ptr(path_count), ptr(longest),
                ptr(p_start), ptr(p_end), ptr(p_rsi), ptr(p_rei), ptr(p_mm), ptr(p_nsites),
                ptr(s_vorder), ptr(s_ncount), ptr(num_vals),
            )
            if rc != 0:
                raise RuntimeError("gt_align_fetch failed")
        finally:
            lib.gt_align_free(handle)

        # fwd-only alignment: odd (reverse) entries contribute zero paths, so
        # the flat path arrays already hold exactly the fwd Genos in order
        assert int(path_count[1::2].sum()) == 0
        poff = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(path_count[0::2], out=poff[1:])
        soff = np.zeros(n_paths.value + 1, dtype=np.int64)
        np.cumsum(p_nsites, out=soff[1:])
        noff = np.zeros(n_sites.value + 1, dtype=np.int64)
        np.cumsum(s_ncount, out=noff[1:])
        return {
            "longest": np.ascontiguousarray(longest[0::2]),
            "poff": poff,
            "p_start": p_start,
            "p_end": p_end,
            "p_rsi": p_rsi,
            "p_rei": p_rei,
            "p_mm": p_mm,
            "soff": soff,
            "s_vorder": s_vorder,
            "noff": noff,
            "nums": num_vals,
        }

    def align_batch(
        self, reads, force_both: bool = False, n_threads: int = 0
    ) -> list[tuple[GenotypePaths, GenotypePaths]]:
        """align_read for a batch of AlignedReads; returns (fwd, rev) per
        read like alignment.align_read."""
        lib = get_lib()
        _setup_lib(lib)
        n = len(reads)
        codes_list = [encode(r.seq) for r in reads]
        read_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(c) for c in codes_list], out=read_off[1:])
        read_codes = (
            np.concatenate(codes_list) if n else np.zeros(0, dtype=np.uint8)
        ).astype(np.uint8)
        flags = np.array([r.flag for r in reads], dtype=np.int32)
        tlen = np.array(
            [max(-0x7FFFFFFF, min(0x7FFFFFFF, r.tlen)) for r in reads], dtype=np.int32
        )
        same_ref = np.array([1 if r.ref_id == r.mate_ref_id else 0 for r in reads], dtype=np.uint8)

        if n_threads <= 0:
            from graphtyper_tpu_torch.io.native import native_thread_count

            n_threads = native_thread_count()

        n_paths = ctypes.c_int64()
        n_sites = ctypes.c_int64()
        n_nums = ctypes.c_int64()

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        handle = lib.gt_align_batch(
            ptr(self.ref_order), ptr(self.ref_dna_start), ptr(self.ref_dna_len),
            ptr(self.ref_var_first), len(self.ref_order), ptr(self.ref_arena),
            ptr(self.var_order), ptr(self.var_dna_start), ptr(self.var_dna_len),
            ptr(self.var_out_ref), len(self.var_order), ptr(self.var_arena),
            ptr(self.sp_ref_reach), ptr(self.sp_actual), len(self.sp_ref_reach),
            1 if self.graph.is_sv_graph else 0,
            ptr(self.keys), len(self.keys), ptr(self.offsets),
            ptr(self.lab_start), ptr(self.lab_end), ptr(self.lab_var),
            ptr(read_codes), ptr(read_off), n,
            ptr(flags), ptr(tlen), ptr(same_ref),
            1 if force_both else 0, n_threads,
            seed_filter_handle(self.index, lib, n_threads),
            ctypes.byref(n_paths), ctypes.byref(n_sites), ctypes.byref(n_nums),
        )
        try:
            path_count = np.zeros(2 * n, dtype=np.int32)
            longest = np.zeros(2 * n, dtype=np.int32)
            p_start = np.zeros(n_paths.value, dtype=np.int64)
            p_end = np.zeros(n_paths.value, dtype=np.int64)
            p_rsi = np.zeros(n_paths.value, dtype=np.int32)
            p_rei = np.zeros(n_paths.value, dtype=np.int32)
            p_mm = np.zeros(n_paths.value, dtype=np.int32)
            p_nsites = np.zeros(n_paths.value, dtype=np.int32)
            s_vorder = np.zeros(n_sites.value, dtype=np.int64)
            s_ncount = np.zeros(n_sites.value, dtype=np.int32)
            num_vals = np.zeros(n_nums.value, dtype=np.uint16)
            rc = lib.gt_align_fetch(
                handle,
                ptr(path_count), ptr(longest),
                ptr(p_start), ptr(p_end), ptr(p_rsi), ptr(p_rei), ptr(p_mm), ptr(p_nsites),
                ptr(s_vorder), ptr(s_ncount), ptr(num_vals),
            )
            if rc != 0:
                raise RuntimeError("gt_align_fetch failed")
        finally:
            lib.gt_align_free(handle)

        # materialize paths
        p_start_l = p_start.tolist()
        p_end_l = p_end.tolist()
        p_rsi_l = p_rsi.tolist()
        p_rei_l = p_rei.tolist()
        p_mm_l = p_mm.tolist()
        p_nsites_l = p_nsites.tolist()
        s_vorder_l = s_vorder.tolist()
        s_ncount_l = s_ncount.tolist()
        num_vals_l = num_vals.tolist()
        path_count_l = path_count.tolist()
        longest_l = longest.tolist()

        out = []
        pi = 0  # path cursor
        si = 0  # site cursor
        ni = 0  # num cursor
        for r, read in enumerate(reads):
            codes = codes_list[r]
            genos = []
            for o in range(2):
                g = GenotypePaths(read.flag, len(codes))
                g.longest_path_length = longest_l[2 * r + o]
                for _ in range(path_count_l[2 * r + o]):
                    var_order = []
                    nums = []
                    for _ in range(p_nsites_l[pi]):
                        var_order.append(s_vorder_l[si])
                        cnt = s_ncount_l[si]
                        nums.append(set(num_vals_l[ni : ni + cnt]))
                        ni += cnt
                        si += 1
                    g.paths.append(
                        Path(
                            p_start_l[pi],
                            p_end_l[pi],
                            p_rsi_l[pi],
                            p_rei_l[pi],
                            var_order,
                            nums,
                            p_mm_l[pi],
                        )
                    )
                    pi += 1
                genos.append(g)
            # read2 mirrors alignment.find_genotype_paths: set on orientations
            # that were actually aligned
            if len(codes) >= 2 * K - 1:
                genos[0].read2 = codes
                proper_geometry = (read.flag & IS_PAIRED) == 0 or (
                    read.ref_id == read.mate_ref_id
                    and -1200 < read.tlen < 1200
                    and bool(read.flag & 0x10) != bool(read.flag & 0x20)
                )
                if not proper_geometry or force_both:
                    genos[1].read2 = revcomp_codes(codes)
            out.append((genos[0], genos[1]))
        return out
