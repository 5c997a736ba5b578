"""ctypes wrapper for the native pooled caller loop (native/gt_align.cpp
gt_call_pool): alignment + dedup + mate pairing + observation extraction +
phasing connections all run in C++; the observation table feeds the
port's batched device scorer and the connection arrays rebuild the phasing
maps.

Port of graphtyper_tpu/pipeline/native_caller.py. The bindings of the C++
engine, the byte and prepared-pool caches and the result marshalling are
copied. The two entries that construct a SiteScorer are forks that take
the device: `run_native_call_pool_bam` (:443) and
`run_native_call_pool_stream` (:981). So are the call iterations' device
hooks of non-SV pools, on the same device: device seeding
(ops/seed_probe.py) and device alignment (ops/device_align.py), in memory
and, for alignment, in the streaming caller's stage/step pipeline. Unlike
the JAX package's hooks they catch nothing: a kernel that fails to build
or launch raises. Both entries take the scorer's mesh
(parallel/mesh.py, ops/site_scoring.py), and the in-memory one the
rep-sharded oracle (parallel/rep_shard.py), whose resolved rows go into
the engine's external-result arrays. Unlike the JAX package's
prepared-pool cache, this one pins each entry while a pool uses it: pools
that run at once never free each other's prepared reads."""

from __future__ import annotations

import ctypes
import threading
from collections import deque

import numpy as np
import torch

from graphtyper_tpu_torch.io.native import get_lib, native_thread_count
from graphtyper_tpu_torch.typer.scoring import SiteScorer

_p64 = ctypes.POINTER(ctypes.c_int64)
#: kmer columns gt_stream_stage exports a row (8 covers 279 bp reads)
NK_CAP = 8


def _setup_lib(lib) -> None:
    if getattr(lib, "_call_ready", False):
        return
    lib.gt_call_pool.restype = ctypes.c_void_p
    lib.gt_call_pool.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # special
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sites
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4  # index
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # read codes
        + [ctypes.c_void_p] * 2  # names
        + [ctypes.c_void_p] * 5  # flags mapq tlen same_ref pos
        + [ctypes.c_void_p] * 2  # score_diff clipped_count
        + [ctypes.c_void_p] * 2  # quals qual_off
        + [ctypes.c_void_p]  # rg_idx
        + [ctypes.c_int32] * 5  # n_samples sam_flag_filter force_both hq_reads n_threads
        + [ctypes.c_void_p]  # seed filter
        + [_p64] * 5
    )
    lib.gt_call_pool_sv.restype = ctypes.c_void_p
    lib.gt_call_pool_sv.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # special
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sites
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4  # index
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # read codes
        + [ctypes.c_void_p] * 2  # names
        + [ctypes.c_void_p] * 5  # flags mapq tlen same_ref pos
        + [ctypes.c_void_p] * 2  # score_diff clipped_count
        + [ctypes.c_void_p] * 2  # quals qual_off
        + [ctypes.c_void_p]  # rg_idx
        + [ctypes.c_int32] * 5  # n_samples sam_flag_filter force_both hq_reads n_threads
        + [ctypes.c_void_p]  # seed filter
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sv_bad avg_cov first_pos
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]  # depth ref_size ref_offset
        + [_p64] * 5
    )
    lib.gt_call_pool_fetch.restype = ctypes.c_int32
    lib.gt_call_pool_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 28
    lib.gt_call_pool_bam.restype = ctypes.c_void_p
    lib.gt_call_pool_bam.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # special
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sites
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4  # index
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64]  # files
        + [ctypes.c_int32] * 5
        + [ctypes.c_void_p]  # seed filter
        + [_p64] * 5
    )
    lib.gt_call_pool_free.restype = None
    lib.gt_call_pool_free.argtypes = [ctypes.c_void_p]
    # prepare/finish split (parse once per pool, call per iteration)
    lib.gt_call_prepare_bam.restype = ctypes.c_void_p
    lib.gt_call_prepare_bam.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64]  # files
        + [ctypes.c_int32] * 2  # sam_flag_filter force_both
        + [ctypes.c_int64] * 2  # position filter begin/end (-1 = off)
        + [ctypes.c_int32]  # parse threads
        + [_p64] * 2 + [ctypes.POINTER(ctypes.c_int32)]
    )
    lib.gt_prep_fetch_seqs.restype = None
    lib.gt_prep_fetch_seqs.argtypes = [ctypes.c_void_p] * 3
    lib.gt_prep_fetch_kmers.restype = None
    lib.gt_prep_fetch_kmers.argtypes = [ctypes.c_void_p] * 4
    lib.gt_prep_fetch_tails.restype = None
    lib.gt_prep_fetch_tails.argtypes = [ctypes.c_void_p] * 3
    lib.gt_device_align_stats.restype = None
    lib.gt_device_align_stats.argtypes = [_p64] * 3
    lib.gt_call_finish.restype = ctypes.c_void_p
    lib.gt_call_finish.argtypes = (
        [ctypes.c_void_p]  # prep
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # special
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sites
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4  # index
        + [ctypes.c_void_p, ctypes.c_int32]  # cand bit words + nk_max
        + [ctypes.c_void_p, ctypes.c_int32]  # verdict rows + verify flag
        + [ctypes.c_void_p] * 12  # ext rep results (rep-sharded mode)
        + [ctypes.c_int32] * 3  # n_samples hq_reads n_threads
        + [ctypes.c_void_p]  # seed filter
        + [_p64] * 5
    )
    lib.gt_prep_free.restype = None
    lib.gt_prep_free.argtypes = [ctypes.c_void_p]
    lib.gt_call_finish_sv.restype = ctypes.c_void_p
    lib.gt_call_finish_sv.argtypes = (
        [ctypes.c_void_p]  # prep
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # special
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sites
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4  # index
        + [ctypes.c_int32] * 3  # n_samples hq_reads n_threads
        + [ctypes.c_void_p]  # seed filter
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]  # avg_cov depth ref_size ref_offset
        + [_p64] * 5
    )
    lib._call_ready = True


def available() -> bool:
    return get_lib() is not None


# decompressed-BAM bytes cache (the caller re-reads the shrunk pool files
# once per iteration; objects are never built on this path). Byte-bounded:
# cohort pools hold many small shrunk files, whole-file inputs few big ones.
_BYTES_CACHE: dict = {}


_BYTES_CACHE_MAX_BYTES = 256 << 20


_BYTES_CACHE_LOCK = __import__("threading").Lock()


def _cache_put(key, data) -> None:
    # threaded callers (discovery's per-file extract pool) insert
    # concurrently; the size sweep must not iterate a mutating dict
    with _BYTES_CACHE_LOCK:
        _BYTES_CACHE[key] = data
        total = sum(len(v) for v in _BYTES_CACHE.values())
        while total > _BYTES_CACHE_MAX_BYTES and len(_BYTES_CACHE) > 1:
            old = _BYTES_CACHE.pop(next(iter(_BYTES_CACHE)))
            total -= len(old)


def _bam_bytes(
    path: str,
    interval: tuple[str, int, int] | None = None,
    ref_path: str | None = None,
) -> bytes | None:
    """Decompressed BAM bytes for the whole file, or — when `interval` is
    given and an index (.bai) / container headers (CRAM) allow it — a record
    SUPERSET of the interval's overlaps. Consumers apply the exact position
    filter themselves, so the slice is purely an IO optimization."""
    import os

    from graphtyper_tpu_torch.io.bgzf import decompress_all

    if not path.endswith(".cram"):
        ref_path = None  # only CRAM decode consumes it; keep one cache entry
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size, interval, ref_path)
    hit = _BYTES_CACHE.get(key)
    if hit is not None:
        return hit
    if path.endswith(".cram"):
        # CRAM rides the same path through the native CRAM->BAM bridge;
        # container headers carry (ref, start, span) so region decode needs
        # no index file
        from graphtyper_tpu_torch.io.cram_native import cram_to_bam_bytes

        data = cram_to_bam_bytes(path, region=interval, ref_path=ref_path)
        if data is None:
            return None  # unsupported codec: caller uses the object path
    else:
        data = None
        if interval is not None:
            from graphtyper_tpu_torch.io.bai import read_region_bam_bytes

            data = read_region_bam_bytes(path, [interval])
        if data is None:
            data = decompress_all(path)
    _cache_put(key, data)
    return data


def _parse_bam_header_meta(data: bytes):
    """(ref_names, sample_names, text) from decompressed BAM bytes."""
    import struct

    if data[:4] != b"BAM\x01":
        return None
    (l_text,) = struct.unpack_from("<i", data, 4)
    text = data[8 : 8 + l_text].rstrip(b"\x00").decode()
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(data[off : off + l_name - 1].decode())
        off += l_name + 4
    samples = []
    if not _names_from_filename():
        for line in text.split("\n"):
            if line.startswith("@RG"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SM:") and fld[3:] not in samples:
                        samples.append(fld[3:])
    return ref_names, samples, text


def _names_from_filename() -> bool:
    # hts_reader.cpp:32 get_sample_names_from_filename: skip RG parsing
    from graphtyper_tpu_torch.config import current_options

    return getattr(current_options(), "get_sample_names_from_filename", False)


class _PrepEntry:
    """One cached prepared pool: the C++ PrepPool handle plus the rows'
    kmer and tail matrices on the device (staged at first use, kept across
    call iterations).

    `_get_prep` hands an entry out pinned; its user calls `release` when it
    no longer reads the handle. The handle and the staged tensors are freed
    once the entry is out of the cache and the last pin is gone, by
    whichever of the eviction and that release comes later. `pins` and
    `cached` change only under `_PREP_LOCK`."""

    def __init__(self, handle, n_reads: int, n_rows: int, row_len: int, sample_names):
        self.handle = handle
        self.n_reads = n_reads
        self.n_rows = n_rows
        self.row_len = row_len
        self.sample_names = sample_names
        self.kmers_dev = None  # staged (hi, lo, valid) tensors
        self.tails_dev = None  # staged (tails, lens) tensors
        self.row_seqs = None  # fetched (codes, lens)
        self.pins = 1  # the user that made it
        self.cached = False

    def release(self, lib) -> None:
        """Drop the pin `_get_prep` took for this user."""
        with _PREP_LOCK:
            self.pins -= 1
            unused = self.pins == 0 and not self.cached
        if unused:
            self._free(lib)

    def _free(self, lib) -> None:
        """Free the engine's PrepPool and drop the staged tensors; nothing
        else can reach the entry any more."""
        self.kmers_dev = None
        self.tails_dev = None
        lib.gt_prep_free(self.handle)
        self.handle = None

    @property
    def nk_max(self) -> int:
        return 1 + (self.row_len - 32) // 31 if self.row_len >= 32 else 0

    def fetch_kmers(self, lib):
        """(hi, lo, valid) [n_rows, nk_max]: each row's exact kmer keys
        (gt_prep_fetch_kmers)."""
        nk = self.nk_max
        hi = np.zeros((self.n_rows, nk), dtype=np.uint32)
        lo = np.zeros((self.n_rows, nk), dtype=np.uint32)
        valid = np.zeros((self.n_rows, nk), dtype=np.uint8)
        lib.gt_prep_fetch_kmers(self.handle, _ptr(hi), _ptr(lo), _ptr(valid))
        return hi, lo, valid

    def fetch_row_seqs(self, lib):
        """Per-row oriented sequence codes [n_rows, row_len] (pad 15) and row
        lengths: the deduplicated align work units, which the rep-sharded
        exchange (parallel/rep_shard.py) keys by digest. Fetched once."""
        if self.row_seqs is None:
            codes = np.zeros((self.n_rows, self.row_len), dtype=np.uint8)
            lens = np.zeros(self.n_rows, dtype=np.int32)
            lib.gt_prep_fetch_seqs(self.handle, _ptr(codes), _ptr(lens))
            self.row_seqs = (codes, lens)
        return self.row_seqs

    def fetch_tails(self, lib):
        """(tails [n_rows, TAIL_PAD], lens [n_rows]): each row's bases after
        its last full kmer and its length (gt_prep_fetch_tails)."""
        from graphtyper_tpu_torch.ops.device_align import TAIL_PAD

        tails = np.zeros((self.n_rows, TAIL_PAD), dtype=np.uint8)
        lens = np.zeros(self.n_rows, dtype=np.int32)
        lib.gt_prep_fetch_tails(self.handle, _ptr(tails), _ptr(lens))
        return tails, lens

    def stage_kmers_dev(self, lib, device: torch.device):
        """The kmer matrices staged on `device` once; the reads, and so the
        keys, do not change between call iterations."""
        if self.kmers_dev is None or self.kmers_dev[0].device != device:
            from graphtyper_tpu_torch.ops.seed_probe import stage_kmers

            self.kmers_dev = stage_kmers(*self.fetch_kmers(lib), device)
        return self.kmers_dev

    def stage_tails_dev(self, lib, device: torch.device):
        """The tail matrix and row lengths for the device aligner, staged
        once like the kmer matrices."""
        if self.tails_dev is None or self.tails_dev[0].device != device:
            from graphtyper_tpu_torch.ops.device_align import stage_tails

            self.tails_dev = stage_tails(*self.fetch_tails(lib), device)
        return self.tails_dev


# prepared pools are reused across the call iterations (the reads do not
# change between iterations; only the graph does). call_pools runs pools
# in threads, so the cache and the entries' pins are guarded by one lock.
_PREP_CACHE: dict = {}
_PREP_LOCK = threading.Lock()
_PREP_CACHE_MAX = 4


def _get_prep(lib, hts_paths, region, sam_flag_filter, force_both, position_filter=False,
              ref_path=None):
    """Prepared pool for (files, region, filters): parse + sort + dedup once.
    The entry comes back pinned: the caller calls its `release(lib)` when
    it has done with it (in a `finally`), and until then no other thread's
    eviction frees it.

    position_filter restricts the record set to reads overlapping
    [region.begin, region.end) — the reference's index-iterator semantics
    (genotype_sv.cpp reads regions, not contigs). The exact filter runs in
    the C++ parse; when a .bai exists (or the input is CRAM) the byte slice
    is also index-gated so population-scale inputs never decompress whole."""
    import os

    fb = int(region.begin) if position_filter else -1
    fe = int(region.end) if position_filter else -1
    ids = []
    for p in hts_paths:
        st = os.stat(p)
        ids.append((os.path.abspath(p), st.st_mtime_ns, st.st_size))
    key = (tuple(ids), region.chr, sam_flag_filter, force_both, fb, fe, ref_path)
    with _PREP_LOCK:
        hit = _PREP_CACHE.get(key)
        if hit is not None:
            hit.pins += 1
            return hit

    interval = (region.chr, fb, fe) if position_filter else None
    datas = []
    targets = []
    sample_names: list[str] = []
    for path in hts_paths:
        data = _bam_bytes(path, interval, ref_path=ref_path)
        meta = _parse_bam_header_meta(data) if data is not None else None
        if meta is None:
            return None
        ref_names, samples, _text = meta
        if not samples:
            samples = [path.rsplit("/", 1)[-1].split(".")[0]]
        if len(samples) > 1:
            return None  # merged multi-sample files use the object path (RG)
        sample_names.append(samples[0])
        datas.append(data)
        targets.append(ref_names.index(region.chr) if region.chr in ref_names else -2)

    bufs = [np.frombuffer(d, dtype=np.uint8) for d in datas]
    ptr_arr = (ctypes.c_void_p * len(bufs))(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs]
    )
    size_arr = np.array([len(d) for d in datas], dtype=np.int64)
    target_arr = np.array(targets, dtype=np.int64)
    sidx_arr = np.array(range(len(sample_names)), dtype=np.int32)
    n_reads = ctypes.c_int64()
    n_rows = ctypes.c_int64()
    row_len = ctypes.c_int32()
    handle = lib.gt_call_prepare_bam(
        ptr_arr,
        size_arr.ctypes.data_as(ctypes.c_void_p),
        target_arr.ctypes.data_as(ctypes.c_void_p),
        sidx_arr.ctypes.data_as(ctypes.c_void_p),
        len(bufs),
        sam_flag_filter,
        1 if force_both else 0,
        fb,
        fe,
        native_thread_count(),
        ctypes.byref(n_reads),
        ctypes.byref(n_rows),
        ctypes.byref(row_len),
    )
    entry = _PrepEntry(handle, n_reads.value, n_rows.value, row_len.value, sample_names)
    unused = []
    with _PREP_LOCK:
        hit = _PREP_CACHE.get(key)
        if hit is not None:  # another thread prepared the same pool meanwhile
            hit.pins += 1
            unused.append(entry)
            entry = hit
        else:
            while len(_PREP_CACHE) >= _PREP_CACHE_MAX:
                old = _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
                old.cached = False
                if old.pins == 0:
                    unused.append(old)
            entry.cached = True
            _PREP_CACHE[key] = entry
    for old in unused:
        old._free(lib)
    return entry


def _device_seed_enabled(opts) -> bool:
    # "auto" resolves to off, as in the JAX package: the host seed filter
    # (gt_seed_filter_build) answers the same membership question with ~2
    # cache-local probes per kmer (see config.device_seed).
    return getattr(opts, "device_seed", "auto") == "on"


def device_align_mode(opts) -> str:
    """Resolved device_align mode: "off" | "on" | "verify". The env override
    (GT_DEVICE_ALIGN) wins so benches/tests can force either side. "auto"
    resolves to off, as in the JAX package (see config.device_align)."""
    import os

    mode = os.environ.get("GT_DEVICE_ALIGN", "") or getattr(opts, "device_align", "auto")
    if mode == "auto":
        return "off"
    return mode


def _device_aligner(na, index, device: torch.device):
    """The index's DeviceAligner on `device`, built once per index, or None
    when a table is empty: the JAX package's verdict gathers raise there and
    its caller aligns every row on the host, which is what None asks for."""
    from graphtyper_tpu_torch.ops.device_align import DeviceAligner, tables_nonempty

    dal = getattr(index, "_device_aligner", None)
    if dal is None or dal.device != device:
        if not tables_nonempty(na):
            return None
        dal = DeviceAligner(na, device)
        index._device_aligner = dal
    return dal


def _device_align_verdicts(na, index, entry: _PrepEntry, lib, device: torch.device):
    """int32 [n_rows, VERD_COLS] verdict matrix from the device aligner, or
    None (empty index) for host alignment of every rep."""
    dal = _device_aligner(na, index, device)
    if dal is None:
        return None
    kmers = entry.stage_kmers_dev(lib, device)
    tails, lens = entry.stage_tails_dev(lib, device)
    return dal.verdicts(kmers, tails, lens, entry.n_rows, entry.nk_max)


def device_align_stats() -> tuple[int, int, int]:
    """(clean, fallback, verify_divergences) since the last call; resets."""
    lib = get_lib()
    _setup_lib(lib)
    a, b, c = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    lib.gt_device_align_stats(ctypes.byref(a), ctypes.byref(b), ctypes.byref(c))
    return (a.value, b.value, c.value)


def _device_seed_words(index, entry: _PrepEntry, lib, device: torch.device):
    """Packed candidate bit words [n_rows, prow] from the seed-probe kernel
    on `device`."""
    from graphtyper_tpu_torch.ops.seed_probe import DeviceSeeder

    seeder = getattr(index, "_device_seeder", None)
    if seeder is None or seeder.device != device:
        seeder = DeviceSeeder(np.asarray(index.keys, dtype=np.uint64), device)
        index._device_seeder = seeder
    kmers = entry.stage_kmers_dev(lib, device)
    return seeder.probe_bits(kmers, entry.n_rows, entry.nk_max)


def run_native_call_pool(
    graph,
    index,
    pooled,
    n_samples: int,
    scorer,
    sam_flag_filter: int = 3840,
    force_both: bool = False,
    hq_reads: bool = False,
    n_threads: int = 0,
    sv_ctx: dict | None = None,
):
    """Run the C++ pooled loop and feed results into `scorer` (a SiteScorer
    with device batching on). Returns (num_records, num_duplicated) or None
    if the native loop reported an unsupported condition (caller then falls
    back to the Python loop).

    sv_ctx (SV graphs, caller.py is_sv branches): {"sv_bad": uint8[n],
    "avg_cov": float64[n_samples] | None, "first_pos": int,
    "depth": int32[n_samples, ref_size] (filled in place),
    "ref_offset": int}."""
    from graphtyper_tpu_torch.ops.site_scoring import ALLELE_TIERS, _TierBuffer, apply_obs_host
    from graphtyper_tpu_torch.typer.native_align import NativeAligner, seed_filter_handle
    from graphtyper_tpu_torch.utils.dna import encode

    lib = get_lib()
    _setup_lib(lib)
    na = NativeAligner(graph, index)  # reuses the flat graph/index arrays

    sites = scorer.sites
    site_order = np.array([s.gt.id for s in sites], dtype=np.int64)
    site_cnum = np.array([s.gt.num for s in sites], dtype=np.int64)
    site_is_snp = np.array([1 if graph.is_snp(s.gt) else 0 for s in sites], dtype=np.uint8)

    n = len(pooled)
    seqs = [t[0].seq for t in pooled]
    read_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(q) for q in seqs], out=read_off[1:])
    read_codes = encode(b"".join(seqs)) if n else np.zeros(0, dtype=np.uint8)

    name_bytes = [t[0].name.encode() for t in pooled]
    name_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in name_bytes], out=name_off[1:])
    names = np.frombuffer(b"".join(name_bytes), dtype=np.uint8) if n else np.zeros(0, np.uint8)

    flags = np.array([t[0].flag for t in pooled], dtype=np.int32)
    mapq = np.array([t[0].mapq for t in pooled], dtype=np.int32)
    tlen = np.array([max(-0x7FFFFFFF, min(0x7FFFFFFF, t[0].tlen)) for t in pooled], dtype=np.int32)
    same_ref = np.array([1 if t[0].ref_id == t[0].mate_ref_id else 0 for t in pooled], dtype=np.uint8)
    pos = np.array([t[0].pos for t in pooled], dtype=np.int64)
    rg_idx = np.array([t[2] for t in pooled], dtype=np.int32)

    from graphtyper_tpu_torch.typer.alignment import _clipped_count, _score_diff

    score_diff = np.array([_score_diff(t[0]) for t in pooled], dtype=np.int32)
    clipped_count = np.array([_clipped_count(t[0]) for t in pooled], dtype=np.int32)

    qual_arrays = [
        np.asarray(t[0].qual, dtype=np.uint8)
        if t[0].qual is not None and len(t[0].qual)
        else np.zeros(0, dtype=np.uint8)
        for t in pooled
    ]
    qual_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(q) for q in qual_arrays], out=qual_off[1:])
    quals = (np.concatenate(qual_arrays) if n else np.zeros(0, dtype=np.uint8)).astype(np.uint8)

    if n_threads <= 0:
        from graphtyper_tpu_torch.io.native import native_thread_count

        n_threads = native_thread_count()

    n_obs = ctypes.c_int64()
    n_xvals = ctypes.c_int64()
    n_conn = ctypes.c_int64()
    n_counts = ctypes.c_int64()
    n_touched = ctypes.c_int64()

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    names = np.ascontiguousarray(names)
    common = (
        ptr(na.ref_order), ptr(na.ref_dna_start), ptr(na.ref_dna_len),
        ptr(na.ref_var_first), len(na.ref_order), ptr(na.ref_arena),
        ptr(na.var_order), ptr(na.var_dna_start), ptr(na.var_dna_len),
        ptr(na.var_out_ref), len(na.var_order), ptr(na.var_arena),
        ptr(na.sp_ref_reach), ptr(na.sp_actual), len(na.sp_ref_reach),
        ptr(site_order), ptr(site_cnum), ptr(site_is_snp), len(site_order),
        ptr(na.keys), len(na.keys), ptr(na.offsets),
        ptr(na.lab_start), ptr(na.lab_end), ptr(na.lab_var),
        ptr(read_codes), ptr(read_off), n,
        ptr(names), ptr(name_off),
        ptr(flags), ptr(mapq), ptr(tlen), ptr(same_ref), ptr(pos),
        ptr(score_diff), ptr(clipped_count),
        ptr(quals), ptr(qual_off),
        ptr(rg_idx),
        n_samples, sam_flag_filter, 1 if force_both else 0, 1 if hq_reads else 0,
        n_threads,
        seed_filter_handle(index, lib, n_threads),
    )
    outs = (
        ctypes.byref(n_obs), ctypes.byref(n_xvals), ctypes.byref(n_conn), ctypes.byref(n_counts),
        ctypes.byref(n_touched),
    )
    if sv_ctx is not None:
        sv_bad = np.ascontiguousarray(sv_ctx["sv_bad"], dtype=np.uint8)
        avg_cov = sv_ctx["avg_cov"]
        if avg_cov is not None:
            avg_cov = np.ascontiguousarray(avg_cov, dtype=np.float64)
        depth = sv_ctx["depth"]
        assert depth.dtype == np.int32 and depth.flags.c_contiguous
        handle = lib.gt_call_pool_sv(
            *common,
            ptr(sv_bad), ptr(avg_cov) if avg_cov is not None else None,
            int(sv_ctx["first_pos"]),
            ptr(depth), depth.shape[1], int(sv_ctx["ref_offset"]),
            *outs,
        )
    else:
        handle = lib.gt_call_pool(*common, *outs)

    return _consume_call_result(lib, handle, scorer, n_samples, n_obs, n_xvals, n_conn, n_counts, n_touched)


def _feed_obs(
    scorer, site_cnum,
    o_site, o_sample, o_eps, o_apply, o_bits_lo, o_bits_hi, o_cov,
    o_clip_scaled, o_clip_flag, o_mapq_sq, o_mm_scaled, o_sdiff,
    o_strand, o_proper, o_big, x_count, x_vals,
) -> None:
    """Feed one batch of native observation rows into the scorer: tiered
    numpy blocks for the device batcher, direct host application for the
    rare >64-allele sites."""
    from graphtyper_tpu_torch.ops.site_scoring import ALLELE_TIERS, _TierBuffer, apply_obs_host

    batcher = scorer.batcher
    sites = scorer.sites
    N = len(o_site)
    small = o_big == 0
    cnum_of_obs = site_cnum[o_site]
    tier_of_obs = np.zeros(N, dtype=np.int64)
    for t in ALLELE_TIERS:
        tier_of_obs[small & (tier_of_obs == 0) & (cnum_of_obs <= t)] = t

    for t in ALLELE_TIERS:
        mask = small & (tier_of_obs == t)
        if not mask.any():
            continue
        buf = batcher.tiers.get(t)
        if buf is None:
            buf = batcher.tiers[t] = _TierBuffer(A=t)
        gsites = o_site[mask].astype(np.int64)
        uniq = np.unique(gsites)
        slot_lut = np.empty(len(uniq), dtype=np.int64)
        for ui, g in enumerate(uniq.tolist()):
            s = buf.slot_of.get(g)
            if s is None:
                s = len(buf.site_ids)
                buf.slot_of[g] = s
                buf.site_ids.append(g)
            slot_lut[ui] = s
        slots = slot_lut[np.searchsorted(uniq, gsites)]
        buf.blocks.append(
            {
                "site": slots,
                "sample": o_sample[mask],
                "eps": o_eps[mask],
                "apply_score": o_apply[mask],
                "bits_lo": o_bits_lo[mask],
                "bits_hi": o_bits_hi[mask],
                "cov": o_cov[mask],
                "clipped_scaled": o_clip_scaled[mask],
                "clipped_flag": o_clip_flag[mask],
                "mapq_sq": o_mapq_sq[mask],
                "mm_scaled": o_mm_scaled[mask],
                "sdiff": o_sdiff[mask],
                "strand": o_strand[mask],
                "proper": o_proper[mask],
            }
        )

    # big (>64-allele) sites: direct host application
    if (~small).any():
        x_off = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(x_count, out=x_off[1:])
        for i in np.nonzero(~small)[0].tolist():
            apply_obs_host(
                sites[int(o_site[i])],
                int(o_sample[i]),
                int(o_eps[i]),
                bool(o_apply[i]),
                x_vals[x_off[i] : x_off[i + 1]].tolist(),
                int(o_cov[i]),
                int(o_clip_scaled[i]),
                int(o_clip_flag[i]),
                int(o_mapq_sq[i]),
                int(o_mm_scaled[i]),
                int(o_sdiff[i]),
                int(o_strand[i]),
                int(o_proper[i]),
            )


def _consume_call_result(lib, handle, scorer, n_samples, n_obs, n_xvals, n_conn, n_counts, n_touched):
    """Fetch a CallResult and feed the scorer's device batcher + connection
    maps; shared by the object-array and BAM-bytes entries. Returns
    (num_records, num_duplicated) or None on error."""
    from graphtyper_tpu_torch.ops.site_scoring import ALLELE_TIERS, _TierBuffer, apply_obs_host

    sites = scorer.sites
    site_cnum = np.array([s.gt.num for s in sites], dtype=np.int64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    try:
        N = n_obs.value
        o_site = np.zeros(N, dtype=np.int32)
        o_sample = np.zeros(N, dtype=np.int32)
        o_eps = np.zeros(N, dtype=np.int32)
        o_apply = np.zeros(N, dtype=np.uint8)
        o_bits_lo = np.zeros(N, dtype=np.uint32)
        o_bits_hi = np.zeros(N, dtype=np.uint32)
        o_cov = np.zeros(N, dtype=np.int32)
        o_clip_scaled = np.zeros(N, dtype=np.int32)
        o_clip_flag = np.zeros(N, dtype=np.uint8)
        o_mapq_sq = np.zeros(N, dtype=np.int32)
        o_mm_scaled = np.zeros(N, dtype=np.int32)
        o_sdiff = np.zeros(N, dtype=np.int32)
        o_strand = np.zeros(N, dtype=np.uint8)
        o_proper = np.zeros(N, dtype=np.uint8)
        o_big = np.zeros(N, dtype=np.uint8)
        x_count = np.zeros(N, dtype=np.int32)
        x_vals = np.zeros(n_xvals.value, dtype=np.uint16)
        c_hap1 = np.zeros(n_conn.value, dtype=np.int64)
        c_pn = np.zeros(n_conn.value, dtype=np.int32)
        c_b1 = np.zeros(n_conn.value, dtype=np.int32)
        c_hap2 = np.zeros(n_conn.value, dtype=np.int64)
        c_ncounts = np.zeros(n_conn.value, dtype=np.int32)
        c_counts = np.zeros(n_counts.value, dtype=np.int64)
        t_hap1 = np.zeros(n_touched.value, dtype=np.int64)
        t_pn = np.zeros(n_touched.value, dtype=np.int32)
        t_b1 = np.zeros(n_touched.value, dtype=np.int32)
        eps_sum = np.zeros(len(sites) * n_samples, dtype=np.int64)
        stats_out = np.zeros(2, dtype=np.int64)
        rc = lib.gt_call_pool_fetch(
            handle,
            ptr(o_site), ptr(o_sample), ptr(o_eps), ptr(o_apply),
            ptr(o_bits_lo), ptr(o_bits_hi), ptr(o_cov),
            ptr(o_clip_scaled), ptr(o_clip_flag), ptr(o_mapq_sq), ptr(o_mm_scaled),
            ptr(o_sdiff), ptr(o_strand), ptr(o_proper), ptr(o_big),
            ptr(x_count), ptr(x_vals),
            ptr(c_hap1), ptr(c_pn), ptr(c_b1), ptr(c_hap2), ptr(c_ncounts), ptr(c_counts),
            ptr(t_hap1), ptr(t_pn), ptr(t_b1),
            ptr(eps_sum), ptr(stats_out),
        )
        if rc != 0:
            return None  # unsupported condition -> Python fallback
    finally:
        lib.gt_call_pool_free(handle)

    # ---- feed the device scorer's tier buffers (vectorized split) ---------
    batcher = scorer.batcher
    assert batcher is not None
    batcher._eps_sum = eps_sum.reshape(len(sites), n_samples)

    _feed_obs(
        scorer, site_cnum,
        o_site, o_sample, o_eps, o_apply, o_bits_lo, o_bits_hi, o_cov,
        o_clip_scaled, o_clip_flag, o_mapq_sq, o_mm_scaled, o_sdiff,
        o_strand, o_proper, o_big, x_count, x_vals,
    )

    # ---- rebuild the phasing connection maps ------------------------------
    connections = scorer.connections
    for i in range(n_touched.value):
        connections[int(t_hap1[i])][int(t_pn[i])].setdefault(int(t_b1[i]), {})
    count_off = np.zeros(n_conn.value + 1, dtype=np.int64)
    np.cumsum(c_ncounts, out=count_off[1:])
    for i in range(n_conn.value):
        h1 = int(c_hap1[i])
        pn = int(c_pn[i])
        b1 = int(c_b1[i])
        h2 = int(c_hap2[i])
        arr = c_counts[count_off[i] : count_off[i + 1]].copy()
        conn = connections[h1][pn].setdefault(b1, {})
        prev = conn.get(h2)
        if prev is None:
            conn[h2] = arr
        else:
            prev += arr

    return int(stats_out[0]), int(stats_out[1])


def _setup_stream(lib) -> None:
    if getattr(lib, "_stream_ready", False):
        return
    lib.gt_stream_open.restype = ctypes.c_void_p
    lib.gt_stream_open.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
        + [ctypes.c_int32] * 5 + [ctypes.c_int64] * 2
        # SV mode: filter_begin, filter_end, is_sv, avg_cov, depth,
        # depth_ref_size, depth_ref_offset
        + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    )
    lib.gt_stream_step.restype = ctypes.c_int32
    lib.gt_stream_step.argtypes = (
        [ctypes.c_void_p]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # special
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sites
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4  # index
        + [ctypes.c_void_p]  # seed filter
        + [ctypes.c_void_p, ctypes.c_int32]  # verdict rows + verify flag
        + [_p64] * 2
    )
    lib.gt_stream_stage.restype = ctypes.c_int32
    lib.gt_stream_stage.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_void_p] * 5 + [ctypes.c_int32] * 2
    )
    lib.gt_stream_fetch_obs.restype = ctypes.c_int32
    lib.gt_stream_fetch_obs.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 17
    lib.gt_stream_finish.restype = ctypes.c_void_p
    # handle + 19 graph/site view args (SV leftover resolution) + 5 outs
    lib.gt_stream_finish.argtypes = (
        [ctypes.c_void_p]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # ref
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]  # var
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # special
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # sites
        + [_p64] * 5
    )
    lib.gt_stream_free.restype = None
    lib.gt_stream_free.argtypes = [ctypes.c_void_p]
    try:  # older builds predate the staged-batch spill
        lib.gt_stream_spill.restype = ctypes.c_int32
        lib.gt_stream_spill.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    except AttributeError:
        pass
    lib._stream_ready = True


def _bam_header_streaming(path: str):
    """(ref_names, samples) from just the header blocks of a BAM file —
    reads only as much as the header needs, never the whole file."""
    import struct

    from graphtyper_tpu_torch.io.bgzf import BgzfReader

    with BgzfReader(path) as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            return None
        (l_text,) = struct.unpack("<i", f.read(4))
        text = f.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", f.read(4))
        ref_names = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", f.read(4))
            ref_names.append(f.read(l_name)[:-1].decode())
            f.read(4)
        samples = []
        if not _names_from_filename():
            for line in text.split("\n"):
                if line.startswith("@RG"):
                    for fld in line.split("\t")[1:]:
                        if fld.startswith("SM:") and fld[3:] not in samples:
                            samples.append(fld[3:])
        return ref_names, samples


def _graph_site_arrays(graph, scorer):
    sites = scorer.sites
    return (
        np.array([s.gt.id for s in sites], dtype=np.int64),
        np.array([s.gt.num for s in sites], dtype=np.int64),
        np.array([1 if graph.is_snp(s.gt) else 0 for s in sites], dtype=np.uint8),
    )


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def run_native_call_pool_bam(
    graph,
    index,
    hts_paths: list[str],
    region,
    device: torch.device | str,
    sam_flag_filter: int = 3840,
    force_both: bool = False,
    hq_reads: bool = False,
    n_threads: int = 0,
    avg_cov: list | None = None,
    ref_path: str | None = None,
    mesh=None,
    rep_oracle=None,
):
    """Fork of graphtyper_tpu/pipeline/native_caller.py:443: BAM bytes
    straight into the C++ pooled loop, observation rows into the port's
    scorer on `device`. On a non-SV pool, with device_seed on the 97-probe
    seeding runs on `device` (ops/seed_probe.py) and the host verifies the
    candidates; with device_align on or verify the verdict kernel
    (ops/device_align.py) decides which rows skip the host's seed, lattice
    and walk. `mesh` (a parallel/mesh.py Mesh) shards the scorer's flushes;
    `rep_oracle` (a rep_shard.RepOracle) hands the engine the rows other
    hosts aligned. Returns (sample_names, scorer, num_records,
    num_duplicated, reference_depth) or None when the pool needs the object
    path (non-BAM input, multi-sample files, no region)."""
    if region is None or not all(p.endswith((".bam", ".cram")) for p in hts_paths):
        return None
    lib = get_lib()
    if lib is None:
        return None
    _setup_lib(lib)

    from graphtyper_tpu_torch.config import current_options

    is_sv = graph.is_sv_graph
    device = torch.device(device)

    # SV pools read only the region's overlaps (the reference's iterator
    # semantics); SNP pools run on bamshrink output that is already sliced
    entry = _get_prep(
        lib, hts_paths, region, sam_flag_filter, force_both,
        position_filter=is_sv, ref_path=ref_path,
    )
    if entry is None:
        return None
    try:
        sample_names = entry.sample_names
        scorer = SiteScorer(graph, sample_names, device, hq_reads=hq_reads, mesh=mesh)

        from graphtyper_tpu_torch.typer.native_align import NativeAligner, seed_filter_handle

        na = NativeAligner(graph, index)
        site_order, site_cnum, site_is_snp = _graph_site_arrays(graph, scorer)
        if n_threads <= 0:
            n_threads = native_thread_count()

        opts = current_options()
        cand_words = None
        if not is_sv and entry.n_rows > 0 and entry.nk_max > 0 and _device_seed_enabled(opts):
            cand_words = np.ascontiguousarray(_device_seed_words(index, entry, lib, device))
        verd_rows = None
        dal_mode = device_align_mode(opts)
        if not is_sv and entry.n_rows > 0 and entry.nk_max >= 2 and dal_mode in ("on", "verify"):
            verd_rows = _device_align_verdicts(na, index, entry, lib, device)

        n_obs = ctypes.c_int64()
        n_xvals = ctypes.c_int64()
        n_conn = ctypes.c_int64()
        n_counts = ctypes.c_int64()
        n_touched = ctypes.c_int64()
        ptr = _ptr
        graph_site_index_args = (
            ptr(na.ref_order), ptr(na.ref_dna_start), ptr(na.ref_dna_len),
            ptr(na.ref_var_first), len(na.ref_order), ptr(na.ref_arena),
            ptr(na.var_order), ptr(na.var_dna_start), ptr(na.var_dna_len),
            ptr(na.var_out_ref), len(na.var_order), ptr(na.var_arena),
            ptr(na.sp_ref_reach), ptr(na.sp_actual), len(na.sp_ref_reach),
            ptr(site_order), ptr(site_cnum), ptr(site_is_snp), len(site_order),
            ptr(na.keys), len(na.keys), ptr(na.offsets),
            ptr(na.lab_start), ptr(na.lab_end), ptr(na.lab_var),
        )
        outs = (
            ctypes.byref(n_obs), ctypes.byref(n_xvals), ctypes.byref(n_conn),
            ctypes.byref(n_counts), ctypes.byref(n_touched),
        )
        reference_depth = None
        if is_sv:
            if avg_cov is not None and len(avg_cov) != len(sample_names):
                return None  # per-file list vs sample count mismatch: object path
            from graphtyper_tpu_torch.pipeline.caller import ReferenceDepth

            reference_depth = ReferenceDepth(graph, len(sample_names))
            avg_arr = (
                np.ascontiguousarray(avg_cov, dtype=np.float64) if avg_cov is not None else None
            )
            handle = lib.gt_call_finish_sv(
                entry.handle,
                *graph_site_index_args,
                len(sample_names), 1 if hq_reads else 0, n_threads,
                seed_filter_handle(index, lib, n_threads),
                ptr(avg_arr) if avg_arr is not None else None,
                ptr(reference_depth.depths), reference_depth.depths.shape[1],
                int(reference_depth.reference_offset),
                *outs,
            )
        else:
            # the oracle's 12 arrays (ExtView, native/gt_align.cpp), kept
            # alive across the call
            ext = None if rep_oracle is None else rep_oracle.resolve(*entry.fetch_row_seqs(lib))
            handle = lib.gt_call_finish(
                entry.handle,
                *graph_site_index_args,
                None if cand_words is None else ptr(cand_words),
                0 if cand_words is None else entry.nk_max,
                None if verd_rows is None else ptr(verd_rows), 1 if dal_mode == "verify" else 0,
                *([None] * 12 if ext is None else [ptr(a) for a in ext]),
                len(sample_names), 1 if hq_reads else 0, n_threads,
                seed_filter_handle(index, lib, n_threads),
                *outs,
            )
            del ext
        stats = _consume_call_result(
            lib, handle, scorer, len(sample_names), n_obs, n_xvals, n_conn, n_counts, n_touched
        )
        if stats is None:
            return None
        return sample_names, scorer, stats[0], stats[1], reference_depth
    finally:
        entry.release(lib)


def run_native_call_pool_stream(
    graph,
    index,
    hts_paths: list[str],
    region,
    device: torch.device | str,
    sam_flag_filter: int = 3840,
    force_both: bool = False,
    hq_reads: bool = False,
    n_threads: int = 0,
    batch_records: int = 1 << 18,
    avg_cov: list | None = None,
    stream_spill: str | None = None,
    mesh=None,
):
    """Fork of graphtyper_tpu/pipeline/native_caller.py:981: the
    bounded-memory pooled call (BGZF stream + heap merge, fixed-size batches)
    with every batch's observation rows drained into the port's scorer on
    `device`. With device_align on or verify (non-SV), each batch's rows
    are staged one batch ahead and their verdicts computed on `device`
    while the host aligns the batch before (JAX :1137-1251). `mesh`
    shards the scorer's flushes over its entries. Same spill/replay
    protocol and return value as the JAX package's; None to fall back to
    the in-memory path."""
    if region is None or not all(p.endswith(".bam") for p in hts_paths):
        return None
    lib = get_lib()
    if lib is None:
        return None
    _setup_lib(lib)
    _setup_stream(lib)

    sample_names: list[str] = []
    for path in hts_paths:
        meta = _bam_header_streaming(path)
        if meta is None:
            return None
        _ref_names, samples = meta
        if not samples:
            samples = [path.rsplit("/", 1)[-1].split(".")[0]]
        if len(samples) > 1:
            return None
        sample_names.append(samples[0])

    is_sv = bool(graph.is_sv_graph)
    if is_sv and avg_cov is not None and len(avg_cov) != len(sample_names):
        return None  # per-file coverage list vs sample count mismatch

    from graphtyper_tpu_torch.config import current_options
    from graphtyper_tpu_torch.typer.native_align import NativeAligner, seed_filter_handle

    device = torch.device(device)
    scorer = SiteScorer(graph, sample_names, device, hq_reads=hq_reads, mesh=mesh)
    na = NativeAligner(graph, index)
    site_order, site_cnum, site_is_snp = _graph_site_arrays(graph, scorer)
    if n_threads <= 0:
        n_threads = native_thread_count()

    path_bytes = [p.encode() for p in hts_paths]
    path_arr = (ctypes.c_char_p * len(path_bytes))(*path_bytes)
    sample_idx = np.arange(len(hts_paths), dtype=np.int32)
    ptr = _ptr

    reference_depth = None
    avg_arr = None
    if is_sv:
        from graphtyper_tpu_torch.pipeline.caller import ReferenceDepth

        reference_depth = ReferenceDepth(graph, len(sample_names))
        if avg_cov is not None:
            avg_arr = np.ascontiguousarray(avg_cov, dtype=np.float64)
    handle = lib.gt_stream_open(
        ctypes.cast(path_arr, ctypes.c_void_p), ptr(sample_idx), len(hts_paths),
        region.chr.encode(),
        len(sample_names), sam_flag_filter, 1 if force_both else 0, 1 if hq_reads else 0,
        n_threads, batch_records, len(scorer.sites),
        int(region.begin) if is_sv else -1, int(region.end) if is_sv else -1,
        1 if is_sv else 0,
        ptr(avg_arr) if avg_arr is not None else None,
        ptr(reference_depth.depths) if reference_depth is not None else None,
        reference_depth.depths.shape[1] if reference_depth is not None else 0,
        int(reference_depth.reference_offset) if reference_depth is not None else 0,
    )
    if not handle:
        return None

    if stream_spill and hasattr(lib, "gt_stream_spill"):
        import json as _json
        import os as _os

        key = {
            "v": 1,
            "paths": [
                [_os.path.abspath(p), _os.stat(p).st_mtime_ns, _os.stat(p).st_size]
                for p in hts_paths
            ],
            "chr": region.chr,
            "sv_filter": [int(region.begin), int(region.end)] if is_sv else None,
        }
        keyfile = stream_spill + ".key"
        valid = False
        if _os.path.exists(stream_spill) and _os.path.exists(keyfile):
            try:
                with open(keyfile) as f:
                    valid = _json.load(f) == key
            except (OSError, ValueError):
                valid = False
        mode = 2 if valid else 1
        if mode == 1:
            # spill ≈ decompressed record bytes ≈ 4x the BGZF input; only
            # write when it fits comfortably (the stream works without it)
            try:
                st = _os.statvfs(_os.path.dirname(stream_spill) or ".")
                free = st.f_bavail * st.f_frsize
            except OSError:
                free = 0
            if 4 * sum(k[2] for k in key["paths"]) > free // 2:
                mode = 0
        if mode and lib.gt_stream_spill(handle, stream_spill.encode(), mode) and mode == 1:
            with open(keyfile, "w") as f:
                _json.dump(key, f)

    n_obs = ctypes.c_int64()
    n_xvals = ctypes.c_int64()
    gargs = (
        ptr(na.ref_order), ptr(na.ref_dna_start), ptr(na.ref_dna_len),
        ptr(na.ref_var_first), len(na.ref_order), ptr(na.ref_arena),
        ptr(na.var_order), ptr(na.var_dna_start), ptr(na.var_dna_len),
        ptr(na.var_out_ref), len(na.var_order), ptr(na.var_arena),
        ptr(na.sp_ref_reach), ptr(na.sp_actual), len(na.sp_ref_reach),
        ptr(site_order), ptr(site_cnum), ptr(site_is_snp), len(site_order),
        ptr(na.keys), len(na.keys), ptr(na.offsets),
        ptr(na.lab_start), ptr(na.lab_end), ptr(na.lab_var),
        seed_filter_handle(index, lib, n_threads),
    )

    # Device-align pipeline (non-SV): gt_stream_stage dedups batch N and
    # exports its rows; the verdict kernel for batch N runs on the device
    # while gt_stream_step aligns batch N-1 on the host. Two batches stay
    # staged ahead.
    dal = None
    dal_mode = "off"
    if not is_sv:
        dal_mode = device_align_mode(current_options())
        if dal_mode in ("on", "verify"):
            dal = _device_aligner(na, index, device)
    pending = deque() if dal is not None else None
    stage_eof = False
    cap_rows = 2 * batch_records + 16

    def do_stage() -> bool:
        """Stage one batch and launch its verdicts; False on a spill
        error."""
        nonlocal stage_eof
        from graphtyper_tpu_torch.ops.device_align import TAIL_PAD, stage_tails
        from graphtyper_tpu_torch.ops.seed_probe import stage_kmers

        hi = np.empty((cap_rows, NK_CAP), np.uint32)
        lo = np.empty((cap_rows, NK_CAP), np.uint32)
        valid = np.empty((cap_rows, NK_CAP), np.uint8)
        tails = np.empty((cap_rows, TAIL_PAD), np.uint8)
        lens = np.empty(cap_rows, np.int32)
        rcs = lib.gt_stream_stage(
            handle, ptr(hi), ptr(lo), ptr(valid), ptr(tails), ptr(lens), cap_rows, NK_CAP,
        )
        if rcs == -1:  # drained
            stage_eof = True
            return True
        if rcs == -2:
            return False
        if rcs == -3:  # more rows than cap_rows: the batch steps without verdicts
            pending.append(None)
            return True
        # ship only the kmer columns this batch uses (151 bp reads need 4)
        nk_eff = NK_CAP
        if rcs > 0:
            max_len = int(lens[:rcs].max())
            nk_eff = max(2, min(NK_CAP, 1 + (max_len - 32) // 31)) if max_len >= 32 else 2
        kmers = stage_kmers(hi[:rcs, :nk_eff], lo[:rcs, :nk_eff], valid[:rcs, :nk_eff], device)
        tails_dev, lens_dev = stage_tails(tails[:rcs], lens[:rcs], device)
        pending.append(dal.verdicts_async(kmers, tails_dev, lens_dev, rcs, nk_eff))
        return True

    try:
        while True:
            if pending is None:
                rc = lib.gt_stream_step(
                    handle, *gargs, None, 0, ctypes.byref(n_obs), ctypes.byref(n_xvals),
                )
            else:
                staged = True
                while staged and not stage_eof and len(pending) < 2:
                    staged = do_stage()
                batch = pending.popleft() if pending else None
                verd = None if batch is None else batch.wait()  # alive across the C call
                if not staged:
                    rc = -1  # spill error: re-stream below
                else:
                    rc = lib.gt_stream_step(
                        handle, *gargs, None if verd is None else ptr(verd),
                        1 if verd is not None and dal_mode == "verify" else 0,
                        ctypes.byref(n_obs), ctypes.byref(n_xvals),
                    )
            if rc == 0:
                break
            if rc < 0:  # spill replay inconsistency: discard and re-stream
                # (the enclosing finally frees this handle)
                import os as _os

                for junk in (stream_spill, stream_spill + ".key"):
                    try:
                        _os.remove(junk)
                    except OSError:
                        pass
                return run_native_call_pool_stream(
                    graph, index, hts_paths, region, device,
                    sam_flag_filter=sam_flag_filter, force_both=force_both,
                    hq_reads=hq_reads, n_threads=n_threads,
                    batch_records=batch_records, avg_cov=avg_cov,
                    stream_spill=None,
                )
            N = n_obs.value
            o_site = np.zeros(N, dtype=np.int32)
            o_sample = np.zeros(N, dtype=np.int32)
            o_eps = np.zeros(N, dtype=np.int32)
            o_apply = np.zeros(N, dtype=np.uint8)
            o_bits_lo = np.zeros(N, dtype=np.uint32)
            o_bits_hi = np.zeros(N, dtype=np.uint32)
            o_cov = np.zeros(N, dtype=np.int32)
            o_clip_scaled = np.zeros(N, dtype=np.int32)
            o_clip_flag = np.zeros(N, dtype=np.uint8)
            o_mapq_sq = np.zeros(N, dtype=np.int32)
            o_mm_scaled = np.zeros(N, dtype=np.int32)
            o_sdiff = np.zeros(N, dtype=np.int32)
            o_strand = np.zeros(N, dtype=np.uint8)
            o_proper = np.zeros(N, dtype=np.uint8)
            o_big = np.zeros(N, dtype=np.uint8)
            x_count = np.zeros(N, dtype=np.int32)
            x_vals = np.zeros(n_xvals.value, dtype=np.uint16)
            lib.gt_stream_fetch_obs(
                handle,
                ptr(o_site), ptr(o_sample), ptr(o_eps), ptr(o_apply),
                ptr(o_bits_lo), ptr(o_bits_hi), ptr(o_cov),
                ptr(o_clip_scaled), ptr(o_clip_flag), ptr(o_mapq_sq), ptr(o_mm_scaled),
                ptr(o_sdiff), ptr(o_strand), ptr(o_proper), ptr(o_big),
                ptr(x_count), ptr(x_vals),
            )
            _feed_obs(
                scorer, site_cnum,
                o_site, o_sample, o_eps, o_apply, o_bits_lo, o_bits_hi, o_cov,
                o_clip_scaled, o_clip_flag, o_mapq_sq, o_mm_scaled, o_sdiff,
                o_strand, o_proper, o_big, x_count, x_vals,
            )
            scorer.batcher.maybe_flush()
        n_conn = ctypes.c_int64()
        n_counts = ctypes.c_int64()
        n_touched = ctypes.c_int64()
        res = lib.gt_stream_finish(
            handle,
            ptr(na.ref_order), ptr(na.ref_dna_start), ptr(na.ref_dna_len),
            ptr(na.ref_var_first), len(na.ref_order), ptr(na.ref_arena),
            ptr(na.var_order), ptr(na.var_dna_start), ptr(na.var_dna_len),
            ptr(na.var_out_ref), len(na.var_order), ptr(na.var_arena),
            ptr(na.sp_ref_reach), ptr(na.sp_actual), len(na.sp_ref_reach),
            ptr(site_order), ptr(site_cnum), ptr(site_is_snp), len(site_order),
            ctypes.byref(n_obs), ctypes.byref(n_xvals), ctypes.byref(n_conn),
            ctypes.byref(n_counts), ctypes.byref(n_touched),
        )
    finally:
        lib.gt_stream_free(handle)
    stats = _consume_call_result(
        lib, res, scorer, len(sample_names), n_obs, n_xvals, n_conn, n_counts, n_touched
    )
    if stats is None:
        return None
    return sample_names, scorer, stats[0], stats[1], reference_depth
