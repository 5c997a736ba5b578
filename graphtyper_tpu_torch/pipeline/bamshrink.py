"""bamshrink: read-preprocessing copy step.

Reference semantics: src/utilities/bamshrink.cpp — region slice padded by
maxFragLen-100 (:685-688), paired filters (:735-773: MAPQ gates, length >= 75,
clip/match/base-quality gates), unpaired filters (:715-733: MAPQ >= 40,
length >= 94), AS-XS alignment-score filter threshold 40 + adapter removal
(:606), soft-clip trimming (:463), N-end trimming (:502), per-50bp-bin
coverage cap avgCov*50*2.5 (:709-711), base-quality binarization to two
levels ('?' for >= 24 else ',', :85-89), and compact base-93 read renaming
(:48-64).
"""

from __future__ import annotations


import numpy as np

from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.config import Options
from graphtyper_tpu_torch.io.bam import AlignedRead, read_alignments
from graphtyper_tpu_torch.io.bam_writer import write_bam
from graphtyper_tpu_torch.io.sam_writer import write_sam

CHAR_SET_SIZE = 93


def _long_to_ascii(v: int) -> str:
    if v >= 31:
        v += 1
    return chr(ord("!") + v)


def decimal_to_read_name(v: int) -> str:
    out = []
    while v >= CHAR_SET_SIZE:
        out.append(_long_to_ascii(v % CHAR_SET_SIZE))
        v //= CHAR_SET_SIZE
    out.append(_long_to_ascii(v))
    return "".join(out)


def _count_matching(cigar) -> int:
    return sum(c for op, c in cigar if op == 0)


def _count_high_base_quality(qual: np.ndarray) -> int:
    return int((qual >= 20).sum())


def _is_clipped_both_ends(cigar, min_clip: int = 15) -> bool:
    return (
        len(cigar) >= 1
        and cigar[0][0] == 4
        and cigar[-1][0] == 4
        and cigar[0][1] + cigar[-1][1] >= min_clip
    )


def _is_one_end_clipped(cigar, min_clip: int = 0) -> bool:
    return (
        len(cigar) == 0
        or (cigar[0][0] == 4 and cigar[0][1] >= min_clip)
        or (cigar[-1][0] == 4 and cigar[-1][1] >= min_clip)
    )


def _binarize_qual(qual: np.ndarray) -> np.ndarray:
    # '?'-33 = 30, ','-33 = 11
    return np.where(qual >= 24, 30, 11).astype(np.uint8)


def _remove_hard_clipped(cigar) -> list:
    out = list(cigar)
    if out and out[0][0] == 5:
        out = out[1:]
    if len(out) >= 2 and out[-1][0] == 5:
        out = out[:-1]
    return out


def _trim_n_ends(read: AlignedRead, opts: Options) -> bool:
    """removeNsAtEnds (bamshrink.cpp:502-560)."""
    seq = read.seq
    n = 0
    while n < len(seq) - 1 and seq[n : n + 1] == b"N":
        n += 1
    if n > 0:
        read.seq = seq[n:]
        read.qual = read.qual[n:]
        shift, read.cigar = _reset_cigar_begin(read.cigar, n)
        read.pos += shift
    if len(read.seq) < opts.bamshrink_min_readlen or (
        read.mapq < 25 and len(read.seq) < opts.bamshrink_min_readlen_low_mapq
    ):
        return False
    seq = read.seq
    n = 0
    while n < len(seq) - 1 and seq[len(seq) - 1 - n : len(seq) - n] == b"N":
        n += 1
    if n > 0:
        read.seq = seq[:-n]
        read.qual = read.qual[:-n]
        read.cigar = _reset_cigar_end(read.cigar, n)
    return not (
        len(read.seq) < opts.bamshrink_min_readlen
        or (read.mapq < 25 and len(read.seq) < opts.bamshrink_min_readlen_low_mapq)
    )


def _reset_cigar_begin(cigar, n_removed: int):
    """bamshrink.cpp resetCigarStringBegin: consume n query bases from the
    CIGAR front; returns (ref_shift, new_cigar)."""
    cigar = list(cigar)
    shift = 0
    while n_removed > 0 and cigar:
        op, cnt = cigar[0]
        consumes_query = op in (0, 1, 4, 7, 8)
        consumes_ref = op in (0, 2, 3, 7, 8)
        if not consumes_query:
            if consumes_ref:
                shift += cnt
            cigar.pop(0)
            continue
        take = min(cnt, n_removed)
        if consumes_ref:
            shift += take
        n_removed -= take
        if take == cnt:
            cigar.pop(0)
        else:
            cigar[0] = (op, cnt - take)
    # leading deletion after trim is dropped
    if cigar and cigar[0][0] == 2:
        shift += cigar[0][1]
        cigar.pop(0)
    return shift, cigar


def _reset_cigar_end(cigar, n_removed: int):
    cigar = list(cigar)
    while n_removed > 0 and cigar:
        op, cnt = cigar[-1]
        consumes_query = op in (0, 1, 4, 7, 8)
        if not consumes_query:
            cigar.pop()
            continue
        take = min(cnt, n_removed)
        n_removed -= take
        if take == cnt:
            cigar.pop()
        else:
            cigar[-1] = (op, cnt - take)
    if cigar and cigar[-1][0] == 2:
        cigar.pop()
    return cigar


def _process_tags(read: AlignedRead, opts: Options) -> bool:
    """AS/XS alignment-score gate (bamshrink.cpp process_tags); keeps only
    RG/AS/XS/WS tags."""
    as_ = read.tags.get("AS", -1)
    xs = read.tags.get("XS", -1)
    ws = read.tags.get("WS", -1)
    if as_ != -1 and ws == -1:
        ws = as_
    is_paired = bool(read.flag & 0x1)
    mate_unmapped = bool(read.flag & 0x8)
    if ws != -1 and xs != -1 and (not is_paired or mate_unmapped):
        if ws <= xs + 5:
            return False
        matches = sum(c for op, c in read.cigar if op == 0)
        indels = sum(c + 2 for op, c in read.cigar if op in (1, 2))
        if max(ws, as_) + opts.bamshrink_as_filter_threshold <= matches - indels:
            return False
    read.tags = {k: v for k, v in read.tags.items() if k in ("RG", "AS", "XS", "WS")}
    return True


def _shrink_region(
    header,
    reads: list[AlignedRead],
    chrom: str,
    region_begin: int,
    region_end: int,
    avg_cov_by_readlen: float,
    opts: Options,
    kept: list[AlignedRead],
    seen: set[int],
) -> None:
    """The per-region filter/trim loop; appends surviving reads to `kept`
    (each input record at most once across regions, tracked via `seen`)."""
    pad = opts.bamshrink_max_fraglen - 100
    lo = max(0, region_begin - pad)
    hi = region_end + pad
    max_bin_sum = (2**30) if opts.no_filter_on_coverage or avg_cov_by_readlen <= 0 else int(avg_cov_by_readlen * 50.0 * 2.5)

    read_num = 0
    first_pos = -1
    bin_counts: dict[int, int] = {}

    def filter_unpaired(r: AlignedRead) -> bool:
        if r.pos + len(r.seq) < region_begin or r.pos > region_end:
            return False
        if (
            r.mapq < 40
            or len(r.seq) < opts.bamshrink_min_unpair_readlen
            or _is_one_end_clipped(r.cigar, 12)
            or _is_clipped_both_ends(r.cigar, 5)
            or _count_matching(r.cigar) < opts.bamshrink_min_matching + 5
            or _count_high_base_quality(r.qual) < len(r.seq) // 4
        ):
            return False
        return True

    def filter_paired(r: AlignedRead) -> bool:
        if not opts.bamshrink_is_not_filtering_mapq0 and r.mapq <= 1:
            return False
        if r.pos + len(r.seq) < region_begin and r.pos + r.tlen < region_begin:
            return False
        if r.pos > region_end and r.pos + r.tlen - len(r.seq) > region_end:
            return False
        if r.flag & 0x4:
            return True  # unmapped with mapped mate allowed
        if (
            len(r.seq) < opts.bamshrink_min_readlen
            or (r.mapq < 55 and _is_clipped_both_ends(r.cigar, 12))
            or (r.mapq < 5 and _is_one_end_clipped(r.cigar, len(r.seq) // 4))
            or _is_clipped_both_ends(r.cigar, len(r.seq) // 3)
            or _count_matching(r.cigar) < opts.bamshrink_min_matching
            or _count_high_base_quality(r.qual) <= len(r.seq) // 10
        ):
            return False
        return True

    for r in reads:
        if id(r) in seen:
            continue
        if r.ref_id < 0 or header.ref_names[r.ref_id] != chrom:
            continue
        if r.pos < lo or r.pos > hi:
            continue
        if (r.flag & opts.sam_flag_filter) or (r.tlen != 0 and abs(r.tlen) < opts.bamshrink_min_readlen):
            continue
        is_paired = bool(r.flag & 0x1)
        if is_paired:
            if not filter_paired(r):
                continue
        else:
            if not filter_unpaired(r):
                continue
        if not _process_tags(r, opts):
            continue
        if not _trim_n_ends(r, opts):
            continue
        if first_pos < 0:
            first_pos = r.pos
        b = (r.pos - first_pos) // 50
        if bin_counts.get(b, 0) >= max_bin_sum // 3:
            bin_counts[b] = bin_counts.get(b, 0) + 1
            continue
        bin_counts[b] = bin_counts.get(b, 0) + 1
        r.qual = _binarize_qual(r.qual)
        r.cigar = _remove_hard_clipped(r.cigar)
        seen.add(id(r))
        kept.append(r)


def _rename_sort_write(header, kept: list[AlignedRead], out_path: str) -> str:
    # compact base-93 read renaming; mates share the original name, so they
    # share the new name too (bamshrink.cpp:48-64 CHANGE_READ_NAMES)
    name_map: dict[str, str] = {}
    for r in kept:
        new = name_map.get(r.name)
        if new is None:
            new = decimal_to_read_name(len(name_map))
            name_map[r.name] = new
        r.name = new
    kept.sort(key=lambda x: x.pos)
    if out_path.endswith(".bam"):
        write_bam(out_path, header, kept)
    else:
        write_sam(out_path, header, kept)
    from graphtyper_tpu_torch.io.bam import prime_read_cache

    prime_read_cache(out_path, header, kept)
    return out_path


def _bamshrink_native(
    path: str,
    intervals: list[tuple[str, int, int]],
    out_path: str,
    avg_cov_by_readlen: float,
    opts: Options,
    ref_path: str | None = None,
) -> str | None:
    """Run the whole shrink (decode + filter + trim + rename + encode) in the
    native runtime (native/gt_bamshrink.cpp); returns None to fall back."""
    if not (path.endswith(".bam") or path.endswith(".cram")) or not out_path.endswith(".bam"):
        return None
    from graphtyper_tpu_torch.io.native import get_lib

    lib = get_lib()
    import ctypes
    import struct

    from graphtyper_tpu_torch.io.bgzf import BGZF_EOF, bgzf_compress_bulk, decompress_all

    # the shrink keeps reads with pos in [begin-pad, end+pad]
    # (pad = bamshrink_max_fraglen - 100, _shrink_region above); query a
    # superset of that window so the filters reproduce the full output
    pad = opts.bamshrink_max_fraglen - 100 + 1
    padded = [(c, max(0, b - pad), e + pad) for c, b, e in intervals]
    data = None
    if path.endswith(".cram"):
        # CRAM -> decompressed-BAM bytes natively (container-granular region
        # decode; io/cram_native.py), then the same native shrink
        from graphtyper_tpu_torch.io.cram_native import cram_to_bam_bytes

        region = padded[0] if len(padded) == 1 else None
        data = cram_to_bam_bytes(path, region=region, ref_path=ref_path)
        if data is None:
            return None
    if data is None:
        # indexed input: decode only the BGZF chunks overlapping the
        # intervals (htslib-iterator analog, io/bai.py) — O(slice) instead
        # of O(file) per region, which is what keeps the 50kb region
        # fan-out linear at chromosome scale
        try:
            from graphtyper_tpu_torch.io.bai import read_region_bam_bytes

            data = read_region_bam_bytes(path, padded)
        except Exception:
            data = None
    if data is None:
        data = decompress_all(path)
    if data[:4] != b"BAM\x01":
        return None
    # resolve contig names -> BAM ref ids
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    name2id = {}
    for i in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        name2id[data[off : off + l_name - 1].decode()] = i
        off += l_name + 4
    itv_ref, itv_begin, itv_end = [], [], []
    for chrom, begin, end in intervals:
        rid = name2id.get(chrom)
        if rid is None:
            continue
        itv_ref.append(rid)
        itv_begin.append(begin)
        itv_end.append(end)
    if not itv_ref:
        itv_ref, itv_begin, itv_end = [-1], [0], [0]

    if not getattr(lib, "_shrink_ready", False):
        lib.gt_bamshrink.restype = ctypes.c_void_p
        lib.gt_bamshrink.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gt_bamshrink_fetch.restype = ctypes.c_int32
        lib.gt_bamshrink_fetch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.gt_bamshrink_free.restype = None
        lib.gt_bamshrink_free.argtypes = [ctypes.c_void_p]
        lib._shrink_ready = True

    opt_ints = np.array(
        [
            opts.bamshrink_max_fraglen,
            opts.bamshrink_min_matching,
            1 if opts.bamshrink_is_not_filtering_mapq0 else 0,
            opts.bamshrink_min_readlen,
            opts.bamshrink_min_readlen_low_mapq,
            opts.bamshrink_min_unpair_readlen,
            opts.bamshrink_as_filter_threshold,
            opts.sam_flag_filter,
            1 if opts.no_filter_on_coverage else 0,
        ],
        dtype=np.int64,
    )
    buf = np.frombuffer(data, dtype=np.uint8)
    a_ref = np.array(itv_ref, dtype=np.int64)
    a_beg = np.array(itv_begin, dtype=np.int64)
    a_end = np.array(itv_end, dtype=np.int64)
    out_size = ctypes.c_int64()
    n_kept = ctypes.c_int64()
    handle = lib.gt_bamshrink(
        buf.ctypes.data_as(ctypes.c_void_p), len(data),
        a_ref.ctypes.data_as(ctypes.c_void_p), a_beg.ctypes.data_as(ctypes.c_void_p),
        a_end.ctypes.data_as(ctypes.c_void_p), len(a_ref),
        opt_ints.ctypes.data_as(ctypes.c_void_p), float(avg_cov_by_readlen),
        ctypes.byref(out_size), ctypes.byref(n_kept),
    )
    try:
        out = np.zeros(out_size.value, dtype=np.uint8)
        rc = lib.gt_bamshrink_fetch(handle, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            return None
    finally:
        lib.gt_bamshrink_free(handle)
    counters.add("bamshrink_reads", n_kept.value)
    out_bytes = out.tobytes()
    compressed = bgzf_compress_bulk(out_bytes)
    with open(out_path, "wb") as f:
        f.write(compressed)
        f.write(BGZF_EOF)
    # seed the caller's decompressed-bytes cache: the pooled caller and the
    # discovery first pass read this exact file next, and decompress_all of
    # what was just written is identically `out_bytes`
    try:
        import os as _os

        from graphtyper_tpu_torch.pipeline import native_caller as _nc

        st = _os.stat(out_path)
        key = (_os.path.abspath(out_path), st.st_mtime_ns, st.st_size, None, None)
        _nc._cache_put(key, out_bytes)
    except Exception:
        pass
    return out_path


def bamshrink(
    sam_path: str,
    chrom: str,
    region_begin: int,
    region_end: int,
    out_path: str,
    avg_cov_by_readlen: float = -1.0,
    opts: Options | None = None,
    ref_path: str | None = None,
) -> str:
    """Filter + trim + rename reads of one sample over one region; writes the
    kept reads sorted by position as BAM (.bam suffix — the reference writes
    temp BAMs, bamshrink.cpp:672 qualityFilterSlice2) or SAM (.sam)."""
    opts = opts or Options()
    from graphtyper_tpu_torch.config import current_options

    if current_options().native_aligner != "off":
        native = _bamshrink_native(
            sam_path, [(chrom, region_begin, region_end)], out_path, avg_cov_by_readlen,
            opts, ref_path=ref_path,
        )
        if native is not None:
            return native
    if sam_path.endswith(".cram"):
        # container-granular region decode (io/cram.py records(region=...)):
        # the shrink keeps reads with pos in [begin-pad, end+pad], so query
        # that window — superset semantics identical to the BAI slice path
        from graphtyper_tpu_torch.io.cram import read_cram

        pad = opts.bamshrink_max_fraglen - 100 + 1
        header, reads = read_cram(
            sam_path,
            parse_tags=True,
            region=(chrom, max(0, region_begin - pad), region_end + pad),
            ref_path=ref_path,
        )
    else:
        header, reads = read_alignments(sam_path, parse_tags=True)
    kept: list[AlignedRead] = []
    _shrink_region(header, reads, chrom, region_begin, region_end, avg_cov_by_readlen, opts, kept, set())
    counters.add("bamshrink_reads", len(kept))
    return _rename_sort_write(header, kept, out_path)


def bamshrink_multi(
    sam_path: str,
    intervals: list[tuple[str, int, int]],
    out_path: str,
    avg_cov_by_readlen: float = -1.0,
    opts: Options | None = None,
    ref_path: str | None = None,
) -> str:
    """Multi-interval slice of one sample into a single temp BAM
    (bamshrink.cpp:1352 bamshrink_multi, used by HLA genotyping over BED
    intervals, genotype_hla.cpp:106-107)."""
    opts = opts or Options()
    from graphtyper_tpu_torch.config import current_options

    if current_options().native_aligner != "off":
        native = _bamshrink_native(sam_path, intervals, out_path, avg_cov_by_readlen, opts,
                                   ref_path=ref_path)
        if native is not None:
            return native
    header, reads = read_alignments(sam_path, parse_tags=True)
    kept: list[AlignedRead] = []
    seen: set[int] = set()
    for chrom, begin, end in intervals:
        _shrink_region(header, reads, chrom, begin, end, avg_cov_by_readlen, opts, kept, seen)
    return _rename_sort_write(header, kept, out_path)


def run_bamshrink_multi(
    sams: list[str],
    interval_fn: str,
    tmp_dir: str,
    avg_cov_by_readlen: list[float] | None = None,
    opts: Options | None = None,
) -> list[str]:
    """Fan bamshrink_multi out per sample over the intervals of a BED file
    (genotype_hla.cpp run_bamshrink_multi)."""
    import os

    intervals: list[tuple[str, int, int]] = []
    with open(interval_fn) as f:
        for line in f:
            fields = line.split()
            if len(fields) >= 3:
                intervals.append((fields[0], int(fields[1]), int(fields[2])))
    import time

    from graphtyper_tpu_torch.config import current_options
    from graphtyper_tpu_torch.utils.log import get_logger

    os.makedirs(os.path.join(tmp_dir, "bams"), exist_ok=True)
    t0 = time.monotonic()

    def shrink_one(i_sam):
        i, sam = i_sam
        cov = avg_cov_by_readlen[i] if avg_cov_by_readlen else -1.0
        dst = os.path.join(tmp_dir, "bams", f"{i:04d}.bam")
        bamshrink_multi(sam, intervals, dst, cov, opts)
        return dst

    threads = max(1, getattr(opts or current_options(), "threads", 1))
    if threads > 1 and len(sams) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(threads, len(sams))) as ex:
            out = list(ex.map(shrink_one, enumerate(sams)))
    else:
        out = [shrink_one(t) for t in enumerate(sams)]
    get_logger().info(
        "Finished copying data. Thread work: samples=%d threads=%d wall=%.2fs",
        len(sams),
        min(threads, len(sams)),
        time.monotonic() - t0,
    )
    return out


def run_bamshrink(
    sams: list[str],
    region,
    tmp_dir: str,
    avg_cov_by_readlen: list[float] | None = None,
    opts: Options | None = None,
    ref_path: str | None = None,
) -> list[str]:
    """genotype.cpp:48-121 — fan out bamshrink per sample into tmp files
    over worker threads (the native shrink releases the GIL, so threads give
    real parallelism like the reference's paw::Station fan-out)."""
    import os
    import time

    from graphtyper_tpu_torch.config import current_options
    from graphtyper_tpu_torch.utils.log import get_logger

    os.makedirs(os.path.join(tmp_dir, "bams"), exist_ok=True)
    t0 = time.monotonic()

    def shrink_one(i_sam):
        i, sam = i_sam
        cov = avg_cov_by_readlen[i] if avg_cov_by_readlen else -1.0
        dst = os.path.join(tmp_dir, "bams", f"{i:04d}.bam")
        bamshrink(sam, region.chr, region.begin, region.end, dst, cov, opts, ref_path=ref_path)
        return dst

    threads = max(1, getattr(opts or current_options(), "threads", 1))
    if threads > 1 and len(sams) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(threads, len(sams))) as ex:
            out = list(ex.map(shrink_one, enumerate(sams)))
    else:
        out = [shrink_one(t) for t in enumerate(sams)]

    # DO NOT CHANGE THIS LOG LINE FORMAT (genotype.cpp:117 parsed-externally
    # metrics line)
    get_logger().info(
        "Finished copying data. Thread work: samples=%d threads=%d wall=%.2fs",
        len(sams),
        min(threads, len(sams)),
        time.monotonic() - t0,
    )
    # the reference names shrunk files <basename_wo_ext>.bam and sorts the
    # list (genotype.cpp:394), so the output sample order is lexicographic
    # by input basename unless --no_sample_name_reordering
    if not getattr(opts or current_options(), "no_sample_name_reordering", False):
        def _key(i_dst):
            base = os.path.basename(sams[i_dst[0]])
            stem = base.rsplit(".", 1)[0] if "." in base else base
            return stem + ".bam"

        out = [dst for _i, dst in sorted(enumerate(out), key=_key)]
    return out
