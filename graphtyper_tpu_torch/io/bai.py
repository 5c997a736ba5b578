"""BAI (BAM index) build / read / region query.

The reference consumes indexed BAMs through htslib's iterator
(sam_itr_querys in src/utilities/hts_reader.cpp); this is the from-scratch
twin: the SAM-spec R-tree binning scheme (5 levels, 16kb leaves) plus the
16kb linear index, so region reads decode only the BGZF blocks whose chunks
overlap the query instead of the whole file. Used by bamshrink and the
pooled readers — at chromosome scale the per-50kb-region input cost drops
from O(file) to O(slice).

Spec: SAMv1.pdf section 5 (BAI). Bin numbering/reg2bins are the standard
magic constants; chunks are record-aligned virtual offsets.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

BAI_MAGIC = b"BAI\x01"
LEAF_SHIFT = 14  # 16kb
_REF_CONSUME = {0, 2, 3, 7, 8}  # M, D, N, =, X


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that may contain records overlapping [beg, end)."""
    end -= 1
    out = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


def bgzf_block_table(path: str) -> tuple[list[int], list[int]]:
    """(coffsets, usizes) for every BGZF member, from the headers alone (BC
    subfield + trailing ISIZE) — no decompression."""
    coffsets: list[int] = []
    usizes: list[int] = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    n = len(data)
    while off + 18 <= n:
        bsize = int.from_bytes(data[off + 16 : off + 18], "little") + 1
        isize = int.from_bytes(data[off + bsize - 4 : off + bsize], "little")
        if isize > 0:  # skip the 28-byte EOF marker and empty blocks
            coffsets.append(off)
            usizes.append(isize)
        off += bsize
    return coffsets, usizes


def _scan_records_native(data: bytes, off: int):
    """(rec_off, tid, pos, ref_end) arrays via native/gt_native.cpp
    gt_bai_scan — the boundary chain is sequential, so the walk lives in C;
    returns None (Python fallback) when gt_bai_scan rejects a record."""
    from graphtyper_tpu_torch.io.native import get_lib

    lib = get_lib()
    import ctypes

    import numpy as np

    if not getattr(lib, "_baiscan_ready", False):
        lib.gt_bai_scan.restype = ctypes.c_int64
        lib.gt_bai_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._baiscan_ready = True
    cap = max(1, (len(data) - off) // 36 + 1)
    rec_off = np.empty(cap, dtype=np.int64)
    tid = np.empty(cap, dtype=np.int32)
    pos = np.empty(cap, dtype=np.int32)
    ref_end = np.empty(cap, dtype=np.int32)
    vp = ctypes.c_void_p
    n = lib.gt_bai_scan(
        data, len(data), off,
        vp(rec_off.ctypes.data), vp(tid.ctypes.data), vp(pos.ctypes.data),
        vp(ref_end.ctypes.data),
    )
    if n < 0:
        return None
    return rec_off[:n], tid[:n], pos[:n], ref_end[:n]


@dataclass
class Bai:
    bins: list[dict[int, list[tuple[int, int]]]]  # per ref: bin -> chunks
    linear: list[list[int]]  # per ref: 16kb window -> min voffset
    n_no_coor: int = 0


def build_bai(bam_path: str, bai_path: str | None = None) -> str:
    """Index a coordinate-sorted BAM; writes `<bam>.bai` by default."""
    from graphtyper_tpu_torch.io.bgzf import decompress_all

    data = decompress_all(bam_path)
    if data[:4] != b"BAM\x01":
        raise ValueError(f"not a BAM: {bam_path}")
    coffsets, usizes = bgzf_block_table(bam_path)
    ustarts = [0]
    for u in usizes:
        ustarts.append(ustarts[-1] + u)
    with open(bam_path, "rb") as f:
        f.seek(0, 2)
        csize = f.tell()

    from bisect import bisect_right

    def voff(u: int) -> int:
        b = bisect_right(ustarts, u) - 1
        if b >= len(coffsets):
            return csize << 16
        return (coffsets[b] << 16) | (u - ustarts[b])

    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4 + l_name + 4

    bins: list[dict[int, list[tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    linear: list[list[int]] = [[] for _ in range(n_ref)]
    n_no_coor = 0
    n = len(data)

    scan = _scan_records_native(data, off)
    if scan is not None:
        import numpy as np

        rec_off, tids, poss, ref_ends = scan
        n_rec = len(rec_off)
        if n_rec:
            rec_end_off = np.empty(n_rec, dtype=np.int64)
            rec_end_off[:-1] = rec_off[1:]
            rec_end_off[-1] = rec_off[-1] + 4 + int(
                struct.unpack_from("<i", data, int(rec_off[-1]))[0]
            )
            mapped = (tids >= 0) & (poss >= 0)
            n_no_coor = int((~mapped).sum())
            # vectorized voffsets
            co = np.asarray(coffsets, dtype=np.int64)
            us = np.asarray(ustarts[:-1], dtype=np.int64)
            bi = np.searchsorted(ustarts, rec_off, side="right") - 1
            v0s = np.where(bi < len(co), (co[np.minimum(bi, len(co) - 1)] << 16)
                           | (rec_off - us[np.minimum(bi, len(us) - 1)]), csize << 16)
            bi1 = np.searchsorted(ustarts, rec_end_off, side="right") - 1
            v1s = np.where(bi1 < len(co), (co[np.minimum(bi1, len(co) - 1)] << 16)
                           | (rec_end_off - us[np.minimum(bi1, len(us) - 1)]), csize << 16)
            # vectorized reg2bin
            beg = poss.astype(np.int64)
            endm1 = ref_ends.astype(np.int64) - 1
            bnum = np.zeros(n_rec, dtype=np.int64)
            for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
                hit = (bnum == 0) & ((beg >> shift) == (endm1 >> shift))
                bnum = np.where(hit, base + (beg >> shift), bnum)
            # chunks: runs of identical (tid, bin) in file order coalesce
            # (consecutive records are voffset-contiguous by construction)
            idx = np.flatnonzero(mapped)
            if len(idx):
                t_m, b_m = tids[idx].astype(np.int64), bnum[idx]
                breaks = np.flatnonzero((t_m[1:] != t_m[:-1]) | (b_m[1:] != b_m[:-1])) + 1
                starts = np.concatenate([[0], breaks])
                ends = np.concatenate([breaks, [len(idx)]])
                for s, e in zip(starts, ends):
                    tid_r = int(t_m[s])
                    bins[tid_r].setdefault(int(b_m[s]), []).append(
                        (int(v0s[idx[s]]), int(v1s[idx[e - 1]]))
                    )
                # linear index: reads span < 16kb, so at most 2 windows each
                for tid_r in np.unique(t_m):
                    sel = idx[t_m == tid_r]
                    w0 = (poss[sel].astype(np.int64)) >> LEAF_SHIFT
                    w1 = (ref_ends[sel].astype(np.int64) - 1) >> LEAF_SHIFT
                    n_w = int(w1.max()) + 1
                    lin = np.full(n_w, np.iinfo(np.int64).max, dtype=np.int64)
                    np.minimum.at(lin, w0, v0s[sel])
                    np.minimum.at(lin, w1, v0s[sel])
                    lin[lin == np.iinfo(np.int64).max] = 0
                    linear[int(tid_r)] = lin.tolist()
    else:
        while off + 4 <= n:
            (block_size,) = struct.unpack_from("<i", data, off)
            rec_beg, rec_end = off, off + 4 + block_size
            if rec_end > n:
                break
            tid, pos = struct.unpack_from("<ii", data, off + 4)
            n_cigar = struct.unpack_from("<H", data, off + 16)[0]
            l_read_name = data[off + 12]
            if tid < 0 or pos < 0:
                n_no_coor += 1
                off = rec_end
                continue
            span = 0
            cig_off = off + 36 + l_read_name
            for k in range(n_cigar):
                (c,) = struct.unpack_from("<I", data, cig_off + 4 * k)
                if (c & 0xF) in _REF_CONSUME:
                    span += c >> 4
            end = pos + max(span, 1)
            b = reg2bin(pos, end)
            v0, v1 = voff(rec_beg), voff(rec_end)
            chunks = bins[tid].setdefault(b, [])
            if chunks and chunks[-1][1] == v0:
                chunks[-1] = (chunks[-1][0], v1)  # coalesce adjacent records
            else:
                chunks.append((v0, v1))
            lin = linear[tid]
            for w in range(pos >> LEAF_SHIFT, ((end - 1) >> LEAF_SHIFT) + 1):
                while len(lin) <= w:
                    lin.append(0)
                if lin[w] == 0 or v0 < lin[w]:
                    lin[w] = v0
            off = rec_end

    # fill linear-index holes with the next known offset (htslib behavior)
    for lin in linear:
        nxt = 0
        for w in range(len(lin) - 1, -1, -1):
            if lin[w] == 0:
                lin[w] = nxt
            else:
                nxt = lin[w]

    if bai_path is None:
        bai_path = bam_path + ".bai"
    out = bytearray(BAI_MAGIC)
    out += struct.pack("<i", n_ref)
    for tid in range(n_ref):
        out += struct.pack("<i", len(bins[tid]))
        for b in sorted(bins[tid]):
            chunks = bins[tid][b]
            out += struct.pack("<Ii", b, len(chunks))
            for v0, v1 in chunks:
                out += struct.pack("<QQ", v0, v1)
        out += struct.pack("<i", len(linear[tid]))
        for v in linear[tid]:
            out += struct.pack("<Q", v)
    out += struct.pack("<Q", n_no_coor)
    with open(bai_path, "wb") as f:
        f.write(bytes(out))
    return bai_path


def ensure_bai(bam_path: str, min_size: int = 1 << 20) -> bool:
    """Build `<bam>.bai` if missing/stale (atomic via temp + rename, so
    concurrent region workers can race harmlessly). Returns True when a
    fresh index exists afterwards. Failures (read-only dir, non-BAM) are
    swallowed — consumers fall back to full-file scans."""
    if not bam_path.endswith(".bam"):
        return False
    bai_path = bam_path + ".bai"
    try:
        if os.path.getsize(bam_path) < min_size:
            return False
        if os.path.exists(bai_path) and os.path.getmtime(bai_path) >= os.path.getmtime(bam_path):
            return True
        tmp = f"{bai_path}.{os.getpid()}.tmp"
        build_bai(bam_path, tmp)
        os.replace(tmp, bai_path)
        return True
    except Exception:
        return False


def read_bai(path: str) -> Bai:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError(f"not a BAI: {path}")
    (n_ref,) = struct.unpack_from("<i", data, 4)
    off = 8
    bins: list[dict[int, list[tuple[int, int]]]] = []
    linear: list[list[int]] = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bd: dict[int, list[tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                v0, v1 = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((v0, v1))
            bd[b] = chunks
        bins.append(bd)
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off)) if n_intv else []
        off += 8 * n_intv
        linear.append(lin)
    n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
    return Bai(bins, linear, n_no_coor)


def region_chunks(bai: Bai, tid: int, beg: int, end: int) -> list[tuple[int, int]]:
    """Merged, sorted chunk list possibly containing records overlapping
    [beg, end), pruned by the linear index like htslib."""
    if tid < 0 or tid >= len(bai.bins):
        return []
    lin = bai.linear[tid]
    w = beg >> LEAF_SHIFT
    min_off = lin[w] if w < len(lin) else (lin[-1] if lin else 0)
    raw = []
    refbins = bai.bins[tid]
    for b in reg2bins(beg, end):
        for v0, v1 in refbins.get(b, ()):
            if v1 > min_off:
                raw.append((max(v0, min_off), v1))
    raw.sort()
    merged: list[tuple[int, int]] = []
    for v0, v1 in raw:
        if merged and v0 <= merged[-1][1]:
            if v1 > merged[-1][1]:
                merged[-1] = (merged[-1][0], v1)
        else:
            merged.append((v0, v1))
    return merged


def read_region_bam_bytes(
    bam_path: str, intervals: list[tuple[str, int, int]], bai_path: str | None = None
) -> bytes | None:
    """Uncompressed BAM bytes (header + the records of every BGZF chunk
    overlapping any interval, coalesced and deduplicated) — a drop-in,
    smaller replacement for decompress_all() feeding the native runtimes.
    Returns None when no usable index exists. Chunks start at record
    boundaries per the BAI spec, so the result parses as a normal BAM whose
    record set is a superset of the intervals' overlaps (consumers filter by
    position exactly as they do on the full file)."""
    if bai_path is None:
        bai_path = bam_path + ".bai"
    if not os.path.exists(bai_path):
        return None
    if os.path.getmtime(bai_path) < os.path.getmtime(bam_path):
        return None  # stale index
    from graphtyper_tpu_torch.io.bgzf import BgzfReader

    bai = read_bai(bai_path)
    with BgzfReader(bam_path) as r:
        # header: magic + text + ref dictionary (record section starts after)
        hdr = r.read(8)
        if hdr[:4] != b"BAM\x01":
            return None
        (l_text,) = struct.unpack_from("<i", hdr, 4)
        hdr += r.read(l_text + 4)
        (n_ref,) = struct.unpack_from("<i", hdr, 8 + l_text)
        name2id: dict[str, int] = {}
        for i in range(n_ref):
            b = r.read(4)
            (l_name,) = struct.unpack_from("<i", b, 0)
            nb = r.read(l_name + 4)
            name2id[nb[: l_name - 1].decode()] = i
            hdr += b + nb

        chunks: list[tuple[int, int]] = []
        for chrom, beg, end in intervals:
            tid = name2id.get(chrom)
            if tid is None:
                continue
            chunks.extend(region_chunks(bai, tid, max(0, beg), end))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for v0, v1 in chunks:
            if merged and v0 <= merged[-1][1]:
                if v1 > merged[-1][1]:
                    merged[-1] = (merged[-1][0], v1)
            else:
                merged.append((v0, v1))
        body = _extract_ranges_native(bam_path, merged)
        if body is None:
            # Python fallback (and the differential oracle,
            # tests/io/test_bai_ranges.py)
            body = bytearray()
            for v0, v1 in merged:
                r.seek_virtual(v0)
                body += r.read_until_voffset(v1)
    return bytes(hdr) + bytes(body)


def _extract_ranges_native(path: str, merged: list[tuple[int, int]]) -> bytes | None:
    """Decompress the records covered by merged virtual-offset ranges through
    the threaded native BGZF inflater: one contiguous compressed span read +
    one multi-threaded inflate per range, sliced at the within-block offsets
    (the partial last block's cut point comes from its ISIZE trailer)."""
    from graphtyper_tpu_torch.io.native import bgzf_decompress

    if os.environ.get("GT_BAI_RANGES") == "off":
        return None
    out = bytearray()
    try:
        with open(path, "rb") as f:
            for v0, v1 in merged:
                c0, w0 = v0 >> 16, v0 & 0xFFFF
                c1, w1 = v1 >> 16, v1 & 0xFFFF
                if w1 > 0:
                    f.seek(c1 + 16)
                    bs = f.read(2)
                    if len(bs) < 2:
                        return None
                    span_end = c1 + int.from_bytes(bs, "little") + 1
                    f.seek(span_end - 4)
                    isize = int.from_bytes(f.read(4), "little")
                else:
                    span_end = c1
                    isize = 0
                if span_end <= c0:
                    continue
                f.seek(c0)
                span = f.read(span_end - c0)
                if len(span) != span_end - c0:
                    return None
                dec = bgzf_decompress(span)
                if dec is None:
                    return None
                end_cut = len(dec) - isize + w1 if w1 > 0 else len(dec)
                out += dec[w0:end_cut]
    except OSError:
        return None
    return bytes(out)
