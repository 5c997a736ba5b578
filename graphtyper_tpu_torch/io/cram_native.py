"""Marshaling for the native CRAM slice decoder (native/gt_cram.cpp).

The native path covers the codec subset production files use (EXTERNAL
ITF8/raw, constant HUFFMAN, BYTE_ARRAY_STOP, BYTE_ARRAY_LEN with
EXTERNAL/constant length and EXTERNAL values). Any other codec — or any
stream irregularity the C++ detects — returns None and the caller uses the
Python decoder, which remains the parity oracle
(tests/io/test_cram_native.py)."""

from __future__ import annotations

import ctypes

import numpy as np

from graphtyper_tpu_torch.io.native import get_lib

SERIES = [
    "BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "NF", "TL",
    "FN", "FC", "FP", "DL", "BA", "BS", "QS", "MQ", "RS", "PD", "HC",
    "RN", "IN", "SC", "BB", "QQ",
]


def _setup(lib) -> None:
    if getattr(lib, "_cram_ready", False):
        return
    slice_args = (
        [ctypes.c_void_p] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2  # descs/tags
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64]  # ext blocks
        + [ctypes.c_int64] * 3 + [ctypes.c_int32] * 2 + [ctypes.c_int64]  # slice meta
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]  # ref + subs
    )
    lib.gt_cram_decode_slice.restype = ctypes.c_void_p
    lib.gt_cram_decode_slice.argtypes = slice_args + [ctypes.POINTER(ctypes.c_int64)] * 7
    lib.gt_cram_fetch.restype = ctypes.c_int32
    lib.gt_cram_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 19
    lib.gt_cram_free.restype = None
    lib.gt_cram_free.argtypes = [ctypes.c_void_p]
    lib.gt_cram_slice_to_bam.restype = ctypes.c_void_p
    lib.gt_cram_slice_to_bam.argtypes = slice_args + [ctypes.POINTER(ctypes.c_int64)]
    lib.gt_cram_bam_fetch.restype = ctypes.c_int32
    lib.gt_cram_bam_fetch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gt_cram_bam_free.restype = None
    lib.gt_cram_bam_free.argtypes = [ctypes.c_void_p]
    lib._cram_ready = True


def _desc_of(codec, cid_idx: dict) -> tuple[int, int, int, int] | None:
    from graphtyper_tpu_torch.io.cram import (
        ByteArrayLenCodec,
        ByteArrayStopCodec,
        ExternalCodec,
        HuffmanCodec,
    )

    def idx(cid: int) -> int:
        return cid_idx.setdefault(cid, len(cid_idx))

    if isinstance(codec, ExternalCodec):
        return (1, idx(codec._cid), 0, 0)
    if isinstance(codec, HuffmanCodec) and codec.constant is not None:
        return (2, int(codec.constant), 0, 0)
    if isinstance(codec, ByteArrayStopCodec):
        return (3, int(codec.stop), idx(codec._cid), 0)
    if isinstance(codec, ByteArrayLenCodec):
        ld = _desc_of(codec.len_codec, cid_idx)
        if ld is None or ld[0] not in (1, 2):
            return None
        if not isinstance(codec.val_codec, ExternalCodec):
            return None
        return (4, ld[0], ld[1], idx(codec.val_codec._cid))
    return None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _marshal(ch, ext: dict):
    """Pack the slice's codec table / tag table / ext blocks / substitution
    matrix into the flat layout gt_cram.cpp consumes. Returns None when any
    codec falls outside the supported subset."""
    cid_idx: dict[int, int] = {}
    built = {k: v.build(ext, 3) for k, v in ch.data_series.items()}
    ds = np.zeros((len(SERIES), 4), dtype=np.int64)
    for i, key in enumerate(SERIES):
        codec = built.get(key)
        if codec is None:
            continue
        d = _desc_of(codec, cid_idx)
        if d is None:
            return None
        ds[i] = d

    # global tag table: ordered list of (tag, ttype, desc)
    tag_keys: list[tuple[str, str]] = []
    tag_pos: dict[int, int] = {}
    tag_desc_rows: list[tuple[int, int, int, int]] = []
    for key, enc in ch.tag_encodings.items():
        codec = enc.build(ext, 3)
        d = _desc_of(codec, cid_idx)
        if d is None:
            return None
        tag_pos[key] = len(tag_keys)
        tag_keys.append((chr((key >> 16) & 0xFF) + chr((key >> 8) & 0xFF), chr(key & 0xFF)))
        tag_desc_rows.append(d)
    n_tags = len(tag_keys)
    tag_desc = np.array(tag_desc_rows, dtype=np.int64).reshape(n_tags, 4) if n_tags else np.zeros((0, 4), np.int64)
    keys3 = np.zeros(n_tags * 3, dtype=np.uint8)
    for i, (tag, ttype) in enumerate(tag_keys):
        keys3[i * 3] = ord(tag[0])
        keys3[i * 3 + 1] = ord(tag[1])
        keys3[i * 3 + 2] = ord(ttype)

    # TL -> tag index lists
    tl_tags_l: list[int] = []
    tl_off = np.zeros(len(ch.tag_dict) + 1, dtype=np.int64)
    for tl, entries in enumerate(ch.tag_dict):
        for tag, ttype in entries:
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(ttype)
            gi = tag_pos.get(key)
            if gi is None:
                return None  # tag dict references an undeclared encoding
            tl_tags_l.append(gi)
        tl_off[tl + 1] = len(tl_tags_l)
    tl_tags = np.array(tl_tags_l, dtype=np.int32)

    # ext blocks CSR, in cid_idx order (absent blocks become empty streams —
    # reads from them error out in C++ and trigger the Python fallback)
    bufs = []
    for cid, i in sorted(cid_idx.items(), key=lambda kv: kv[1]):
        br = ext.get(cid)
        bufs.append(bytes(br.data[br.pos :]) if br is not None else b"")
    ext_off = np.zeros(len(bufs), dtype=np.int64)
    ext_len = np.array([len(b) for b in bufs], dtype=np.int64)
    if len(bufs) > 1:
        np.cumsum(ext_len[:-1], out=ext_off[1:])
    ext_buf = np.frombuffer(b"".join(bufs), dtype=np.uint8) if bufs else np.zeros(0, np.uint8)

    from graphtyper_tpu_torch.io.cram import _SUB_BASES, _build_sub_matrix

    subs_map = _build_sub_matrix(ch.substitution_matrix)
    subs = np.zeros(20, dtype=np.uint8)
    for i, rb in enumerate(_SUB_BASES):
        subs[i * 4 : (i + 1) * 4] = np.frombuffer(subs_map[rb], dtype=np.uint8)

    return ds, tag_desc, keys3, tag_keys, tl_off, tl_tags, ext_buf, ext_off, ext_len, len(bufs), subs


def decode_slice_native(ch, sh, ext: dict, counter: int, ref: bytes):
    """Native decode of one slice -> list[AlignedRead], or None to fall
    back (unsupported codec / C++ bailed)."""
    lib = get_lib()
    _setup(lib)
    m = _marshal(ch, ext)
    if m is None:
        return None
    ds, tag_desc, keys3, tag_keys, tl_off, tl_tags, ext_buf, ext_off, ext_len, n_bufs, subs = m
    n_tags = len(tag_keys)
    ref_arr = np.frombuffer(ref, dtype=np.uint8) if ref else np.zeros(0, np.uint8)
    ptr = _ptr

    o = [ctypes.c_int64() for _ in range(7)]
    handle = lib.gt_cram_decode_slice(
        ptr(np.ascontiguousarray(ds)), ptr(np.ascontiguousarray(tag_desc)),
        ptr(keys3), ptr(tl_off), ptr(tl_tags),
        len(ch.tag_dict), n_tags,
        ptr(ext_buf), ptr(ext_off), ptr(ext_len), n_bufs,
        sh.n_records, sh.ref_id, sh.start,
        1 if ch.ap_delta else 0, 1 if ch.preserve_read_names else 0, counter,
        ptr(ref_arr), len(ref_arr), ptr(subs),
        *[ctypes.byref(x) for x in o],
    )
    if not handle:
        return None
    n, n_names, n_seq, n_qual, n_cig, n_ts, n_blob = (x.value for x in o)
    bf = np.zeros(n, np.int64)
    ref_id = np.zeros(n, np.int64)
    pos = np.zeros(n, np.int64)
    mapq = np.zeros(n, np.int64)
    mrid = np.zeros(n, np.int64)
    mpos = np.zeros(n, np.int64)
    tlen = np.zeros(n, np.int64)
    names = np.zeros(n_names, np.uint8)
    name_off = np.zeros(n + 1, np.int64)
    seqs = np.zeros(n_seq, np.uint8)
    seq_off = np.zeros(n + 1, np.int64)
    quals = np.zeros(n_qual, np.uint8)
    qual_off = np.zeros(n + 1, np.int64)
    cig = np.zeros(n_cig, np.uint32)
    cig_off = np.zeros(n + 1, np.int64)
    tag_idx = np.zeros(n_ts, np.int32)
    tag_cnt = np.zeros(n, np.int64)
    blobs = np.zeros(n_blob, np.uint8)
    blob_off = np.zeros(n_ts + 1, np.int64)
    try:
        rc = lib.gt_cram_fetch(
            handle, ptr(bf), ptr(ref_id), ptr(pos), ptr(mapq), ptr(mrid), ptr(mpos), ptr(tlen),
            ptr(names), ptr(name_off), ptr(seqs), ptr(seq_off), ptr(quals), ptr(qual_off),
            ptr(cig), ptr(cig_off), ptr(tag_idx), ptr(tag_cnt), ptr(blobs), ptr(blob_off),
        )
        if rc != 0:
            return None
    finally:
        lib.gt_cram_free(handle)

    from graphtyper_tpu_torch.io.bam import AlignedRead
    from graphtyper_tpu_torch.io.cram import _TagValueReader

    readers = [_TagValueReader(t[1]) for t in tag_keys]
    tag_names = [t[0] for t in tag_keys]
    names_b = names.tobytes()
    seqs_b = seqs.tobytes()
    blobs_b = blobs.tobytes()
    name_off_l = name_off.tolist()
    seq_off_l = seq_off.tolist()
    qual_off_l = qual_off.tolist()
    cig_off_l = cig_off.tolist()
    tag_cnt_l = tag_cnt.tolist()
    blob_off_l = blob_off.tolist()
    bf_l = bf.tolist()
    pos_l = pos.tolist()
    rid_l = ref_id.tolist()
    mapq_l = mapq.tolist()
    mrid_l = mrid.tolist()
    mpos_l = mpos.tolist()
    tlen_l = tlen.tolist()
    cig_l = cig.tolist()
    tag_idx_l = tag_idx.tolist()

    reads: list[AlignedRead] = []
    ap = reads.append
    ti = 0
    for i in range(n):
        tags = {}
        for _ in range(tag_cnt_l[i]):
            gi = tag_idx_l[ti]
            tags[tag_names[gi]] = readers[gi].read(blobs_b[blob_off_l[ti] : blob_off_l[ti + 1]])
            ti += 1
        cigar = [(v & 0xF, v >> 4) for v in cig_l[cig_off_l[i] : cig_off_l[i + 1]]]
        ap(AlignedRead(
            name=names_b[name_off_l[i] : name_off_l[i + 1]].decode("latin1"),
            flag=bf_l[i],
            ref_id=rid_l[i],
            pos=pos_l[i] - 1,
            mapq=mapq_l[i],
            cigar=cigar,
            mate_ref_id=mrid_l[i],
            mate_pos=mpos_l[i] - 1,
            tlen=tlen_l[i],
            seq=seqs_b[seq_off_l[i] : seq_off_l[i + 1]],
            qual=quals[qual_off_l[i] : qual_off_l[i + 1]],
            tags=tags,
        ))
    return reads


def slice_to_bam_native(ch, sh, ext: dict, counter: int, ref: bytes) -> bytes | None:
    """Native decode of one slice straight to concatenated BAM record bytes
    (io/bam_writer.py conventions, full tag-type fidelity), or None to fall
    back."""
    lib = get_lib()
    _setup(lib)
    m = _marshal(ch, ext)
    if m is None:
        return None
    ds, tag_desc, keys3, tag_keys, tl_off, tl_tags, ext_buf, ext_off, ext_len, n_bufs, subs = m
    ref_arr = np.frombuffer(ref, dtype=np.uint8) if ref else np.zeros(0, np.uint8)
    ptr = _ptr
    size = ctypes.c_int64()
    handle = lib.gt_cram_slice_to_bam(
        ptr(np.ascontiguousarray(ds)), ptr(np.ascontiguousarray(tag_desc)),
        ptr(keys3), ptr(tl_off), ptr(tl_tags),
        len(ch.tag_dict), len(tag_keys),
        ptr(ext_buf), ptr(ext_off), ptr(ext_len), n_bufs,
        sh.n_records, sh.ref_id, sh.start,
        1 if ch.ap_delta else 0, 1 if ch.preserve_read_names else 0, counter,
        ptr(ref_arr), len(ref_arr), ptr(subs),
        ctypes.byref(size),
    )
    if not handle:
        return None
    out = np.zeros(size.value, dtype=np.uint8)
    try:
        lib.gt_cram_bam_fetch(handle, ptr(out))
    finally:
        lib.gt_cram_bam_free(handle)
    return out.tobytes()


def cram_to_bam_bytes(
    path: str,
    region: tuple[str, int, int] | None = None,
    ref_path: str | None = None,
) -> bytes | None:
    """Decode a whole CRAM file (optionally container-filtered to a region)
    into decompressed-BAM bytes (header + records) entirely natively — the
    bridge that lets CRAM inputs ride the native bamshrink and pooled-caller
    BAM paths with no Python record objects. Returns None to fall back
    (unsupported codec anywhere, multi-ref slices, or a
    reference-based slice whose MD5 cannot be satisfied by `ref_path` — the
    object path then reports the missing reference properly instead of
    silently decoding against Ns)."""
    import hashlib
    import struct

    from graphtyper_tpu_torch.io.cram import CramFile

    cf = CramFile(path, ref_path)
    rid_region = None
    if region is not None:
        chrom, beg, end = region
        try:
            rid = cf.header.ref_names.index(chrom)
        except ValueError:
            rid = -9
        rid_region = (rid, max(0, beg), end)

    from graphtyper_tpu_torch.io.cram import finish_slice_blocks

    # materialize slices raw (cheap byte walks), prefetch references
    # serially (the ref cache is not thread-safe to fill), then decompress +
    # decode each slice concurrently — the rANS and record loops run in
    # native code that releases the GIL
    items = []
    for ch, sh, raws, counter, ref_getter in cf._iter_slices_raw(rid_region):
        if sh.ref_id == -2:
            return None  # multi-ref slices need per-record references
        ref = ref_getter(sh.ref_id) if sh.ref_id >= 0 else b""
        # reference-based slice: the fragment MD5 must verify
        md5 = getattr(sh, "ref_md5", None)
        if md5 is not None and md5 != b"\x00" * 16:
            frag = ref[max(0, sh.start - 1) : max(0, sh.start - 1) + sh.span]
            if hashlib.md5(frag).digest() != md5:
                return None
        items.append((ch, sh, raws, counter, ref))

    def _one(item):
        ch, sh, raws, counter, ref = item
        _core, ext = finish_slice_blocks(raws)
        return slice_to_bam_native(ch, sh, ext, counter, ref)

    if len(items) >= 2:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, len(items))) as ex:
            parts = list(ex.map(_one, items))
    else:
        parts = [_one(it) for it in items]
    if any(p is None for p in parts):
        return None

    text = cf.header.text or "@HD\tVN:1.6\tSO:coordinate\n"
    if not text.endswith("\n"):
        text += "\n"  # io/bam_writer.py:74-76 convention
    text = text.encode()
    hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text
    hdr += struct.pack("<i", len(cf.header.ref_names))
    for name, ln in zip(cf.header.ref_names, cf.header.ref_lengths):
        nb = name.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return hdr + b"".join(parts)
