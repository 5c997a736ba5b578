"""CRAM 3.0 writer.

Writes AlignedRead records as spec-conformant CRAM 3.0: one slice per
container, reference-less encoding (bases stored verbatim through 'b'/'S'
features, so no external FASTA is needed at read time), EXTERNAL/
BYTE_ARRAY_STOP codecs, and rANS-4x8 order-0 compression on the sequence
and quality blocks (gzip elsewhere) — exercising the full 3.0 read path of
io/cram.py, which has no htslib-era fixture. Round-trip equality is
asserted by tests/io/test_cram.py.
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

from graphtyper_tpu_torch.io.bam import AlignedRead, BamHeader
from graphtyper_tpu_torch.io.cram import (
    CF_DETACHED,
    CF_QUAL_STORED,
    COMPRESSION_HEADER,
    CORE_DATA,
    EXTERNAL_DATA,
    FILE_HEADER,
    GZIP,
    MAPPED_SLICE,
    RANS,
    RAW,
    TF_SHIFT,
    TOTFREQ,
    RANS_L,
)


def itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF, (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    out = []
    n = 0
    x = v
    while True:
        n += 1
        if v < (1 << (7 * (n + 1) - n)) and n < 8:
            # n continuation bytes; leading byte has n ones then data bits
            lead_bits = 7 - n
            body = v
            parts = []
            for _ in range(n):
                parts.append(body & 0xFF)
                body >>= 8
            lead = ((0xFF << (8 - n)) & 0xFF) | (body & ((1 << lead_bits) - 1))
            return bytes([lead] + parts[::-1])
        if n >= 8:
            parts = []
            body = v
            for _ in range(8):
                parts.append(body & 0xFF)
                body >>= 8
            return bytes([0xFF] + parts[::-1])


# ---------------------------------------------------------------------------
# rANS 4x8 order-0 encoder
# ---------------------------------------------------------------------------


def rans_encode_0(data: bytes) -> bytes:
    if len(data) == 0:
        data = b"\x00"
    arr = np.frombuffer(data, dtype=np.uint8)
    counts = np.bincount(arr, minlength=256).astype(np.int64)
    # normalize to TOTFREQ, every present symbol keeps freq >= 1
    total = counts.sum()
    freqs = np.maximum((counts * TOTFREQ) // max(total, 1), (counts > 0).astype(np.int64))
    # adjust to exact TOTFREQ sum
    diff = TOTFREQ - freqs.sum()
    big = int(np.argmax(freqs))
    freqs[big] += diff
    if freqs[big] <= 0:
        raise ValueError("rans normalization failed")
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])

    # frequency table serialization: htslib rANS_static.c symbol-RLE layout
    table = bytearray()
    rle = 0
    for j in range(256):
        if not freqs[j]:
            continue
        if rle:
            rle -= 1
        else:
            table.append(j)
            if j > 0 and freqs[j - 1] > 0:
                run = 0
                k = j + 1
                while k < 256 and freqs[k] > 0:
                    run += 1
                    k += 1
                rle = run
                table.append(run)
        f = int(freqs[j])
        if f < 128:
            table.append(f)
        else:
            table.append(128 | (f >> 8))
            table.append(f & 0xFF)
    table.append(0)

    # encode in reverse, 4 interleaved states
    states = [RANS_L] * 4
    out_rev = bytearray()
    for i in range(len(arr) - 1, -1, -1):
        j = i & 3
        s = int(arr[i])
        f = int(freqs[s])
        x = states[j]
        x_max = ((RANS_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + int(cum[s])
    body = bytearray()
    for j in range(4):
        body += struct.pack("<I", states[j])
    body += bytes(out_rev[::-1])
    payload = bytes(table) + bytes(body)
    return bytes([0]) + struct.pack("<I", len(payload)) + struct.pack("<I", len(data)) + payload


def _norm_freqs(counts: np.ndarray) -> np.ndarray:
    """Quantize counts to sum TOTFREQ with every present symbol >= 1."""
    total = int(counts.sum())
    freqs = np.maximum((counts * TOTFREQ) // max(total, 1), (counts > 0).astype(np.int64))
    diff = TOTFREQ - int(freqs.sum())
    big = int(np.argmax(freqs))
    freqs[big] += diff
    if freqs[big] <= 0:
        raise ValueError("rans normalization failed")
    return freqs


def _rle_table(used_freqs: np.ndarray, emit_inner) -> bytearray:
    """htslib rANS_static symbol-RLE walk: for each present index j emit the
    index (with run-length compression of consecutive indices) then
    emit_inner(j) for the payload; terminated by 0."""
    table = bytearray()
    rle = 0
    for j in range(256):
        if not used_freqs[j]:
            continue
        if rle:
            rle -= 1
        else:
            table.append(j)
            if j > 0 and used_freqs[j - 1]:
                run = 0
                k = j + 1
                while k < 256 and used_freqs[k]:
                    run += 1
                    k += 1
                rle = run
                table.append(run)
        emit_inner(table, j)
    table.append(0)
    return table


def rans_encode_1(data: bytes) -> bytes:
    """rANS 4x8 order-1 (context = previous symbol per interleaved stream) —
    the inverse of io/cram.py:_rans_decode_1. Stream j encodes the j-th
    quarter of the output; the tail rides stream 3; renormalization bytes are
    pushed in the exact reverse of the decoder's consumption order."""
    if len(data) == 0:
        data = b"\x00"
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    q = n >> 2
    starts = [0, q, 2 * q, 3 * q]

    # context-conditional counts: ctx of stream-start positions is 0
    counts = np.zeros((256, 256), dtype=np.int64)
    ctx_prev = np.empty(n, dtype=np.uint8)
    ctx_prev[1:] = arr[:-1]
    for j in range(4):
        ctx_prev[starts[j]] = 0
    np.add.at(counts, (ctx_prev, arr), 1)
    freqs = np.zeros((256, 256), dtype=np.int64)
    cum = np.zeros((256, 257), dtype=np.int64)
    used_ctx = counts.sum(axis=1) > 0
    for c in np.nonzero(used_ctx)[0]:
        freqs[c] = _norm_freqs(counts[c])
        np.cumsum(freqs[c], out=cum[c, 1:])

    # table: context-level RLE wrapping an inner order-0-style table each
    def emit_ctx(table: bytearray, c: int) -> None:
        def emit_freq(tb: bytearray, s: int) -> None:
            f = int(freqs[c, s])
            if f < 128:
                tb.append(f)
            else:
                tb.append(128 | (f >> 8))
                tb.append(f & 0xFF)

        table += _rle_table(freqs[c], emit_freq)

    table = _rle_table(used_ctx.astype(np.int64), emit_ctx)

    # ops in decode order, then encode in reverse
    ops: list[int] = []  # positions; stream = derived
    op_stream: list[int] = []
    for k in range(q):
        for j in range(4):
            ops.append(starts[j] + k)
            op_stream.append(j)
    for p in range(4 * q, n):
        ops.append(p)
        op_stream.append(3)

    states = [RANS_L] * 4
    out_rev = bytearray()
    for oi in range(len(ops) - 1, -1, -1):
        p = ops[oi]
        j = op_stream[oi]
        s = int(arr[p])
        c = int(ctx_prev[p])
        f = int(freqs[c, s])
        x = states[j]
        x_max = ((RANS_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + int(cum[c, s])

    body = bytearray()
    for j in range(4):
        body += struct.pack("<I", states[j])
    body += bytes(out_rev[::-1])
    payload = bytes(table) + bytes(body)
    return bytes([1]) + struct.pack("<I", len(payload)) + struct.pack("<I", len(data)) + payload


# ---------------------------------------------------------------------------
# block / container serialization
# ---------------------------------------------------------------------------


def _block(method: int, content_type: int, content_id: int, data: bytes) -> bytes:
    if method == GZIP:
        payload = gzip.compress(data, mtime=0)  # deterministic output bytes
    elif method == RANS:
        # order-1 wins on context-heavy streams (quality ramps) exactly as
        # htslib chooses for QS; keep whichever is smaller
        payload = rans_encode_0(data)
        if len(data) > 4096:
            p1 = rans_encode_1(data)
            if len(p1) < len(payload):
                payload = p1
    else:
        payload = data
    out = bytearray()
    out.append(method)
    out.append(content_type)
    out += itf8(content_id)
    out += itf8(len(payload))
    out += itf8(len(data))
    out += payload
    out += struct.pack("<I", zlib.crc32(bytes(out)))
    return bytes(out)


def _container(ref_id, start, span, n_records, record_counter, n_bases, blocks: list[bytes], landmarks: list[int]) -> bytes:
    payload = b"".join(blocks)
    hdr = bytearray()
    hdr += struct.pack("<i", len(payload))
    hdr += itf8(ref_id)
    hdr += itf8(start)
    hdr += itf8(span)
    hdr += itf8(n_records)
    hdr += ltf8(record_counter)
    hdr += ltf8(n_bases)
    hdr += itf8(len(blocks))
    hdr += itf8(len(landmarks))
    for lm in landmarks:
        hdr += itf8(lm)
    hdr += struct.pack("<I", zlib.crc32(bytes(hdr)))
    return bytes(hdr) + payload


def _ext_encoding(cid: int) -> bytes:
    params = itf8(cid)
    return itf8(1) + itf8(len(params)) + params


def _bas_encoding(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + itf8(cid)
    return itf8(5) + itf8(len(params)) + params


# external block content ids
CID = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "RN": 7, "MF": 8,
    "NS": 9, "NP": 10, "TS": 11, "TL": 12, "FN": 13, "FC": 14, "FP": 15,
    "DL": 16, "BB": 17, "SC": 18, "MQ": 19, "QS": 20, "BA": 21, "HC": 22,
    "PD": 23, "RS": 24, "IN": 25, "TAGS": 30,
}


def write_cram(path: str, header: BamHeader, reads: list[AlignedRead]) -> None:
    out = bytearray()
    out += b"CRAM" + bytes([3, 0]) + b"graphtyper_tpu_cram\x00"

    # file header container
    text = header.text if header.text.endswith("\n") or not header.text else header.text + "\n"
    hdr_data = struct.pack("<i", len(text)) + text.encode()
    hb = _block(RAW, FILE_HEADER, 0, hdr_data)
    out += _container(-1, 0, 0, 0, 0, 0, [hb], [0])

    # data containers: one slice each, 10000 records max
    CHUNK = 10000
    counter = 0
    for lo in range(0, len(reads), CHUNK):
        chunk = reads[lo : lo + CHUNK]
        out += _data_container(header, chunk, counter)
        counter += len(chunk)

    # EOF container (spec 9: special empty container)
    eof_block = _block(RAW, COMPRESSION_HEADER, 0, itf8(0) + itf8(0) + itf8(0) + itf8(0) + itf8(0) + itf8(0))
    out += _container(-1, 4542278, 0, 0, 0, 0, [eof_block], [0])

    with open(path, "wb") as f:
        f.write(out)


def _tag_blob(val) -> tuple[str, bytes]:
    if isinstance(val, int):
        return "i", struct.pack("<i", val)
    if isinstance(val, float):
        return "f", struct.pack("<f", val)
    if isinstance(val, str):
        return "Z", val.encode() + b"\x00"
    if isinstance(val, list):
        arr = np.asarray(val, dtype=np.int32)
        return "B", b"i" + struct.pack("<I", len(arr)) + arr.tobytes()
    raise ValueError(f"unsupported tag value {val!r}")


def _data_container(header: BamHeader, reads: list[AlignedRead], counter: int) -> bytes:
    streams: dict[str, bytearray] = {k: bytearray() for k in CID}
    tag_lines: list[tuple] = []
    tag_line_of: dict[tuple, int] = {}

    def put_int(key: str, v: int):
        streams[key] += itf8(v)

    multi_ref = len({r.ref_id for r in reads}) > 1
    ref_id = reads[0].ref_id if reads and not multi_ref else (-2 if multi_ref else -1)
    start = min((r.pos + 1 for r in reads if r.ref_id >= 0), default=0)
    end = max((r.pos + 1 + sum(c for op, c in r.cigar if op in (0, 2, 3, 7, 8)) for r in reads if r.ref_id >= 0), default=0)
    span = max(0, end - start)
    n_bases = sum(len(r.seq) for r in reads)

    for r in reads:
        bf = r.flag
        cf = CF_QUAL_STORED | CF_DETACHED
        put_int("BF", bf)
        put_int("CF", cf)
        if multi_ref:
            put_int("RI", r.ref_id)
        put_int("RL", len(r.seq))
        put_int("AP", r.pos + 1)  # absolute (AP delta off)
        put_int("RG", -1)
        streams["RN"] += r.name.encode() + b"\x00"
        put_int("MF", 0)
        put_int("NS", r.mate_ref_id)
        put_int("NP", r.mate_pos + 1)
        put_int("TS", r.tlen)
        # tags
        key = tuple((t, _tag_blob(v)[0]) for t, v in r.tags.items())
        tl = tag_line_of.get(key)
        if tl is None:
            tl = len(tag_lines)
            tag_line_of[key] = tl
            tag_lines.append(key)
        put_int("TL", tl)
        for t, v in r.tags.items():
            _, blob = _tag_blob(v)
            streams["TAGS"] += itf8(len(blob)) + blob
        if not (bf & 0x4):
            # mapped: features spell out the cigar with verbatim bases
            feats = []
            spos = 0
            for op, cnt in r.cigar:
                if op in (0, 7, 8):
                    feats.append(("b", spos, r.seq[spos : spos + cnt]))
                    spos += cnt
                elif op == 1:
                    feats.append(("I", spos, r.seq[spos : spos + cnt]))
                    spos += cnt
                elif op == 4:
                    feats.append(("S", spos, r.seq[spos : spos + cnt]))
                    spos += cnt
                elif op == 2:
                    feats.append(("D", spos, cnt))
                elif op == 3:
                    feats.append(("N", spos, cnt))
                elif op == 5:
                    feats.append(("H", spos, cnt))
                elif op == 6:
                    feats.append(("P", spos, cnt))
                else:
                    raise ValueError(f"cigar op {op} unsupported")
            put_int("FN", len(feats))
            prev = 0
            for code, spos, payload in feats:
                put_int("FC", ord(code))
                put_int("FP", (spos + 1) - prev)
                prev = spos + 1
                if code in ("b", "I", "S"):
                    streams["BB" if code == "b" else ("IN" if code == "I" else "SC")] += payload + b"\x00"
                elif code == "D":
                    put_int("DL", payload)
                elif code == "N":
                    put_int("RS", payload)
                elif code == "H":
                    put_int("HC", payload)
                elif code == "P":
                    put_int("PD", payload)
            put_int("MQ", r.mapq)
        else:
            streams["BA"] += bytes(r.seq)
        q = r.qual if r.qual is not None and len(r.qual) else np.full(len(r.seq), 0xFF, dtype=np.uint8)
        streams["QS"] += bytes(np.asarray(q, dtype=np.uint8).tobytes())

    # ---- compression header ----
    pres = bytearray()
    entries = []
    entries.append(b"RN" + b"\x01")
    entries.append(b"AP" + b"\x00")
    entries.append(b"RR" + b"\x00")
    entries.append(b"SM" + b"\x1b\x1b\x1b\x1b\x1b")
    td = bytearray()
    for line in tag_lines:
        for tag, ttype in line:
            td += tag.encode() + ttype.encode()
        td += b"\x00"
    entries.append(b"TD" + itf8(len(td)) + bytes(td))
    body = itf8(len(entries)) + b"".join(entries)
    pres += itf8(len(body)) + body

    ds = []
    for key in ("BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "TL", "FN", "FC", "FP", "DL", "MQ", "HC", "PD", "RS"):
        ds.append(key.encode() + _ext_encoding(CID[key]))
    for key, stop in (("RN", 0), ("BB", 0), ("IN", 0), ("SC", 0)):
        ds.append(key.encode() + _bas_encoding(stop, CID[key]))
    ds.append(b"QS" + _ext_encoding(CID["QS"]))
    ds.append(b"BA" + _ext_encoding(CID["BA"]))
    body = itf8(len(ds)) + b"".join(ds)
    ds_map = itf8(len(body)) + body

    tags_enc = []
    for line in tag_lines:
        for tag, ttype in line:
            k = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(ttype)
            # BYTE_ARRAY_LEN(EXTERNAL len from TAGS stream itself? simpler:
            # store (len,blob) in one stream via BYTE_ARRAY_LEN with both
            # halves EXTERNAL on the same block id
            len_enc = _ext_encoding(CID["TAGS"])
            val_enc = _ext_encoding(CID["TAGS"])
            params = len_enc + val_enc
            tags_enc.append(itf8(k) + itf8(4) + itf8(len(params)) + params)
    # dedupe tag keys
    seen = set()
    uniq = []
    for e in tags_enc:
        if e not in seen:
            seen.add(e)
            uniq.append(e)
    body = itf8(len(uniq)) + b"".join(uniq)
    tag_map = itf8(len(body)) + body

    comp_hdr = bytes(pres) + ds_map + tag_map
    comp_block = _block(GZIP, COMPRESSION_HEADER, 0, comp_hdr)

    # ---- slice ----
    used = [(k, bytes(v)) for k, v in streams.items() if len(v)]
    sh = bytearray()
    sh += itf8(ref_id)
    sh += itf8(start if ref_id >= 0 else 0)
    sh += itf8(span if ref_id >= 0 else 0)
    sh += itf8(len(reads))
    sh += ltf8(counter)
    sh += itf8(1 + len(used))  # core + externals
    sh += itf8(len(used))
    for k, _ in used:
        sh += itf8(CID[k])
    sh += itf8(-1)  # no embedded reference
    sh += b"\x00" * 16
    slice_block = _block(RAW, MAPPED_SLICE, 0, bytes(sh))

    data_blocks = [slice_block, _block(RAW, CORE_DATA, 0, b"\x00")]
    for k, v in used:
        method = RANS if k in ("QS", "BB", "BA") and len(v) > 64 else GZIP
        data_blocks.append(_block(method, EXTERNAL_DATA, CID[k], v))

    blocks = [comp_block] + data_blocks
    landmarks = [len(comp_block)]
    return _container(ref_id, start if ref_id >= 0 else 0, span if ref_id >= 0 else 0,
                      len(reads), counter, n_bases, blocks, landmarks)
