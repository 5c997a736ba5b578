"""CRAM 2.1 / 3.0 decoder.

Replaces the reference's htslib CRAM read path (hts_reader.cpp:30-70 CRAM
reference handling; hts_reader.hpp:41-70) with a from-scratch implementation
producing the same AlignedRead records as the BAM/SAM readers.

Implements: ITF8/LTF8 varints, container/slice structure for both major
versions, block compression methods raw/gzip/bzip2/lzma/rANS-4x8 (orders 0
and 1), codecs EXTERNAL/HUFFMAN/BETA/BYTE_ARRAY_LEN/BYTE_ARRAY_STOP/GAMMA,
the substitution matrix, reference-based sequence reconstruction with the
full feature-code set, mate resolution for both detached and in-slice
pairs, and the tag dictionary.

Validated record-for-record against the reference's own fixture pair
(test.cram vs test.sam, tests/io/test_cram.py) and by 3.0 writer roundtrip
(io/cram_writer.py).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.io.bam import AlignedRead, BamHeader


def _header_from_text(text: str) -> BamHeader:
    ref_names: list[str] = []
    ref_lengths: list[int] = []
    for line in text.split("\n"):
        if line.startswith("@SQ"):
            sn, ln = None, 0
            for fld in line.split("\t")[1:]:
                if fld.startswith("SN:"):
                    sn = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            if sn is not None:
                ref_names.append(sn)
                ref_lengths.append(ln)
    h = BamHeader(text=text, ref_names=ref_names, ref_lengths=ref_lengths)
    h.parse_read_groups()
    return h

# block compression methods
RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4

# block content types
FILE_HEADER, COMPRESSION_HEADER, MAPPED_SLICE, EXTERNAL_DATA, CORE_DATA = 0, 1, 2, 4, 5

# CRAM record flags
CF_QUAL_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8

# mate flags
MF_MATE_NEG_STRAND = 0x1
MF_MATE_UNMAPPED = 0x2

BAM_FPAIRED = 0x1
BAM_FPROPER = 0x2
BAM_FUNMAP = 0x4
BAM_FMUNMAP = 0x8
BAM_FREVERSE = 0x10
BAM_FMREVERSE = 0x20
BAM_FREAD1 = 0x40
BAM_FREAD2 = 0x80


class CramError(ValueError):
    pass


# ---------------------------------------------------------------------------
# varints + bit reader
# ---------------------------------------------------------------------------


class ByteReader:
    __slots__ = ("data", "pos", "_itf8_vals", "_itf8_starts", "_itf8_vi")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u8(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def int32(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.pos)
        self.pos += 4
        return v

    def itf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x7F) << 8) | self.u8()
        elif b0 < 0xE0:
            v = ((b0 & 0x3F) << 16) | (self.u8() << 8) | self.u8()
        elif b0 < 0xF0:
            v = ((b0 & 0x1F) << 24) | (self.u8() << 16) | (self.u8() << 8) | self.u8()
        else:
            v = (
                ((b0 & 0x0F) << 28)
                | (self.u8() << 20)
                | (self.u8() << 12)
                | (self.u8() << 4)
                | (self.u8() & 0x0F)
            )
        # signed 32-bit
        if v >= 1 << 31:
            v -= 1 << 32
        return v

    def ltf8(self) -> int:
        b0 = self.u8()
        n = 0
        mask = 0x80
        while n < 8 and (b0 & mask):
            n += 1
            mask >>= 1
        if n == 0:
            v = b0
        elif n < 8:
            v = b0 & ((1 << (7 - n)) - 1)
            for _ in range(n):
                v = (v << 8) | self.u8()
        else:
            v = 0
            for _ in range(8):
                v = (v << 8) | self.u8()
        if v >= 1 << 63:
            v -= 1 << 64
        return v

    def eof(self) -> bool:
        return self.pos >= len(self.data)


class BitReader:
    """MSB-first bit stream over the core data block."""

    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 7

    def read_bit(self) -> int:
        b = (self.data[self.pos] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.pos += 1
        else:
            self.bit -= 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0 codec; orders 0 and 1)
# ---------------------------------------------------------------------------

RANS_L = 1 << 23
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT


def _read_freq(br: ByteReader) -> int:
    """One frequency value: < 128 one byte, else two (htslib rANS_static)."""
    f = br.u8()
    if f >= 128:
        f = ((f & 127) << 8) | br.u8()
    return f


def _read_freqs0(br: ByteReader):
    """Order-0 table: symbol-RLE layout of htslib rANS_static.c."""
    freqs = np.zeros(256, dtype=np.uint32)
    rle = 0
    j = br.u8()
    while True:
        freqs[j] = _read_freq(br)
        if rle > 0:
            rle -= 1
            j += 1
        elif br.data[br.pos] == j + 1:
            j = br.u8()
            rle = br.u8()
        else:
            j = br.u8()
        if j == 0:
            break
    return freqs


def _rans_decode_0(data: bytes, out_size: int) -> bytes:
    br = ByteReader(data)
    freqs = _read_freqs0(br)
    cum = np.zeros(257, dtype=np.uint32)
    np.cumsum(freqs, out=cum[1:])
    # symbol lookup table over the 4096 slots
    sym_of = np.zeros(TOTFREQ, dtype=np.uint8)
    for s in range(256):
        if freqs[s]:
            sym_of[cum[s] : cum[s + 1]] = s
    states = [struct.unpack_from("<I", br.data, br.pos + 4 * i)[0] for i in range(4)]
    br.pos += 16
    out = bytearray(out_size)
    p = br.pos
    d = br.data
    for i in range(out_size):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = int(sym_of[slot])
        out[i] = s
        x = int(freqs[s]) * (x >> TF_SHIFT) + slot - int(cum[s])
        while x < RANS_L and p < len(d):
            x = (x << 8) | d[p]
            p += 1
        states[j] = x
    return bytes(out)


def _rans_decode_1(data: bytes, out_size: int) -> bytes:
    br = ByteReader(data)
    # order-1 frequency tables: per context byte
    freqs = np.zeros((256, 256), dtype=np.uint32)
    cum = np.zeros((256, 257), dtype=np.uint32)
    rle_i = 0
    i = br.u8()
    while True:
        # inner order-0 style table for context i
        rle_j = 0
        j = br.u8()
        while True:
            freqs[i, j] = _read_freq(br)
            if rle_j > 0:
                rle_j -= 1
                j += 1
            elif br.data[br.pos] == j + 1:
                j = br.u8()
                rle_j = br.u8()
            else:
                j = br.u8()
            if j == 0:
                break
        if rle_i > 0:
            rle_i -= 1
            i += 1
        elif br.data[br.pos] == i + 1:
            i = br.u8()
            rle_i = br.u8()
        else:
            i = br.u8()
        if i == 0:
            break
    np.cumsum(freqs, axis=1, out=cum[:, 1:])
    lut = np.zeros((256, TOTFREQ), dtype=np.uint8)
    for i in range(256):
        if freqs[i].sum() == 0:
            continue
        for s in range(256):
            if freqs[i, s]:
                lut[i, cum[i, s] : cum[i, s + 1]] = s
    states = [struct.unpack_from("<I", br.data, br.pos + 4 * i)[0] for i in range(4)]
    br.pos += 16
    out = bytearray(out_size)
    p = br.pos
    d = br.data
    # 4 interleaved streams, each decoding a quarter (last gets remainder)
    q = out_size >> 2
    ctx = [0, 0, 0, 0]
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, out_size]
    idx = list(starts)
    for _ in range(q):
        for j in range(4):
            x = states[j]
            i = ctx[j]
            slot = x & (TOTFREQ - 1)
            s = int(lut[i, slot])
            out[idx[j]] = s
            idx[j] += 1
            x = int(freqs[i, s]) * (x >> TF_SHIFT) + slot - int(cum[i, s])
            while x < RANS_L and p < len(d):
                x = (x << 8) | d[p]
                p += 1
            states[j] = x
            ctx[j] = s
    # remainder handled by stream 3
    j = 3
    while idx[j] < ends[j]:
        x = states[j]
        i = ctx[j]
        slot = x & (TOTFREQ - 1)
        s = int(lut[i, slot])
        out[idx[j]] = s
        idx[j] += 1
        x = int(freqs[i, s]) * (x >> TF_SHIFT) + slot - int(cum[i, s])
        while x < RANS_L and p < len(d):
            x = (x << 8) | d[p]
            p += 1
        states[j] = x
        ctx[j] = s
    return bytes(out)


def _rans_decode_native(body: bytes, order: int, out_size: int) -> bytes | None:
    """C twin of the order-0/1 decoders (native/gt_native.cpp
    gt_rans_decode): the interleaved byte-at-a-time renormalization loop is
    unvectorizable in numpy and dominates CRAM read time in pure Python."""
    from graphtyper_tpu_torch.io.native import get_lib

    lib = get_lib()
    import ctypes

    if not getattr(lib, "_rans_ready", False):
        lib.gt_rans_decode.restype = ctypes.c_int64
        lib.gt_rans_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._rans_ready = True
    out = ctypes.create_string_buffer(out_size)
    rc = lib.gt_rans_decode(body, len(body), order, out, out_size)
    if rc != 0:
        return None
    return out.raw


def rans_decode(data: bytes) -> bytes:
    order = data[0]
    # 4-byte compressed size + 4-byte uncompressed size
    (out_size,) = struct.unpack_from("<I", data, 5)
    body = data[9:]
    if order not in (0, 1):
        raise CramError(f"unsupported rANS order {order}")
    native = _rans_decode_native(body, order, out_size)
    if native is not None:
        return native
    if order == 0:
        return _rans_decode_0(body, out_size)
    return _rans_decode_1(body, out_size)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


@dataclass
class Encoding:
    codec: int
    params: bytes

    def build(self, blocks: dict, major: int) -> "Codec":
        br = ByteReader(self.params)
        if self.codec == 0:
            return NullCodec()
        if self.codec == 1:  # EXTERNAL
            cid = br.itf8()
            return ExternalCodec(blocks, cid)
        if self.codec == 3:  # HUFFMAN
            n = br.itf8()
            alphabet = [br.itf8() for _ in range(n)]
            m = br.itf8()
            lengths = [br.itf8() for _ in range(m)]
            return HuffmanCodec(alphabet, lengths)
        if self.codec == 4:  # BYTE_ARRAY_LEN
            len_codec = read_encoding(br)
            val_codec = read_encoding(br)
            return ByteArrayLenCodec(len_codec.build(blocks, major), val_codec.build(blocks, major))
        if self.codec == 5:  # BYTE_ARRAY_STOP
            stop = br.u8()
            cid = br.itf8()
            return ByteArrayStopCodec(blocks, stop, cid)
        if self.codec == 6:  # BETA
            offset = br.itf8()
            nbits = br.itf8()
            return BetaCodec(offset, nbits)
        if self.codec == 9:  # GAMMA
            offset = br.itf8()
            return GammaCodec(offset)
        raise CramError(f"unsupported codec {self.codec}")


def read_encoding(br: ByteReader) -> Encoding:
    codec = br.itf8()
    nbytes = br.itf8()
    params = br.bytes(nbytes)
    return Encoding(codec, params)


class Codec:
    def read_int(self, core: BitReader) -> int:
        raise NotImplementedError

    def read_bytes(self, core: BitReader, n: int) -> bytes:
        return bytes(self.read_int(core) & 0xFF for _ in range(n))


class NullCodec(Codec):
    def read_int(self, core: BitReader) -> int:
        raise CramError("read from NULL codec")


def _predecode_itf8(s: ByteReader) -> bool:
    """Decode every consecutive ITF8 value of an external stream in one
    native pass (gt_itf8_decode_all) so per-record reads become array
    lookups. Mixed itf8/raw streams stay correct: the value cursor is
    validated against the exact byte position and falls back to live
    parsing on any mismatch."""
    from graphtyper_tpu_torch.io.native import get_lib

    lib = get_lib()
    import ctypes

    if not getattr(lib, "_itf8_ready", False):
        lib.gt_itf8_decode_all.restype = ctypes.c_int64
        lib.gt_itf8_decode_all.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._itf8_ready = True
    data = s.data
    cap = len(data) - s.pos + 1
    if cap > 256 * 1024:
        # huge streams reached via read_int are raw byte series with
        # occasional scalar reads (QS via 'Q'/'B' features): pre-parsing
        # megabytes of quality bytes as itf8 costs more than it saves
        s._itf8_vals = False
        return False
    vals = np.empty(cap, dtype=np.int32)
    starts = np.empty(cap + 1, dtype=np.int64)
    vp = ctypes.c_void_p
    n = lib.gt_itf8_decode_all(data, len(data), s.pos, vp(vals.ctypes.data), vp(starts.ctypes.data))
    # plain lists: per-value access is hot and list indexing beats numpy
    # scalar indexing several-fold
    s._itf8_vals = vals[:n].tolist()
    s._itf8_starts = starts[: n + 1].tolist()  # [n] = parse end
    s._itf8_vi = 0
    return True


class ExternalCodec(Codec):
    def __init__(self, blocks: dict, cid: int):
        # lazy: a block may be absent when its series is never used
        self._blocks = blocks
        self._cid = cid

    @property
    def stream(self):
        return self._blocks[self._cid]

    def read_int(self, core: BitReader) -> int:
        s = self.stream
        vals = getattr(s, "_itf8_vals", None)
        if vals is None:
            if not _predecode_itf8(s):
                return s.itf8()
            vals = s._itf8_vals
        elif vals is False:
            return s.itf8()
        starts = s._itf8_starts
        vi = s._itf8_vi
        pos = s.pos
        if vi >= len(vals) or starts[vi] != pos:
            # resync after raw-byte reads on the same stream
            from bisect import bisect_left

            vi = bisect_left(starts, pos, 0, len(vals))
            if vi >= len(vals) or starts[vi] != pos:
                return s.itf8()  # non-itf8 region: live parse
        v = vals[vi]
        s._itf8_vi = vi + 1
        s.pos = starts[vi + 1]
        return v

    def read_byte(self) -> int:
        return self.stream.u8()

    def read_bytes(self, core: BitReader, n: int) -> bytes:
        return self.stream.bytes(n)


class HuffmanCodec(Codec):
    def __init__(self, alphabet: list[int], lengths: list[int]):
        self.constant = None
        if len(alphabet) == 1 and (not lengths or lengths[0] == 0):
            self.constant = alphabet[0]
            return
        # canonical codes: sort by (length, symbol order of appearance)
        pairs = sorted(zip(lengths, range(len(alphabet))))
        self.table = {}  # (length, code) -> symbol
        code = 0
        prev_len = 0
        for ln, idx in pairs:
            code <<= ln - prev_len
            prev_len = ln
            self.table[(ln, code)] = alphabet[idx]
            code += 1
        self.max_len = max(lengths) if lengths else 0

    def read_int(self, core: BitReader) -> int:
        if self.constant is not None:
            return self.constant
        code = 0
        ln = 0
        while ln <= self.max_len:
            code = (code << 1) | core.read_bit()
            ln += 1
            sym = self.table.get((ln, code))
            if sym is not None:
                return sym
        raise CramError("bad huffman code")


class BetaCodec(Codec):
    def __init__(self, offset: int, nbits: int):
        self.offset = offset
        self.nbits = nbits

    def read_int(self, core: BitReader) -> int:
        return core.read_bits(self.nbits) - self.offset


class GammaCodec(Codec):
    def __init__(self, offset: int):
        self.offset = offset

    def read_int(self, core: BitReader) -> int:
        n = 0
        while core.read_bit() == 0:
            n += 1
        v = 1
        for _ in range(n):
            v = (v << 1) | core.read_bit()
        return v - self.offset


class ByteArrayLenCodec(Codec):
    def __init__(self, len_codec: Codec, val_codec: Codec):
        self.len_codec = len_codec
        self.val_codec = val_codec

    def read_array(self, core: BitReader) -> bytes:
        n = self.len_codec.read_int(core)
        return self.val_codec.read_bytes(core, n)


class ByteArrayStopCodec(Codec):
    def __init__(self, blocks: dict, stop: int, cid: int):
        self._blocks = blocks
        self._cid = cid
        self.stop = stop

    @property
    def stream(self):
        return self._blocks[self._cid]

    def read_array(self, core: BitReader) -> bytes:
        s = self.stream
        start = s.pos
        data = s.data
        # bytes.find is a C memchr — no per-byte Python loop
        p = data.find(self.stop, start)
        if p < 0:
            p = len(data)
        out = data[start:p]
        s.pos = p + 1
        return out


# ---------------------------------------------------------------------------
# container structure
# ---------------------------------------------------------------------------


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes


def _read_block_raw(br: ByteReader, major: int):
    method = br.u8()
    content_type = br.u8()
    content_id = br.itf8()
    comp_size = br.itf8()
    raw_size = br.itf8()
    payload = br.bytes(comp_size)
    if major >= 3:
        br.bytes(4)  # crc32
    return method, content_type, content_id, raw_size, payload


def _decompress_block(method: int, payload: bytes) -> bytes:
    if method == RAW:
        return payload
    if method == GZIP:
        return gzip.decompress(payload)
    if method == BZIP2:
        return bz2.decompress(payload)
    if method == LZMA:
        return lzma.decompress(payload)
    if method == RANS:
        return rans_decode(payload)
    raise CramError(f"unknown compression method {method}")


def _make_block(method, content_type, content_id, raw_size, data) -> Block:
    if len(data) != raw_size:
        raise CramError(f"block size mismatch: {len(data)} != {raw_size}")
    return Block(method, content_type, content_id, data)


def read_block(br: ByteReader, major: int) -> Block:
    method, content_type, content_id, raw_size, payload = _read_block_raw(br, major)
    return _make_block(method, content_type, content_id, raw_size, _decompress_block(method, payload))


def finish_slice_blocks(raws) -> tuple:
    """Decompress one slice's raw blocks (from _iter_slices_raw) into
    (core BitReader | None, {content_id: ByteReader}). The heavy blocks
    decompress concurrently — the rANS/zlib work runs in native code that
    releases the GIL, and a slice's blocks are independent (one per data
    series)."""
    heavy = [i for i, r in enumerate(raws) if r[0] != RAW and len(r[4]) > 16384]
    datas: list[bytes | None] = [None] * len(raws)
    if len(heavy) >= 2:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, len(heavy))) as ex:
            for i, data in zip(
                heavy, ex.map(lambda i: _decompress_block(raws[i][0], raws[i][4]), heavy)
            ):
                datas[i] = data
    core = None
    ext: dict[int, ByteReader] = {}
    for i, (method, ctype, cid, raw_size, payload) in enumerate(raws):
        data = datas[i] if datas[i] is not None else _decompress_block(method, payload)
        b = _make_block(method, ctype, cid, raw_size, data)
        if b.content_type == CORE_DATA:
            core = BitReader(b.data)
        else:
            ext[b.content_id] = ByteReader(b.data)
    return core, ext


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_bases: int
    n_blocks: int
    landmarks: list[int]


def read_container_header(br: ByteReader, major: int) -> ContainerHeader:
    length = br.int32()
    ref_id = br.itf8()
    start = br.itf8()
    span = br.itf8()
    n_records = br.itf8()
    if major >= 3:
        record_counter = br.ltf8()
        n_bases = br.ltf8()
    else:
        record_counter = br.itf8()
        n_bases = br.ltf8()
    n_blocks = br.itf8()
    n_landmarks = br.itf8()
    landmarks = [br.itf8() for _ in range(n_landmarks)]
    if major >= 3:
        br.bytes(4)  # crc32
    return ContainerHeader(length, ref_id, start, span, n_records, record_counter, n_bases, n_blocks, landmarks)


@dataclass
class CompressionHeader:
    preserve_read_names: bool = True
    ap_delta: bool = True
    reference_required: bool = True
    substitution_matrix: bytes = b""
    tag_dict: list[list[tuple[str, str]]] = field(default_factory=list)
    data_series: dict = field(default_factory=dict)  # 2-char key -> Encoding
    tag_encodings: dict = field(default_factory=dict)  # int key -> Encoding


def read_compression_header(data: bytes) -> CompressionHeader:
    br = ByteReader(data)
    ch = CompressionHeader()
    # preservation map
    br.itf8()  # size in bytes
    n = br.itf8()
    for _ in range(n):
        key = br.bytes(2).decode()
        if key == "RN":
            ch.preserve_read_names = br.u8() != 0
        elif key == "AP":
            ch.ap_delta = br.u8() != 0
        elif key == "RR":
            ch.reference_required = br.u8() != 0
        elif key == "SM":
            ch.substitution_matrix = br.bytes(5)
        elif key == "TD":
            ln = br.itf8()
            blob = br.bytes(ln)
            for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                tags = []
                for i in range(0, len(line) - 2, 3):
                    tags.append((line[i : i + 2].decode(), chr(line[i + 2])))
                tags_line = tags
                ch.tag_dict.append(tags_line)
        else:
            raise CramError(f"unknown preservation key {key}")
    # data series encodings
    br.itf8()
    n = br.itf8()
    for _ in range(n):
        key = br.bytes(2).decode()
        ch.data_series[key] = read_encoding(br)
    # tag encodings
    br.itf8()
    n = br.itf8()
    for _ in range(n):
        key = br.itf8()
        ch.tag_encodings[key] = read_encoding(br)
    return ch


@dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: list[int]
    embedded_ref_id: int
    ref_md5: bytes


def read_slice_header(data: bytes, major: int) -> SliceHeader:
    br = ByteReader(data)
    ref_id = br.itf8()
    start = br.itf8()
    span = br.itf8()
    n_records = br.itf8()
    record_counter = br.ltf8() if major >= 3 else br.itf8()
    n_blocks = br.itf8()
    n_ids = br.itf8()
    content_ids = [br.itf8() for _ in range(n_ids)]
    embedded_ref_id = br.itf8()
    ref_md5 = br.bytes(16)
    return SliceHeader(ref_id, start, span, n_records, record_counter, n_blocks, content_ids, embedded_ref_id, ref_md5)


# ---------------------------------------------------------------------------
# record decode
# ---------------------------------------------------------------------------

_SUB_BASES = b"ACGTN"


def _build_sub_matrix(sm: bytes) -> dict[int, bytes]:
    """SM packs, per reference base (A,C,G,T,N), 2-bit ranks of the other 4
    bases; rank r = the base with code r among the non-ref bases."""
    out = {}
    for i, ref_b in enumerate(_SUB_BASES):
        byte = sm[i] if i < len(sm) else 0
        others = bytes(b for b in _SUB_BASES if b != ref_b)
        subs = bytearray(4)
        for j, alt in enumerate(others):
            rank = (byte >> (6 - 2 * j)) & 3
            subs[rank] = alt
        out[ref_b] = bytes(subs)
    return out


class _TagValueReader:
    """Decode one BAM-typed tag value from a byte stream."""

    def __init__(self, ttype: str):
        self.ttype = ttype

    def read(self, data: bytes):
        t = self.ttype
        if t == "A":
            return data.decode("latin1")
        if t in "cC":
            return int(np.frombuffer(data[:1], dtype=np.int8 if t == "c" else np.uint8)[0])
        if t in "sS":
            return int(np.frombuffer(data[:2], dtype=np.int16 if t == "s" else np.uint16)[0])
        if t in "iI":
            return int(np.frombuffer(data[:4], dtype=np.int32 if t == "i" else np.uint32)[0])
        if t == "f":
            return float(np.frombuffer(data[:4], dtype=np.float32)[0])
        if t in "ZH":
            return data.rstrip(b"\x00").decode("latin1")
        if t == "B":
            sub = chr(data[0])
            (cnt,) = struct.unpack_from("<I", data, 1)
            arr = np.frombuffer(
                data[5:],
                dtype={"c": np.int8, "C": np.uint8, "s": np.int16, "S": np.uint16, "i": np.int32, "I": np.uint32, "f": np.float32}[sub],
                count=cnt,
            )
            return arr.tolist()
        raise CramError(f"unknown tag type {t}")


@dataclass
class _CramRec:
    bf: int = 0
    cf: int = 0
    ref_id: int = -1
    read_len: int = 0
    pos: int = 0
    rg: int = -1
    name: bytes = b""
    mate_flags: int = 0
    mate_ref_id: int = -1
    mate_pos: int = -1
    tlen: int = 0
    mate_rec_index: int = -1  # in-slice distance (NF)
    tags: dict = field(default_factory=dict)
    mapq: int = 0
    seq: bytes = b""
    qual: np.ndarray | None = None
    cigar: list = field(default_factory=list)
    end_pos: int = 0


def _decode_slice(
    ch: CompressionHeader,
    sh: SliceHeader,
    core: BitReader,
    ext: dict,
    major: int,
    ref_getter,
    record_counter_start: int,
) -> list[_CramRec]:
    ds = {k: v.build(ext, major) for k, v in ch.data_series.items()}
    tag_codecs = {k: v.build(ext, major) for k, v in ch.tag_encodings.items()}
    subs = _build_sub_matrix(ch.substitution_matrix)

    def read_int(key):
        return ds[key].read_int(core)

    def read_array(key):
        c = ds[key]
        if isinstance(c, (ByteArrayLenCodec, ByteArrayStopCodec)):
            return c.read_array(core)
        raise CramError(f"data series {key} is not a byte-array codec")

    records: list[_CramRec] = []
    last_ap = sh.start
    for rec_i in range(sh.n_records):
        r = _CramRec()
        r.bf = read_int("BF")
        r.cf = read_int("CF")
        if sh.ref_id == -2:
            r.ref_id = read_int("RI")
        else:
            r.ref_id = sh.ref_id
        r.read_len = read_int("RL")
        ap = read_int("AP")
        if ch.ap_delta:
            r.pos = last_ap + ap
            last_ap = r.pos
        else:
            r.pos = ap
        r.rg = read_int("RG")
        if ch.preserve_read_names:
            r.name = read_array("RN")
        if r.cf & CF_DETACHED:
            r.mate_flags = read_int("MF")
            if not ch.preserve_read_names:
                r.name = read_array("RN")
            r.mate_ref_id = read_int("NS")
            r.mate_pos = read_int("NP")
            r.tlen = read_int("TS")
        elif r.cf & CF_MATE_DOWNSTREAM:
            r.mate_rec_index = rec_i + 1 + read_int("NF")
        # tags
        tl = read_int("TL")
        if 0 <= tl < len(ch.tag_dict):
            for tag, ttype in ch.tag_dict[tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(ttype)
                codec = tag_codecs[key]
                if isinstance(codec, (ByteArrayLenCodec, ByteArrayStopCodec)):
                    blob = codec.read_array(core)
                else:
                    blob = bytes([codec.read_int(core) & 0xFF])
                r.tags[tag] = _TagValueReader(ttype).read(blob)

        if not (r.bf & BAM_FUNMAP):
            # mapped read: features
            fn = read_int("FN")
            features = []
            fpos = 0
            for _ in range(fn):
                fc = chr(read_int("FC") & 0xFF)
                fp = read_int("FP")
                fpos += fp
                if fc == "B":
                    features.append((fpos, "B", read_int("BA"), read_int("QS")))
                elif fc == "X":
                    features.append((fpos, "X", read_int("BS")))
                elif fc == "I":
                    features.append((fpos, "I", read_array("IN")))
                elif fc == "S":
                    key = "SC" if "SC" in ds else "IN"
                    features.append((fpos, "S", read_array(key)))
                elif fc == "D":
                    features.append((fpos, "D", read_int("DL")))
                elif fc == "i":
                    features.append((fpos, "i", read_int("BA")))
                elif fc == "N":
                    features.append((fpos, "N", read_int("RS")))
                elif fc == "P":
                    features.append((fpos, "P", read_int("PD")))
                elif fc == "H":
                    features.append((fpos, "H", read_int("HC")))
                elif fc == "b":
                    features.append((fpos, "b", read_array("BB")))
                elif fc == "q":
                    features.append((fpos, "q", read_array("QQ")))
                elif fc == "Q":
                    features.append((fpos, "Q", read_int("QS")))
                else:
                    raise CramError(f"unknown feature code {fc}")
            r.mapq = read_int("MQ")
            if r.cf & CF_QUAL_STORED:
                q = ds["QS"].read_bytes(core, r.read_len)
                r.qual = np.frombuffer(q, dtype=np.uint8)
            _reconstruct_seq(r, features, subs, ref_getter)
        else:
            # unmapped: bases stored verbatim
            if r.cf & CF_NO_SEQ:
                r.seq = b"*"
            else:
                ba = ds["BA"]
                r.seq = ba.read_bytes(core, r.read_len)
            if r.cf & CF_QUAL_STORED:
                q = ds["QS"].read_bytes(core, r.read_len)
                r.qual = np.frombuffer(q, dtype=np.uint8)
        records.append(r)

    # resolve in-slice mate chains (spec 10.3: NF distance)
    for i, r in enumerate(records):
        if r.mate_rec_index >= 0 and r.mate_rec_index < len(records):
            m = records[r.mate_rec_index]
            # link both ways like htslib cram_decode_slice
            r.mate_ref_id = m.ref_id
            r.mate_pos = m.pos
            if m.bf & BAM_FREVERSE:
                r.bf |= BAM_FMREVERSE
            if m.bf & BAM_FUNMAP:
                r.bf |= BAM_FMUNMAP
            m.mate_ref_id = r.ref_id
            m.mate_pos = r.pos
            if r.bf & BAM_FREVERSE:
                m.bf |= BAM_FMREVERSE
            if r.bf & BAM_FUNMAP:
                m.bf |= BAM_FMUNMAP
            m.name = r.name
            # template size: leftmost gets +, rightmost gets - (htslib)
            left = min(r.pos, m.pos)
            right = max(r.end_pos, m.end_pos)
            tlen = right - left + 1
            if r.pos <= m.pos:
                r.tlen = tlen
                m.tlen = -tlen
            else:
                r.tlen = -tlen
                m.tlen = tlen
    # auto-generate names for anything still unnamed
    for i, r in enumerate(records):
        if not r.name:
            r.name = str(record_counter_start + i).encode()
        if r.cf & CF_DETACHED:
            if r.mate_flags & MF_MATE_NEG_STRAND:
                r.bf |= BAM_FMREVERSE
            if r.mate_flags & MF_MATE_UNMAPPED:
                r.bf |= BAM_FMUNMAP
    return records


def _reconstruct_seq(r: _CramRec, features, subs, ref_getter) -> None:
    """Rebuild sequence + CIGAR from reference and features."""
    seq = bytearray()
    cigar: list[tuple[int, int]] = []
    ref = ref_getter(r.ref_id)

    def add_cigar(op: int, n: int):
        if n <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + n)
        else:
            cigar.append((op, n))

    rpos = r.pos - 1  # 0-based reference cursor
    spos = 0  # read cursor (0-based)
    for feat in features:
        fpos = feat[0] - 1  # 1-based in-read position -> 0-based
        ftype = feat[1]
        # fill matching bases up to the feature
        gap = fpos - spos
        if gap > 0:
            seq += ref[rpos : rpos + gap]
            add_cigar(0, gap)
            rpos += gap
            spos += gap
        if ftype == "B":
            seq.append(feat[2] & 0xFF)
            add_cigar(0, 1)
            rpos += 1
            spos += 1
        elif ftype == "X":
            ref_b = ref[rpos] if rpos < len(ref) else ord("N")
            table = subs.get(ref_b if ref_b in _SUB_BASES else ord("N"))
            seq.append(table[feat[2] & 3])
            add_cigar(0, 1)
            rpos += 1
            spos += 1
        elif ftype == "I":
            seq += feat[2]
            add_cigar(1, len(feat[2]))
            spos += len(feat[2])
        elif ftype == "S":
            seq += feat[2]
            add_cigar(4, len(feat[2]))
            spos += len(feat[2])
        elif ftype == "D":
            add_cigar(2, feat[2])
            rpos += feat[2]
        elif ftype == "i":
            seq.append(feat[2] & 0xFF)
            add_cigar(1, 1)
            spos += 1
        elif ftype == "N":
            add_cigar(3, feat[2])
            rpos += feat[2]
        elif ftype == "P":
            add_cigar(6, feat[2])
        elif ftype == "H":
            add_cigar(5, feat[2])
        elif ftype == "b":
            seq += feat[2]
            add_cigar(0, len(feat[2]))
            rpos += len(feat[2])
            spos += len(feat[2])
        elif ftype == "q":
            # quality run; does not affect seq/cigar
            pass
        elif ftype == "Q":
            pass
    # trailing match
    tail = r.read_len - spos
    if tail > 0:
        seq += ref[rpos : rpos + tail]
        add_cigar(0, tail)
        rpos += tail
    r.seq = bytes(seq)
    r.cigar = cigar
    r.end_pos = rpos  # 0-based exclusive == 1-based inclusive end


# ---------------------------------------------------------------------------
# file-level reader
# ---------------------------------------------------------------------------


class CramFile:
    def __init__(self, path: str, ref_path: str | None = None):
        with open(path, "rb") as f:
            self.data = f.read()
        if self.data[:4] != b"CRAM":
            raise CramError("not a CRAM file")
        self.major = self.data[4]
        self.minor = self.data[5]
        if self.major not in (2, 3):
            raise CramError(f"unsupported CRAM version {self.major}.{self.minor}")
        self.br = ByteReader(self.data, 26)
        # first container: SAM header text
        hdr = read_container_header(self.br, self.major)
        payload_end = self.br.pos + hdr.length
        block = read_block(self.br, self.major)
        tbr = ByteReader(block.data)
        text_len = tbr.int32()
        text = tbr.bytes(text_len).split(b"\x00")[0].decode()
        self.br.pos = payload_end
        self.header = _header_from_text(text.rstrip("\n"))
        self.ref_path = ref_path
        self._ref_cache: dict[int, bytes] = {}
        self._fasta = None

    def _get_ref(self, ref_id: int, md5: bytes | None = None, start: int = 0, span: int = 0) -> bytes:
        """Reference bases for a slice. If the provided FASTA's fragment MD5
        does not match the slice header (or no FASTA was given), fall back to
        an all-N virtual reference — matching encoders that ran without a
        reference (every base then decodes via the substitution matrix's N
        row or verbatim features)."""
        if ref_id < 0:
            return b""
        got = self._ref_cache.get(ref_id)
        if got is None and self.ref_path is not None:
            if self._fasta is None:
                from graphtyper_tpu_torch.io.fasta import FastaFile

                self._fasta = FastaFile(self.ref_path)
            name = self.header.ref_names[ref_id]
            if self._fasta.has_contig(name):
                got = self._fasta.fetch(name).upper()
        if got is None:
            got = b"N" * (
                self.header.ref_lengths[ref_id]
                if ref_id < len(self.header.ref_lengths)
                else start + span + 1
            )
        if md5 is not None and md5 != b"\x00" * 16:
            import hashlib

            frag = got[max(0, start - 1) : max(0, start - 1) + span]
            if hashlib.md5(frag).digest() != md5:
                got = b"N" * max(
                    len(got),
                    self.header.ref_lengths[ref_id]
                    if ref_id < len(self.header.ref_lengths)
                    else start + span + 1,
                )
        self._ref_cache[ref_id] = got
        return got

    def _iter_slices_raw(self, region: tuple[int, int, int] | None = None):
        """Walk containers/slices WITHOUT decompressing the data blocks;
        `region=(ref_id, beg, end)` (0-based half-open) skips every container
        whose header range does not overlap — the container header carries
        (ref_id, start, span, length), so region reads are O(matching
        slices) with no index file (htslib needs the .crai only because it
        streams; we hold the byte buffer). Multi-ref containers
        (ref_id == -2) are always yielded. Yields (ch, sh, raw_blocks,
        counter, ref_getter); finish with finish_slice_blocks — consumers
        can do that concurrently per slice (io/cram_native.cram_to_bam_bytes)."""
        br = self.br
        major = self.major
        while not br.eof():
            hdr = read_container_header(br, major)
            payload_end = br.pos + hdr.length
            if hdr.ref_id == -1 and hdr.start == 4542278:
                break  # EOF container
            if hdr.n_records == 0 and hdr.n_blocks == 0:
                br.pos = payload_end
                continue
            if region is not None and hdr.ref_id != -2:
                rid, beg, end = region
                c_beg = hdr.start - 1  # container start is 1-based
                if hdr.ref_id != rid or c_beg + hdr.span <= beg or c_beg >= end:
                    br.pos = payload_end
                    continue
            comp_block = read_block(br, major)
            if comp_block.content_type != COMPRESSION_HEADER:
                raise CramError("expected compression header block")
            ch = read_compression_header(comp_block.data)
            # slices until the payload is exhausted
            counter = hdr.record_counter
            while br.pos < payload_end:
                slice_block = read_block(br, major)
                if slice_block.content_type != MAPPED_SLICE:
                    raise CramError(f"expected slice header, got {slice_block.content_type}")
                sh = read_slice_header(slice_block.data, major)
                raws = [_read_block_raw(br, major) for _ in range(sh.n_blocks)]

                def ref_getter(rid, _sh=sh):
                    return self._get_ref(rid, _sh.ref_md5, _sh.start, _sh.span)

                yield ch, sh, raws, counter, ref_getter
                counter += sh.n_records
            br.pos = payload_end

    def _iter_slices(self, region: tuple[int, int, int] | None = None):
        """Decompressed-slice walk: (ch, sh, core, ext, counter, ref_getter)."""
        for ch, sh, raws, counter, ref_getter in self._iter_slices_raw(region):
            core, ext = finish_slice_blocks(raws)
            yield ch, sh, core, ext, counter, ref_getter

    def records(self, region: tuple[int, int, int] | None = None) -> list[_CramRec]:
        """Decode records via the Python slice decoder (parity oracle)."""
        out: list[_CramRec] = []
        for ch, sh, core, ext, counter, ref_getter in self._iter_slices(region):
            out.extend(_decode_slice(ch, sh, core, ext, self.major, ref_getter, counter))
        return out


def _regenerate_nm_md(r: "_CramRec", ref: bytes) -> None:
    """NM/MD tags from the alignment vs the real reference (htslib regenerates
    these on CRAM decode when the reference is available; encoders drop them)."""
    if not ref or not r.cigar:
        return
    nm = 0
    md_parts: list[str] = []
    match_run = 0
    rpos = r.pos - 1
    spos = 0
    for op, cnt in r.cigar:
        if op in (0, 7, 8):  # M
            for i in range(cnt):
                rb = ref[rpos + i] if rpos + i < len(ref) else ord("N")
                sb = r.seq[spos + i]
                if rb == sb:
                    match_run += 1
                else:
                    nm += 1
                    md_parts.append(str(match_run))
                    md_parts.append(chr(rb))
                    match_run = 0
            rpos += cnt
            spos += cnt
        elif op == 1:  # I
            nm += cnt
            spos += cnt
        elif op == 2:  # D
            nm += cnt
            md_parts.append(str(match_run))
            md_parts.append("^" + ref[rpos : rpos + cnt].decode("latin1"))
            match_run = 0
            rpos += cnt
        elif op == 3:  # N
            rpos += cnt
        elif op == 4:  # S
            spos += cnt
        # H/P: nothing
    md_parts.append(str(match_run))
    r.tags.setdefault("NM", nm)
    r.tags.setdefault("MD", "".join(md_parts))


class _RegenShim:
    """1-based-pos view of an AlignedRead for _regenerate_nm_md."""

    __slots__ = ("pos", "cigar", "seq", "tags")


def read_cram(
    path: str,
    ref_path: str | None = None,
    parse_tags: bool = True,
    region: tuple[str, int, int] | None = None,
):
    """Decode a CRAM file into (BamHeader, [AlignedRead]) like read_bam.
    When the provided reference verifies (slice MD5), NM/MD tags dropped by
    the encoder are regenerated like htslib does. `region=(chrom, beg, end)`
    (0-based half-open) decodes only overlapping containers; the returned
    record set is a container-granular superset of the overlap, exactly like
    a BAI query (consumers filter by position)."""
    cf = CramFile(path, ref_path)
    rid_region = None
    if region is not None:
        chrom, beg, end = region
        try:
            rid = cf.header.ref_names.index(chrom)
        except ValueError:
            rid = -9  # unknown contig: no container can match
        rid_region = (rid, max(0, beg), end)

    def _regen_one(read: AlignedRead) -> None:
        if read.flag & BAM_FUNMAP or read.ref_id < 0:
            return
        ref = cf._ref_cache.get(read.ref_id, b"")
        if ref and not ref.startswith(b"NNNNNNNN"):
            # _regenerate_nm_md consumes 1-based pos (duck-typed shim)
            s = _RegenShim()
            s.pos = read.pos + 1
            s.cigar = read.cigar
            s.seq = read.seq
            s.tags = read.tags
            _regenerate_nm_md(s, ref)

    from graphtyper_tpu_torch.io.cram_native import decode_slice_native

    reads: list[AlignedRead] = []
    for ch, sh, core, ext, counter, ref_getter in cf._iter_slices(rid_region):
        native = None
        if sh.ref_id != -2:  # multi-ref slices need per-record references
            ref = ref_getter(sh.ref_id) if sh.ref_id >= 0 else b""
            native = decode_slice_native(ch, sh, ext, counter, ref)
        if native is not None:
            if parse_tags and ref_path is not None:
                for read in native:
                    _regen_one(read)
            elif not parse_tags:
                for read in native:
                    read.tags = {}
            reads.extend(native)
            continue
        for r in _decode_slice(ch, sh, core, ext, cf.major, ref_getter, counter):
            if (
                parse_tags
                and ref_path is not None
                and not (r.bf & BAM_FUNMAP)
                and r.ref_id >= 0
            ):
                ref = cf._ref_cache.get(r.ref_id, b"")
                if ref and not ref.startswith(b"NNNNNNNN"):
                    _regenerate_nm_md(r, ref)
            qual = r.qual if r.qual is not None else np.full(len(r.seq), 0xFF, dtype=np.uint8)
            reads.append(
                AlignedRead(
                    name=r.name.decode("latin1"),
                    flag=r.bf,
                    ref_id=r.ref_id,
                    pos=r.pos - 1,
                    mapq=r.mapq,
                    cigar=r.cigar,
                    mate_ref_id=r.mate_ref_id,
                    mate_pos=r.mate_pos - 1,
                    tlen=r.tlen,
                    seq=bytes(r.seq),
                    qual=qual,
                    tags=r.tags if parse_tags else {},
                )
            )
    return cf.header, reads
