"""BGZF (blocked gzip) reader/writer.

Replaces the reference's htslib bgzf + libdeflate usage (bgzf_stream.hpp,
vcf.cpp bgzf write path) with a self-contained implementation. BGZF is a
series of gzip members, each with a BC extra subfield carrying the compressed
block size; virtual file offsets are (compressed_offset << 16) | within_block.

Reading a whole file falls back to zlib streaming over concatenated members;
block-level access supports tabix virtual offsets.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

BGZF_MAX_BLOCK_SIZE = 0x10000
# Standard 28-byte BGZF EOF marker block
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH")  # magic1 magic2 CM FLG MTIME XFL OS XLEN


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(18)
    if len(head) < 18 or head[:2] != b"\x1f\x8b" or not head[3] & 4:
        return False
    return head[12:14] == b"BC"


def _read_block(f) -> tuple[bytes, int] | None:
    """Read one BGZF block from current position. Returns (data, compressed_len)
    or None at EOF."""
    header = f.read(12)
    if len(header) == 0:
        return None
    if len(header) < 12 or header[:2] != b"\x1f\x8b":
        raise ValueError("truncated/invalid BGZF block header")
    xlen = struct.unpack("<H", header[10:12])[0]
    extra = f.read(xlen)
    bsize = None
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2 : i + 4])[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1  # total block size
        i += 4 + slen
    if bsize is None:
        raise ValueError("missing BC subfield: not a BGZF block")
    # total = 12 (header) + xlen (extra) + cdata + 8 (crc+isize)
    cdata = f.read(bsize - xlen - 20)
    f.read(8)  # CRC32 + ISIZE
    data = zlib.decompress(cdata, wbits=-15)
    return data, bsize


class BgzfReader:
    """Random-access BGZF reader supporting virtual offsets."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._block_start = 0  # compressed offset of cached block
        self._block: bytes = b""
        self._within = 0
        self._load_block(0)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _load_block(self, coffset: int) -> bool:
        self._f.seek(coffset)
        self._block_start = coffset
        out = _read_block(self._f)
        if out is None:
            self._block = b""
            self._within = 0
            return False
        self._block, _ = out
        self._within = 0
        return True

    @property
    def virtual_offset(self) -> int:
        return (self._block_start << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset, within = voffset >> 16, voffset & 0xFFFF
        if coffset != self._block_start or within > len(self._block):
            self._load_block(coffset)
        self._within = within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._block) - self._within
            if avail == 0:
                next_off = self._f.tell()
                if not self._load_block(next_off):
                    break
                continue
            take = min(avail, n)
            out += self._block[self._within : self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def read_until_voffset(self, end_voffset: int) -> bytes:
        """Read from current position up to (but not past) a virtual offset."""
        out = bytearray()
        while self.virtual_offset < end_voffset:
            end_c, end_w = end_voffset >> 16, end_voffset & 0xFFFF
            if self._block_start == end_c:
                out += self._block[self._within : end_w]
                self._within = end_w
                break
            avail = self._block[self._within :]
            out += avail
            self._within = len(self._block)
            next_off = self._f.tell()
            if not self._load_block(next_off):
                break
        return bytes(out)


def decompress_all(path: str) -> bytes:
    """Decompress an entire bgzf/gzip file (handles concatenated members):
    the engine's libdeflate path, or zlib's member walk where the engine
    rejects the data."""
    from graphtyper_tpu_torch.io import native

    with open(path, "rb") as f:
        raw = f.read()
    out_native = native.bgzf_decompress(raw)
    if out_native is not None:
        return out_native
    out = []
    d = zlib.decompressobj(wbits=31)
    while raw:
        out.append(d.decompress(raw))
        raw = d.unused_data
        if raw:
            d = zlib.decompressobj(wbits=31)
        else:
            out.append(d.flush())
            if not d.eof:
                raise ValueError(f"truncated gzip/bgzf stream: {path}")
    return b"".join(out)


def bgzf_compress_bulk(data: bytes, level: int = -1, n_threads: int = 0) -> bytes:
    """Compress a whole buffer into BGZF members (64KB blocks) with the
    native threaded compressor (gt_bgzf_compress: libdeflate per block,
    std::thread fan-out — the native analog of the reference's bgzf writer
    threads, vcf.cpp open_for_writing). Does NOT append the EOF marker."""
    from graphtyper_tpu_torch.io.native import get_lib

    lib = get_lib()
    import ctypes

    import numpy as np

    if not getattr(lib, "_bgzfc_ready", False):
        lib.gt_bgzf_compress.restype = ctypes.c_int64
        lib.gt_bgzf_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._bgzfc_ready = True
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    inp = np.frombuffer(data, dtype=np.uint8)
    in_ptr = inp.ctypes.data_as(ctypes.c_void_p) if len(data) else None
    bound = lib.gt_bgzf_compress(in_ptr, len(data), level, n_threads, None, 0)
    out = np.zeros(bound, dtype=np.uint8)
    n = lib.gt_bgzf_compress(
        in_ptr, len(data), level, n_threads, out.ctypes.data_as(ctypes.c_void_p), bound
    )
    if n < 0:
        raise RuntimeError(f"gt_bgzf_compress returned {n} for a buffer of its own bound {bound}")
    return out[:n].tobytes()


def bgzf_block_coffsets(compressed: bytes) -> list[int]:
    """Physical start offset of each BGZF member in `compressed` (for
    translating uncompressed offsets into virtual offsets: block i covers
    uncompressed [i*0xFF00, (i+1)*0xFF00))."""
    out = []
    off = 0
    n = len(compressed)
    while off + 18 <= n:
        out.append(off)
        bsize = int.from_bytes(compressed[off + 16 : off + 18], "little") + 1
        off += bsize
    return out


def virtual_offset_of(u_offset: int, coffsets: list[int], total_compressed: int) -> int:
    """(uncompressed offset) -> BGZF virtual offset, given 0xFF00 blocking."""
    b = u_offset // 0xFF00
    if b < len(coffsets):
        return (coffsets[b] << 16) | (u_offset % 0xFF00)
    return total_compressed << 16


class ThreadedBgzfWriter:
    """Bounded-memory BGZF writer over the native threaded compressor:
    uncompressed bytes accumulate and full 64KB-aligned chunks are
    compressed (multi-threaded libdeflate) and written incrementally.
    Virtual offsets are resolved from uncompressed offsets via
    `virtual_offset_of` once the covering block has been flushed (always
    true after close) — callers record uncompressed offsets while writing
    and translate when building the index."""

    FLUSH_BLOCKS = 256  # compress in ~16MB batches

    def __init__(self, path: str, level: int | None = None, n_threads: int = 0):
        if level is None:
            # --bgzf_compression_level (options.hpp:90; popvcf encoding
            # defaults it to 9, main.cpp:444)
            from graphtyper_tpu_torch.config import current_options

            level = getattr(current_options(), "bgzf_compression_level", -1)
        self._f = open(path, "wb")
        self._level = level
        self._threads = n_threads
        self._buf = bytearray()
        self._coffsets: list[int] = []
        self._block_us: list[int] = []  # uncompressed start per block
        self._compressed_total = 0
        self._u_total = 0
        self._flushed_u = 0
        self.closed = False

    @property
    def u_offset(self) -> int:
        """Total uncompressed bytes written so far."""
        return self._u_total

    def write(self, data: bytes) -> int:
        self._buf += data
        self._u_total += len(data)
        limit = self.FLUSH_BLOCKS * 0xFF00
        while len(self._buf) >= limit:
            self._flush(limit)
        return len(data)

    def hard_boundary(self, new_level: int | None = None) -> int:
        """Flush everything buffered so the next byte starts a fresh BGZF
        block (vcf.cpp:700-749 uncompressed_sample_names mode needs the
        sample-name bytes as standalone blocks at a chosen level). Returns
        the compressed size so far; optionally switches the compression
        level for subsequent blocks."""
        if self._buf:
            self._flush(len(self._buf))
        if new_level is not None:
            self._level = new_level
        return self._compressed_total

    def _flush(self, n_bytes: int) -> None:
        chunk = bytes(self._buf[:n_bytes])
        del self._buf[:n_bytes]
        compressed = bgzf_compress_bulk(chunk, self._level, self._threads)
        for i_block, off in enumerate(bgzf_block_coffsets(compressed)):
            self._coffsets.append(self._compressed_total + off)
            self._block_us.append(self._flushed_u + i_block * 0xFF00)
        self._flushed_u += n_bytes
        self._compressed_total += len(compressed)
        self._f.write(compressed)

    def virtual_offset_of(self, u_offset: int) -> int:
        # blocks are 0xFF00-aligned between hard boundaries; bisect handles
        # the short blocks a boundary leaves behind
        import bisect

        if not self._block_us or u_offset >= self._flushed_u:
            return self._compressed_total << 16
        b = bisect.bisect_right(self._block_us, u_offset) - 1
        return (self._coffsets[b] << 16) | (u_offset - self._block_us[b])

    def close(self) -> None:
        if self.closed:
            return
        if self._buf:
            self._flush(len(self._buf))
        self._f.write(BGZF_EOF)
        self._f.close()
        self.closed = True


class BgzfWriter(io.RawIOBase):
    """Streaming BGZF writer (multi-block, with EOF marker).

    compresslevel matches the reference default bgzf_compression_level=-1
    (zlib default, options.hpp:40).
    """

    def __init__(self, path_or_file, compresslevel: int | None = None):
        if compresslevel is None:
            from graphtyper_tpu_torch.config import current_options

            compresslevel = getattr(current_options(), "bgzf_compression_level", -1)
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f = open(path_or_file, "wb")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        self._level = compresslevel if compresslevel >= 0 else 6
        self._buf = bytearray()

    def writable(self):
        return True

    def write(self, data) -> int:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]
        return len(data)

    def _flush_block(self, data: bytes) -> None:
        c = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = c.compress(bytes(data)) + c.flush()
        bsize_field = len(cdata) + 26 - 1  # total = cdata + header(12)+extra(6)+footer(8); BSIZE = total-1
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize_field)
        )
        footer = struct.pack("<II", zlib.crc32(bytes(data)) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
        self._f.write(header + cdata + footer)

    @property
    def virtual_offset(self) -> int:
        """Virtual offset of the next byte to be written."""
        return (self._f.tell() << 16) | len(self._buf)

    def flush_current(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()

    def close(self):
        if self.closed:
            return
        self.flush_current()
        self._f.write(BGZF_EOF)
        if self._owns:
            self._f.close()
        else:
            self._f.flush()
        super().close()
