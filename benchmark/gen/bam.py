"""BAM, BGZF, BAI and FASTA writers on arrays.

The records of a sample are laid out in one byte buffer by NumPy (fixed
fields as a structured array, the cigars grouped by their length), cut
into 0xff00-byte BGZF blocks that a thread pool deflates, and indexed
from the same record offsets: the SAM specification's bins and 16 kb
linear index, as `samtools index` writes them. Nothing here imports the
port.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from benchmark.gen.model import Reads

BLOCK_DATA = 0xFF00
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
# base -> 4-bit BAM code ("=ACMGRSVTWYHKDBN")
NIBBLE = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    NIBBLE[_b] = _i

_FIXED = np.dtype([
    ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"), ("l_read_name", "u1"), ("mapq", "u1"),
    ("bin", "<u2"), ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"), ("next_ref_id", "<i4"),
    ("next_pos", "<i4"), ("tlen", "<i4"),
])


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM specification's bin of each [beg, end)."""
    e = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def write_fasta(path: str, contigs: list[tuple[str, np.ndarray]]) -> None:
    """FASTA with 70 bases a line, and its .fai."""
    fai = []
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">" + name.encode() + b"\n")
            offset = f.tell()
            n = len(seq)
            full = n // 70
            body = seq[: full * 70].reshape(full, 70)
            lines = np.concatenate([body, np.full((full, 1), ord("\n"), dtype=np.uint8)], axis=1)
            f.write(lines.tobytes())
            if n % 70:
                f.write(seq[full * 70 :].tobytes() + b"\n")
            fai.append(f"{name}\t{n}\t{offset}\t70\t71\n")
    with open(path + ".fai", "w") as f:
        f.write("".join(fai))


def encode_records(reads: Reads, sample: str, ref_id: int = 0, mapq: int = 60) -> tuple[bytes, np.ndarray]:
    """The BAM record bytes of `reads`, and each record's start offset in
    them (plus the end as a last entry). Records with the same number of
    cigar operations have one size: each such group is laid out as a
    matrix, column by column, and the file order is a concatenation of
    runs of consecutive rows of these matrices."""
    n, L = reads.seq.shape
    prefix = np.frombuffer(f"{sample}_r".encode(), dtype=np.uint8)
    digits = ((reads.pair[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + 48).astype(np.uint8)
    name_len = len(prefix) + 9 + 1
    tag = np.frombuffer(b"RGZrg_" + sample.encode() + b"\x00", dtype=np.uint8)
    n_cigar = np.array([len(c) for c in reads.cigars], dtype=np.int64)
    seq_bytes = (L + 1) // 2
    size = 36 + name_len + 4 * n_cigar + seq_bytes + L + len(tag)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(size, out=starts[1:])
    fixed = np.zeros(n, dtype=_FIXED)
    fixed["block_size"] = size - 4
    fixed["ref_id"] = ref_id if reads.ref_id is None else reads.ref_id
    fixed["pos"] = reads.pos
    fixed["l_read_name"] = name_len
    fixed["mapq"] = mapq if reads.mapq is None else reads.mapq
    fixed["bin"] = reg2bin(reads.pos, reads.end)
    fixed["n_cigar"] = n_cigar
    fixed["flag"] = reads.flag
    fixed["l_seq"] = L
    fixed["next_ref_id"] = ref_id if reads.next_ref_id is None else reads.next_ref_id
    fixed["next_pos"] = reads.mate_pos
    fixed["tlen"] = reads.tlen
    fixed_b = fixed.view(np.uint8).reshape(n, 36)
    nib = NIBBLE[reads.seq]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), dtype=np.uint8)], axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    groups, group_of = np.unique(n_cigar, return_inverse=True)
    mats, rank = [], np.empty(n, dtype=np.int64)
    for g, nc in enumerate(groups.tolist()):
        sel = np.flatnonzero(group_of == g)
        rank[sel] = np.arange(len(sel))
        m = np.empty((len(sel), int(size[sel[0]])), dtype=np.uint8)
        c = 0
        for part in (fixed_b[sel], np.broadcast_to(prefix, (len(sel), len(prefix))), digits[sel],
                     np.zeros((len(sel), 1), dtype=np.uint8),
                     np.stack([reads.cigars[i] for i in sel]).astype("<u4").view(np.uint8),
                     packed[sel], reads.qual[sel], np.broadcast_to(tag, (len(sel), len(tag)))):
            m[:, c : c + part.shape[1]] = part
            c += part.shape[1]
        mats.append(m)
    cut = np.flatnonzero(group_of[1:] != group_of[:-1]) + 1
    first = np.concatenate([[0], cut])
    last = np.concatenate([cut, [n]])
    parts = [mats[group_of[a]][rank[a] : rank[a] + (b - a)].reshape(-1) for a, b in zip(first.tolist(), last.tolist())]
    return np.concatenate(parts).tobytes() if parts else b"", starts


def _deflate(data: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = c.compress(data) + c.flush()
    header = struct.pack("<4BI2BH2BHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2, len(cdata) + 25)
    return header + cdata + struct.pack("<II", zlib.crc32(data), len(data))


def bgzf_blocks(data: bytes, level: int) -> tuple[list, np.ndarray]:
    """`data` cut into BLOCK_DATA-byte blocks and deflated; returns the
    blocks and each block's compressed offset (plus the total)."""
    pieces = [data[i : i + BLOCK_DATA] for i in range(0, len(data), BLOCK_DATA)]
    blocks = [_deflate(p, level) for p in pieces]
    coff = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blocks], out=coff[1:])
    return blocks, coff


def write_bam(path: str, contig: str, contig_len: int, sample: str, reads: Reads, mapq: int = 60,
              level: int = 1) -> None:
    """`<path>` and `<path>.bai`: one contig, one read group."""
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{contig_len}\n"
            f"@RG\tID:rg_{sample}\tSM:{sample}\n").encode()
    nm = contig.encode() + b"\x00"
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<ii", 1, len(nm)) + nm + \
        struct.pack("<i", contig_len)
    body, starts = encode_records(reads, sample, mapq=mapq)
    data = head + body
    blocks, coff = bgzf_blocks(data, level)
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b)
        f.write(EOF_BLOCK)
    u = starts + len(head)
    blk = u // BLOCK_DATA
    voff = (coff[blk] << 16) | (u - blk * BLOCK_DATA)
    # records with no place (ref_id -1) come last and are only counted
    placed = len(reads) if reads.ref_id is None else int((reads.ref_id >= 0).sum())
    with open(path + ".bai", "wb") as f:
        f.write(bai_bytes(reads.pos[:placed], reads.end[:placed], voff[: placed + 1], len(reads) - placed))


def bai_bytes(pos: np.ndarray, end: np.ndarray, voff: np.ndarray, n_no_coor: int = 0) -> bytes:
    """The BAI of one sorted contig: `voff` holds each record's virtual
    offset and the end of the last one. Consecutive records of one bin
    form one chunk. `n_no_coor` records with no place follow them."""
    n = len(pos)
    bins = reg2bin(pos, end)
    out = bytearray(b"BAI\x01" + struct.pack("<i", 1))
    if n:
        cut = np.flatnonzero(bins[1:] != bins[:-1]) + 1
        first = np.concatenate([[0], cut])
        last = np.concatenate([cut, [n]])
        chunk_bin = bins[first]
        order = np.argsort(chunk_bin, kind="stable")
        ub, counts = np.unique(chunk_bin, return_counts=True)
        out += struct.pack("<i", len(ub))
        i = 0
        for b, c in zip(ub.tolist(), counts.tolist()):
            sel = order[i : i + c]
            i += c
            out += struct.pack("<Ii", b, c)
            out += np.stack([voff[first[sel]], voff[last[sel]]], axis=1).astype("<u8").tobytes()
        w0 = pos >> 14
        w1 = (end - 1) >> 14
        n_win = int(w1.max()) + 1
        lin = np.full(n_win, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(lin, w0, voff[:-1])
        np.minimum.at(lin, w1, voff[:-1])
        # an empty window takes the next window's offset
        for w in range(n_win - 2, -1, -1):
            if lin[w] == np.iinfo(np.int64).max:
                lin[w] = lin[w + 1]
        out += struct.pack("<i", n_win) + lin.astype("<u8").tobytes()
    else:
        out += struct.pack("<ii", 0, 0)
    out += struct.pack("<Q", n_no_coor)
    return bytes(out)
