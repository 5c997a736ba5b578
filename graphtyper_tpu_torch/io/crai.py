"""CRAI (CRAM index) write / read / query.

htslib's `.crai` is gzip-compressed text, one line per slice:
    seq_id  alignment_start  alignment_span  container_offset  slice_offset  slice_size
where container_offset is the absolute byte offset of the container header,
slice_offset is the slice's landmark (byte offset of its header block
relative to the end of the container header), and slice_size spans the
slice's blocks. Our in-memory reader does container-granular region skips
straight off the container headers (io/cram.py records(region=...)), so the
.crai exists for ecosystem interop — samtools can read our indexes and we
can serve region queries from theirs.

Reference analog: htslib cram_index.c (the reference consumes it through
sam_itr_querys in src/utilities/hts_reader.cpp).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

from graphtyper_tpu_torch.io.cram import ByteReader, read_block, read_container_header, read_slice_header

MAPPED_SLICE = 2


@dataclass
class CraiEntry:
    seq_id: int
    start: int  # 1-based alignment start
    span: int
    container_offset: int
    slice_offset: int
    slice_size: int


def write_crai(cram_path: str, crai_path: str | None = None) -> str:
    with open(cram_path, "rb") as f:
        data = f.read()
    if data[:4] != b"CRAM":
        raise ValueError(f"not a CRAM: {cram_path}")
    major = data[4]
    br = ByteReader(data, 26)
    # skip the SAM-header container
    hdr = read_container_header(br, major)
    br.pos += hdr.length
    entries: list[CraiEntry] = []
    while not br.eof():
        c_off = br.pos
        hdr = read_container_header(br, major)
        payload_start = br.pos
        payload_end = payload_start + hdr.length
        if hdr.ref_id == -1 and hdr.start == 4542278:
            break  # EOF container
        if hdr.n_records == 0 and hdr.n_blocks == 0:
            br.pos = payload_end
            continue
        read_block(br, major)  # compression header
        lm = list(hdr.landmarks)
        for i, l0 in enumerate(lm):
            s_pos = payload_start + l0
            sbr = ByteReader(data, s_pos)
            slice_block = read_block(sbr, major)
            if slice_block.content_type != MAPPED_SLICE:
                continue
            sh = read_slice_header(slice_block.data, major)
            size = (lm[i + 1] if i + 1 < len(lm) else hdr.length) - l0
            entries.append(CraiEntry(sh.ref_id, sh.start, sh.span, c_off, l0, size))
        br.pos = payload_end
    if crai_path is None:
        crai_path = cram_path + ".crai"
    body = "".join(
        f"{e.seq_id}\t{e.start}\t{e.span}\t{e.container_offset}\t{e.slice_offset}\t{e.slice_size}\n"
        for e in entries
    )
    with open(crai_path, "wb") as f:
        f.write(gzip.compress(body.encode(), mtime=0))
    return crai_path


def read_crai(path: str) -> list[CraiEntry]:
    with gzip.open(path, "rt") as f:
        out = []
        for line in f:
            t = line.split("\t")
            if len(t) != 6:
                continue
            out.append(CraiEntry(int(t[0]), int(t[1]), int(t[2]), int(t[3]), int(t[4]), int(t[5])))
    return out


def crai_query(entries: list[CraiEntry], seq_id: int, beg: int, end: int) -> list[CraiEntry]:
    """Slices overlapping 0-based half-open [beg, end) on seq_id."""
    out = []
    for e in entries:
        if e.seq_id != seq_id and e.seq_id != -2:
            continue
        if e.seq_id == -2:
            out.append(e)  # multi-ref slice: always a candidate
            continue
        s0 = e.start - 1
        if s0 + e.span > beg and s0 < end:
            out.append(e)
    return out
