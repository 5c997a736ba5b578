"""BAM writer: serialize AlignedRead records into BGZF-compressed BAM.

Completes the htslib-replacement surface (the reference writes temp BAMs in
bamshrink); also used to generate BAM fixtures for the native decoder tests.
"""

from __future__ import annotations

import struct

import numpy as np

from graphtyper_tpu_torch.io.bam import AlignedRead, BamHeader
from graphtyper_tpu_torch.io.bgzf import BgzfWriter

_SEQ2NIB = {b: i for i, b in enumerate(b"=ACMGRSVTWYHKDBN")}
_SEQ2NIB_ARR = np.full(256, 15, dtype=np.uint8)
for _b, _i in _SEQ2NIB.items():
    _SEQ2NIB_ARR[_b] = _i


def _encode_record(r: AlignedRead) -> bytes:
    name = r.name.encode() + b"\x00"
    if r.cigar:
        cig = np.fromiter(((cnt << 4) | op for op, cnt in r.cigar), dtype=np.uint32)
        cigar = cig.tobytes()
    else:
        cigar = b""
    l_seq = len(r.seq)
    # vectorized 4-bit packing (hi nibble = even positions)
    v = _SEQ2NIB_ARR[np.frombuffer(r.seq, dtype=np.uint8)]
    if l_seq % 2:
        v = np.concatenate([v, np.zeros(1, dtype=np.uint8)])
    nib = ((v[0::2] << 4) | v[1::2]).astype(np.uint8).tobytes()
    qual = (
        np.asarray(r.qual, dtype=np.uint8).tobytes()
        if r.qual is not None and len(r.qual)
        else b"\xff" * l_seq
    )
    tags = b""
    for tag, val in r.tags.items():
        if isinstance(val, int):
            tags += tag.encode() + b"i" + struct.pack("<i", val)
        elif isinstance(val, str):
            tags += tag.encode() + b"Z" + val.encode() + b"\x00"
    body = (
        struct.pack(
            "<iiBBHHHiiii",
            r.ref_id,
            r.pos,
            len(name),
            r.mapq,
            0,  # bin (unused by our readers)
            len(r.cigar),
            r.flag,
            l_seq,
            r.mate_ref_id,
            r.mate_pos,
            r.tlen,
        )
        + name
        + cigar
        + nib
        + qual
        + tags
    )
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, header: BamHeader, reads: list[AlignedRead]) -> None:
    from graphtyper_tpu_torch.io.bgzf import ThreadedBgzfWriter

    w = ThreadedBgzfWriter(path)
    text = header.text or "@HD\tVN:1.6\tSO:coordinate\n"
    if not text.endswith("\n"):
        text += "\n"
    w.write(b"BAM\x01")
    w.write(struct.pack("<i", len(text)))
    w.write(text.encode())
    w.write(struct.pack("<i", len(header.ref_names)))
    for name, length in zip(header.ref_names, header.ref_lengths):
        nm = name.encode() + b"\x00"
        w.write(struct.pack("<i", len(nm)) + nm + struct.pack("<i", length))
    for r in reads:
        w.write(_encode_record(r))
    w.close()
