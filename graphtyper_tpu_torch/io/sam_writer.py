"""SAM/BAM writer for preprocessed (bamshrunk) reads.

Replaces htslib's BamFileOut usage in bamshrink (bamshrink.cpp writes temp
BAMs). We emit SAM (or bgzf-compressed SAM) — our own readers and the rest
of the pipeline consume either.
"""

from __future__ import annotations

from graphtyper_tpu_torch.io.bam import CIGAR_OPS, AlignedRead, BamHeader


def _cigar_str(cigar) -> str:
    if not cigar:
        return "*"
    return "".join(f"{cnt}{CIGAR_OPS[op]}" for op, cnt in cigar)


def record_to_sam_line(read: AlignedRead, ref_names: list[str]) -> str:
    rname = ref_names[read.ref_id] if 0 <= read.ref_id < len(ref_names) else "*"
    if read.mate_ref_id == read.ref_id and read.ref_id >= 0:
        rnext = "="
    elif 0 <= read.mate_ref_id < len(ref_names):
        rnext = ref_names[read.mate_ref_id]
    else:
        rnext = "*"
    qual = "*" if read.qual is None or len(read.qual) == 0 else "".join(chr(q + 33) for q in read.qual)
    fields = [
        read.name,
        str(read.flag),
        rname,
        str(read.pos + 1),
        str(read.mapq),
        _cigar_str(read.cigar),
        rnext,
        str(read.mate_pos + 1),
        str(read.tlen),
        read.seq.decode() if read.seq else "*",
        qual,
    ]
    for tag, val in read.tags.items():
        if isinstance(val, int):
            fields.append(f"{tag}:i:{val}")
        elif isinstance(val, float):
            fields.append(f"{tag}:f:{val}")
        else:
            fields.append(f"{tag}:Z:{val}")
    return "\t".join(fields)


def write_sam(path: str, header: BamHeader, reads: list[AlignedRead]) -> None:
    lines = []
    if header.text:
        lines.extend(l for l in header.text.split("\n") if l)
    else:
        lines.append("@HD\tVN:1.6\tSO:coordinate")
        for name, length in zip(header.ref_names, header.ref_lengths):
            lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    for r in reads:
        lines.append(record_to_sam_line(r, header.ref_names))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
