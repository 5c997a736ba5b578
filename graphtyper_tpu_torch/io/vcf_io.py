"""VCF text reader (replaces SeqAn VcfRecord parsing in constructor.cpp).

Handles plain, gzip/bgzf, and tabix-region reads. Produces lightweight
records; the typer's own Vcf model (typer/vcf_record.py) is used for output.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from graphtyper_tpu_torch.io.bgzf import decompress_all, is_bgzf
from graphtyper_tpu_torch.io.tabix import read_region_lines


@dataclass
class VcfTextRecord:
    chrom: str
    pos: int  # 0-based
    id: str
    ref: str
    alts: list[str]
    qual: str = "."
    filter: str = "."
    info: str = "."
    format: str = ""
    samples: list[str] = field(default_factory=list)

    def info_dict(self) -> dict[str, str]:
        out: dict[str, str] = {}
        if self.info in (".", ""):
            return out
        for kv in self.info.split(";"):
            if "=" in kv:
                k, _, v = kv.partition("=")
                out[k] = v
            else:
                out[kv] = ""
        return out


def _parse_line(line: str) -> VcfTextRecord | None:
    if not line or line.startswith("#"):
        return None
    f = line.rstrip("\n").split("\t")
    if len(f) < 8:
        f = f + ["."] * (8 - len(f))
    alts = [] if f[4] in (".", "") else f[4].split(",")
    return VcfTextRecord(
        chrom=f[0],
        pos=int(f[1]) - 1,
        id=f[2],
        ref=f[3],
        alts=alts,
        qual=f[5] if len(f) > 5 else ".",
        filter=f[6] if len(f) > 6 else ".",
        info=f[7] if len(f) > 7 else ".",
        format=f[8] if len(f) > 8 else "",
        samples=f[9:] if len(f) > 9 else [],
    )


def _read_all_text(path: str) -> str:
    if path.endswith(".gz") or is_bgzf(path):
        return decompress_all(path).decode()
    with open(path) as f:
        return f.read()


class VcfReader:
    def __init__(self, path: str):
        self.path = path
        self.header_lines: list[str] = []
        self.sample_names: list[str] = []

    def _consume_header(self, lines: list[str]) -> list[str]:
        body = []
        for line in lines:
            if line.startswith("##"):
                self.header_lines.append(line)
            elif line.startswith("#CHROM"):
                self.header_lines.append(line)
                fields = line.split("\t")
                self.sample_names = fields[9:] if len(fields) > 9 else []
            elif line:
                body.append(line)
        return body

    def read_all(self) -> list[VcfTextRecord]:
        lines = _read_all_text(self.path).split("\n")
        body = self._consume_header(lines)
        return [r for r in (_parse_line(x) for x in body) if r is not None]

    def read_region(self, contig: str, beg: int, end: int) -> list[VcfTextRecord]:
        """Records overlapping 0-based [beg, end). Uses .tbi when available,
        else scans the whole file (fine for test-scale data)."""
        tbi = self.path + ".tbi"
        if not os.path.exists(tbi) and os.path.exists(self.path + ".csi"):
            tbi = self.path + ".csi"
        if os.path.exists(tbi) and (self.path.endswith(".gz") or is_bgzf(self.path)):
            # read header separately for sample names
            if not self.header_lines:
                header = []
                for line in _read_all_text(self.path).split("\n"):
                    if line.startswith("#"):
                        header.append(line)
                    else:
                        break
                self._consume_header(header)
            lines = read_region_lines(self.path, tbi, contig, beg, end)
            recs = [r for r in (_parse_line(x) for x in lines) if r is not None]
        else:
            recs = self.read_all()
        out = []
        for r in recs:
            if r.chrom != contig:
                continue
            if r.pos >= end:
                continue
            if r.pos + len(r.ref) <= beg and r.pos < beg:
                # keep records that start before but reach into the region is
                # NOT reference behavior: tabix returns overlap, constructor
                # then filters rec.pos < region.begin (graph.cpp:68). We keep
                # overlap here; the graph builder applies its own filter.
                pass
            out.append(r)
        return out
