"""FASTA + .fai reader (replaces SeqAn FaiIndex usage, constructor.cpp:176).

The .fai format: name, length, offset, linebases, linewidth per line.
"""

from __future__ import annotations

import os

import numpy as np

from graphtyper_tpu_torch.graph.coords import Contig


class FastaFile:
    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path, fai)
        self.index: dict[str, tuple[int, int, int, int]] = {}
        self.contigs: list[Contig] = []
        with open(fai) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 5:
                    continue
                name, length, offset, linebases, linewidth = (
                    fields[0],
                    int(fields[1]),
                    int(fields[2]),
                    int(fields[3]),
                    int(fields[4]),
                )
                self.index[name] = (length, offset, linebases, linewidth)
                self.contigs.append(Contig(name, length))
        self._f = open(path, "rb")

    def close(self):
        self._f.close()

    def has_contig(self, name: str) -> bool:
        return name in self.index

    def contig_length(self, name: str) -> int:
        return self.index[name][0]

    def fetch(self, name: str, start: int = 0, end: int | None = None) -> bytes:
        """0-based half-open slice of a contig, uppercase ASCII."""
        if name not in self.index:
            raise ValueError(
                f"Contig {name!r} not found in reference FASTA (have: "
                + ", ".join(list(self.index)[:8])
                + ("..." if len(self.index) > 8 else "")
                + ")"
            )
        length, offset, linebases, linewidth = self.index[name]
        start = max(0, start)
        end = length if end is None else min(end, length)
        if end <= start:
            return b""
        first_line = start // linebases
        first_col = start % linebases
        byte_start = offset + first_line * linewidth + first_col
        last_line = (end - 1) // linebases
        last_col = (end - 1) % linebases
        byte_end = offset + last_line * linewidth + last_col + 1
        self._f.seek(byte_start)
        raw = self._f.read(byte_end - byte_start)
        arr = np.frombuffer(raw, dtype=np.uint8)
        keep = (arr != 10) & (arr != 13)  # strip newlines
        seq = arr[keep]
        # uppercase in-place (a-z -> A-Z)
        lower = (seq >= 97) & (seq <= 122)
        seq = np.where(lower, seq - 32, seq).astype(np.uint8)
        return seq.tobytes()


def build_fai(path: str, out_path: str | None = None) -> None:
    """Generate a .fai index for an uncompressed FASTA."""
    entries = []
    with open(path, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        while True:
            line_start = f.tell()
            line = f.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = f.tell()
                first_line = True
            elif name is not None and line.strip():
                stripped = line.rstrip(b"\r\n")
                if first_line:
                    linebases = len(stripped)
                    linewidth = len(line)
                    first_line = False
                length += len(stripped)
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    with open(out_path or path + ".fai", "w") as out:
        for e in entries:
            out.write("\t".join(str(x) for x in e) + "\n")
