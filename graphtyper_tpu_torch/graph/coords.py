"""Genomic coordinate model: contigs, absolute positions, regions.

Semantics mirror the reference (src/graph/absolute_position.cpp,
src/graph/genomic_region.cpp): a single linear "absolute" coordinate over the
concatenated contigs, computed from per-contig offsets; regions are parsed
from "chr:begin-end" strings with 1-based inclusive input converted to
0-based half-open internally (begin is decremented, genomic_region.cpp:105).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from graphtyper_tpu_torch.constants import AS_LONG_AS_POSSIBLE, SPECIAL_START


@dataclass(frozen=True)
class Contig:
    name: str
    length: int


class AbsolutePosition:
    """chromosome+pos <-> single linear coordinate (absolute_position.cpp:18-76)."""

    def __init__(self, contigs: list[Contig] | None = None):
        self.offsets: list[int] = []
        self.contigs: list[Contig] = []
        self.chromosome_to_offset: dict[str, int] = {}
        if contigs:
            self.calculate_offsets(contigs)

    def calculate_offsets(self, contigs: list[Contig]) -> None:
        if not contigs or len(contigs) == len(self.offsets):
            return
        self.contigs = list(contigs)
        self.offsets = [0]
        self.chromosome_to_offset = {contigs[0].name: 0}
        for i in range(1, len(contigs)):
            off = self.offsets[i - 1] + contigs[i - 1].length
            self.offsets.append(off)
            self.chromosome_to_offset[contigs[i].name] = off

    def is_contig_available(self, contig: str) -> bool:
        return contig in self.chromosome_to_offset

    def get_absolute_position(self, chromosome: str, contig_position: int) -> int:
        return self.chromosome_to_offset[chromosome] + contig_position

    def get_contig_position(self, absolute_position: int) -> tuple[str, int]:
        i = bisect.bisect_left(self.offsets, absolute_position)
        assert i > 0
        return self.contigs[i - 1].name, absolute_position - self.offsets[i - 1]


@dataclass
class GenomicRegion:
    """A region "chr:begin-end"; begin is 0-based internally, end exclusive-ish
    (matches reference: input 1-based begin is decremented)."""

    chr: str = "N/A"
    begin: int = 0
    end: int = AS_LONG_AS_POSSIBLE

    @classmethod
    def parse(cls, region: str) -> "GenomicRegion":
        if not region or region == ".":
            return cls()
        if ":" not in region:
            return cls(chr=region)
        chrom, _, rest = region.partition(":")
        if "-" not in rest:
            begin = int(rest)
            end = AS_LONG_AS_POSSIBLE
        else:
            b, _, e = rest.partition("-")
            begin, end = int(b), int(e)
        if begin != 0:
            begin -= 1  # to 0-based
        return cls(chr=chrom, begin=begin, end=end)

    @classmethod
    def make(cls, chrom: str, begin: int, end: int) -> "GenomicRegion":
        """1-based begin/end constructor (genomic_region.cpp:112-121)."""
        if begin != 0:
            begin -= 1
        return cls(chr=chrom, begin=begin, end=end)

    def pad(self, bases: int) -> None:
        self.begin = max(self.begin - bases, 0)
        self.end += bases

    def pad_end(self, bases: int) -> None:
        self.end += bases

    def to_string(self) -> str:
        if self.end == AS_LONG_AS_POSSIBLE:
            return f"{self.chr}:{self.begin + 1}"
        return f"{self.chr}:{self.begin + 1}-{self.end}"

    def to_file_string(self) -> str:
        return f"{self.chr}/{self.begin + 1:09d}-{self.end:09d}"

    def get_absolute_begin_position(self, abs_pos: AbsolutePosition) -> int:
        return abs_pos.get_absolute_position(self.chr, self.begin + 1)

    def get_absolute_end_position(self, abs_pos: AbsolutePosition) -> int:
        return abs_pos.get_absolute_position(self.chr, self.end + 1)


def is_special(pos: int) -> bool:
    return pos >= SPECIAL_START


def split_region(region: GenomicRegion, max_size: int, slack_frac: float = 0.1) -> list[GenomicRegion]:
    """Split a region into chunks of <= max_size with 10% slack
    (main.cpp:30-58 add_region): a chunk slightly larger than max_size is kept
    whole if within slack.
    """
    out: list[GenomicRegion] = []
    begin = region.begin
    end = region.end
    while begin < end:
        remaining = end - begin
        if remaining <= max_size * (1.0 + slack_frac):
            out.append(GenomicRegion(region.chr, begin, end))
            break
        out.append(GenomicRegion(region.chr, begin, begin + max_size))
        begin += max_size
    return out
