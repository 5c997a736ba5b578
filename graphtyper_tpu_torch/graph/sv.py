"""Structural variant model (reference: include/graphtyper/graph/sv.hpp,
src/graph/sv.cpp parsing side; breakpoint-graph construction lives in
graph/build_sv.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class SVType(IntEnum):
    DEL = 0
    DEL_ALU = 1
    DUP = 2
    INS = 3
    INS_ALU = 4
    INV = 5
    BND = 6
    OTHER = 7
    NOT_SV = 8


SVTYPE_NAMES = {
    SVType.DEL: "DEL",
    SVType.DEL_ALU: "DEL:ME:ALU",
    SVType.DUP: "DUP",
    SVType.INS: "INS",
    SVType.INS_ALU: "INS:ME:ALU",
    SVType.INV: "INV",
    SVType.BND: "BND",
    SVType.OTHER: "OTHER",
}


def parse_sv_type(val: str) -> SVType:
    if val.startswith("DEL:ME:ALU"):
        return SVType.DEL_ALU
    if val.startswith("DEL"):
        return SVType.DEL
    if val.startswith("DUP"):
        return SVType.DUP
    if val.startswith("INS:ME:ALU"):
        return SVType.INS_ALU
    if val.startswith("INS"):
        return SVType.INS
    if val.startswith("INV"):
        return SVType.INV
    if val.startswith("BND"):
        return SVType.BND
    return SVType.OTHER


class SVModel(IntEnum):
    AGGREGATED = 0
    BREAKPOINT1 = 1
    BREAKPOINT2 = 2
    COVERAGE = 3


SV_MODEL_NAMES = {
    SVModel.AGGREGATED: "AGGREGATED",
    SVModel.BREAKPOINT1: "BREAKPOINT1",
    SVModel.BREAKPOINT2: "BREAKPOINT2",
    SVModel.COVERAGE: "COVERAGE",
}


@dataclass
class SV:
    type: SVType = SVType.NOT_SV
    chrom: str = ""
    begin: int = 0  # 1-based
    length: int = 0
    size: int = 0
    end: int = 0
    n_clusters: int = 0
    num_merged_svs: int = -1
    or_start: int = -1
    or_end: int = -1
    related_sv: int = -1
    inv_type: str = ""  # INV3 / INV5 / both
    seq: bytes = b""
    ins_seq: bytes = b""
    ins_seq_left: bytes = b""
    ins_seq_right: bytes = b""
    model: str = "AGGREGATED"
    old_variant_id: str = ""
    original_alt: bytes = b""

    def to_dict(self) -> dict:
        return {
            "type": int(self.type),
            "chrom": self.chrom,
            "begin": self.begin,
            "length": self.length,
            "size": self.size,
            "end": self.end,
            "n_clusters": self.n_clusters,
            "num_merged_svs": self.num_merged_svs,
            "or_start": self.or_start,
            "or_end": self.or_end,
            "related_sv": self.related_sv,
            "inv_type": self.inv_type,
            "seq": self.seq.decode(),
            "ins_seq": self.ins_seq.decode(),
            "ins_seq_left": self.ins_seq_left.decode(),
            "ins_seq_right": self.ins_seq_right.decode(),
            "model": self.model,
            "old_variant_id": self.old_variant_id,
            "original_alt": self.original_alt.decode(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SV":
        sv = cls()
        sv.type = SVType(d["type"])
        sv.chrom = d["chrom"]
        sv.begin = d["begin"]
        sv.length = d["length"]
        sv.size = d["size"]
        sv.end = d["end"]
        sv.n_clusters = d["n_clusters"]
        sv.num_merged_svs = d["num_merged_svs"]
        sv.or_start = d["or_start"]
        sv.or_end = d["or_end"]
        sv.related_sv = d["related_sv"]
        sv.inv_type = d["inv_type"]
        sv.seq = d["seq"].encode()
        sv.ins_seq = d["ins_seq"].encode()
        sv.ins_seq_left = d["ins_seq_left"].encode()
        sv.ins_seq_right = d["ins_seq_right"].encode()
        sv.model = d["model"]
        sv.old_variant_id = d["old_variant_id"]
        sv.original_alt = d["original_alt"].encode()
        return sv

    def get_type_name(self) -> str:
        return SVTYPE_NAMES.get(self.type, "OTHER")
