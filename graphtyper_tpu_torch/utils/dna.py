"""DNA sequence encoding utilities.

Sequences are represented as numpy uint8 code arrays (A=0 C=1 G=2 T=3, N=4,
other IUPAC codes >4) for host work, and packed into 2-bit uint64 k-mers for
the device index (reference semantics: type_conversions.cpp to_uint64).
"""

from __future__ import annotations

import numpy as np

# Byte → code lookup. Each IUPAC ambiguity letter gets its own id >= 4 so the
# k-mer packer can fork exactly its base set (to_uint64_vec semantics,
# type_conversions.cpp IUPAC expansion: W forks 2 ways, B forks 3, N forks 4).
# Codes >= 4 act like N everywhere else (mismatch counting, SW, index walks).
_CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
    _CODE[ord(chr(b).lower())] = i
_CODE[ord("U")] = _CODE[ord("u")] = 3
_IUPAC_LETTERS = "NRYSWKMBDHV"  # codes 4..14
for i, ch in enumerate(_IUPAC_LETTERS):
    _CODE[ord(ch)] = 4 + i
    _CODE[ord(ch.lower())] = 4 + i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# IUPAC expansion sets (which of A,C,G,T each byte may represent)
IUPAC = {
    ord("A"): (0,), ord("C"): (1,), ord("G"): (2,), ord("T"): (3,),
    ord("U"): (3,),
    ord("R"): (0, 2), ord("Y"): (1, 3), ord("S"): (1, 2), ord("W"): (0, 3),
    ord("K"): (2, 3), ord("M"): (0, 1),
    ord("B"): (1, 2, 3), ord("D"): (0, 2, 3), ord("H"): (0, 1, 3),
    ord("V"): (0, 1, 2), ord("N"): (0, 1, 2, 3),
}

# code (0..14) -> base set in A<C<G<T order (for exact-order kmer forking)
IUPAC_SETS_BY_CODE = [
    (0,), (1,), (2,), (3,),  # A C G T
    (0, 1, 2, 3),  # N
    (0, 2), (1, 3), (1, 2), (0, 3), (2, 3), (0, 1),  # R Y S W K M
    (1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2),  # B D H V
]

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for a, b in zip(b"ACGTacgtNn", b"TGCAtgcaNn"):
    _COMPLEMENT[a] = b
for a, b in zip(b"RYSWKMBDHVryswkmbdhv", b"YRSWMKVHDByrswmkvhdb"):
    _COMPLEMENT[a] = b

# code-level complement: A<->T C<->G, R(AG)<->Y(CT), K(GT)<->M(AC),
# B(CGT)<->V(ACG), D(AGT)<->H(ACT); S/W/N self-complementary
_CODE_COMPLEMENT = np.arange(256, dtype=np.uint8)
for a, b in ((0, 3), (1, 2), (5, 6), (9, 10), (11, 14), (12, 13)):
    _CODE_COMPLEMENT[a], _CODE_COMPLEMENT[b] = b, a


# Graph-label encoding: tag characters ('<SV:NNNNNNN>' etc.) get code 6 so
# mismatch counting can hard-reject paths through them (count_mismatches
# semantics, graph_utils.hpp:20-23); N stays 4 (matches anything).
_GRAPH_CODE = np.full(256, 6, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _GRAPH_CODE[b] = i
_GRAPH_CODE[ord("N")] = 4

TAG_CODE = 6


def encode_graph(seq: bytes) -> np.ndarray:
    """Graph label DNA -> codes (A0 C1 G2 T3, N=4, tag/other=6)."""
    return _GRAPH_CODE[np.frombuffer(seq, dtype=np.uint8)]


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A=0 C=1 G=2 T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(bytes(seq), dtype=np.uint8) if not isinstance(seq, np.ndarray) else seq
    return _CODE[arr]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (code>3 -> 'N')."""
    codes = np.minimum(codes, 4).astype(np.uint8)
    return _DECODE[codes].tobytes().decode()


def revcomp_ascii(seq: bytes) -> bytes:
    """Reverse complement of an ASCII sequence."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _COMPLEMENT[arr[::-1]].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array; IUPAC sets complement as sets
    (R<->Y etc.), N maps to N."""
    return _CODE_COMPLEMENT[codes[::-1]]


def pack_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All overlapping k-mers of a code sequence packed into uint64.

    2 bits per base, first base in the highest bits (reference packing order:
    type_conversions.hpp to_uint64 shifts left as it consumes bases, so kmer
    key = sum(code[i] << 2*(k-1-i))).

    Returns (kmers[uint64], valid[bool]) — a k-mer is valid iff it contains no
    ambiguous base.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    if k == 32:
        from graphtyper_tpu_torch.io import native

        return native.pack_kmers_native(codes)
    ok = codes < 4
    # sliding validity via cumulative sum of invalid flags
    bad = (~ok).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    c = np.where(ok, codes, 0).astype(np.uint64)
    kmers = np.zeros(n, dtype=np.uint64)
    # Horner over k positions (k is small, loop fine; vectorized over n)
    for i in range(k):
        kmers = (kmers << np.uint64(2)) | c[i : i + n]
    return kmers, valid


def unpack_kmer(kmer: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append("ACGT"[(kmer >> (2 * (k - 1 - i))) & 3])
    return "".join(out)
