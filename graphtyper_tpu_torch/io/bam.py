"""SAM/BAM decoding into packed numpy read batches.

Replaces the reference's htslib readers (hts_reader.cpp, hts_parallel_reader.cpp)
with a self-contained decoder. The output is a `ReadBatch`: dense, padded
tensors ready to ship to the TPU (2-bit-codable seqs, quals, flags, positions)
plus CSR CIGARs for the host-side pileup pass.

CRAM decode lives in io/cram.py (2.1 + 3.0) and is dispatched by suffix here.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from graphtyper_tpu_torch.io.bgzf import decompress_all
from graphtyper_tpu_torch.utils.dna import encode

# BAM 4-bit nibble -> ASCII base (=ACMGRSVTWYHKDBN)
_NIB = b"=ACMGRSVTWYHKDBN"
_NIB_ARR = np.frombuffer(_NIB, dtype=np.uint8)

CIGAR_OPS = "MIDNSHP=X"
# op codes: M0 I1 D2 N3 S4 H5 P6 =7 X8
CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)


@dataclass
class AlignedRead:
    name: str
    flag: int
    ref_id: int
    pos: int  # 0-based
    mapq: int
    cigar: list[tuple[int, int]]  # (op_code, length)
    mate_ref_id: int
    mate_pos: int
    tlen: int
    seq: bytes  # ASCII
    qual: np.ndarray  # uint8 phred values
    tags: dict = field(default_factory=dict)

    @property
    def query_length(self) -> int:
        return len(self.seq)

    def reference_length(self) -> int:
        return sum(l for op, l in self.cigar if CONSUMES_REF[op])


@dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]
    sample_names: list[str] = field(default_factory=list)
    rg_to_sample: dict = field(default_factory=dict)

    def parse_read_groups(self) -> None:
        """RG line SM: mapping (hts_reader.cpp RG->sample handling)."""
        from graphtyper_tpu_torch.config import current_options

        if getattr(current_options(), "get_sample_names_from_filename", False):
            # hts_reader.cpp:32: skip RG parsing so every consumer falls back
            # to the input filename as the sample name
            self.sample_names = []
            return
        samples: list[str] = []
        for line in self.text.split("\n"):
            if line.startswith("@RG"):
                rg_id, sm = None, None
                for f in line.split("\t")[1:]:
                    if f.startswith("ID:"):
                        rg_id = f[3:]
                    elif f.startswith("SM:"):
                        sm = f[3:]
                if sm is not None:
                    if sm not in samples:
                        samples.append(sm)
                    if rg_id is not None:
                        self.rg_to_sample[rg_id] = sm
        self.sample_names = samples


def _parse_bam_tags(blob: bytes) -> dict:
    tags = {}
    off = 0
    n = len(blob)
    while off + 3 <= n:
        tag = blob[off : off + 2].decode()
        typ = chr(blob[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(blob[off]); off += 1
        elif typ in "cC":
            tags[tag] = struct.unpack_from("<b" if typ == "c" else "<B", blob, off)[0]; off += 1
        elif typ in "sS":
            tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H", blob, off)[0]; off += 2
        elif typ in "iI":
            tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I", blob, off)[0]; off += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", blob, off)[0]; off += 4
        elif typ in "ZH":
            end = blob.index(b"\x00", off)
            tags[tag] = blob[off:end].decode(); off = end + 1
        elif typ == "B":
            sub = chr(blob[off]); off += 1
            cnt = struct.unpack_from("<i", blob, off)[0]; off += 4
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            fmt = "<" + str(cnt) + sub.lower() if sub != "f" else f"<{cnt}f"
            # handle signed/unsigned properly
            fmt = "<" + str(cnt) + {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            tags[tag] = list(struct.unpack_from(fmt, blob, off))
            off += size * cnt
        else:
            break
    return tags


def read_bam(path: str, parse_tags: bool = False) -> tuple[BamHeader, list[AlignedRead]]:
    data = decompress_all(path)
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8
    text = data[off : off + l_text].rstrip(b"\x00").decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(data[off : off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_lengths.append(l_ref)
    header = BamHeader(text, ref_names, ref_lengths)
    header.parse_read_groups()

    reads: list[AlignedRead] = []
    n = len(data)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, next_ref, next_pos, tlen) = struct.unpack_from(
            "<iiBBHHHiiii", data, off
        )
        p = off + 32
        name = data[p : p + l_read_name - 1].decode()
        p += l_read_name
        cigar_raw = np.frombuffer(data, dtype=np.uint32, count=n_cigar, offset=p)
        p += 4 * n_cigar
        cigar = [(int(c & 0xF), int(c >> 4)) for c in cigar_raw]
        nseq = (l_seq + 1) // 2
        seq_nib = np.frombuffer(data, dtype=np.uint8, count=nseq, offset=p)
        p += nseq
        hi = _NIB_ARR[seq_nib >> 4]
        lo = _NIB_ARR[seq_nib & 0xF]
        seq = np.empty(2 * nseq, dtype=np.uint8)
        seq[0::2] = hi
        seq[1::2] = lo
        seq = seq[:l_seq].tobytes()
        qual = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=p).copy()
        p += l_seq
        tags = _parse_bam_tags(data[p:end]) if parse_tags else {}
        reads.append(
            AlignedRead(name, flag, ref_id, pos, mapq, cigar, next_ref, next_pos, tlen, seq, qual, tags)
        )
        off = end
    return header, reads


def read_sam(path: str, parse_tags: bool = False) -> tuple[BamHeader, list[AlignedRead]]:
    with open(path) as f:
        text_header_lines = []
        reads: list[AlignedRead] = []
        ref_names: list[str] = []
        ref_lengths: list[int] = []
        name_to_id: dict[str, int] = {}
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                text_header_lines.append(line)
                if line.startswith("@SQ"):
                    sn, ln = None, 0
                    for fld in line.split("\t")[1:]:
                        if fld.startswith("SN:"):
                            sn = fld[3:]
                        elif fld.startswith("LN:"):
                            ln = int(fld[3:])
                    if sn is not None:
                        name_to_id[sn] = len(ref_names)
                        ref_names.append(sn)
                        ref_lengths.append(ln)
                continue
            fl = line.split("\t")
            name, flag, rname, pos, mapq, cigar_s, rnext, pnext, tlen = (
                fl[0], int(fl[1]), fl[2], int(fl[3]) - 1, int(fl[4]), fl[5], fl[6], int(fl[7]) - 1, int(fl[8]),
            )
            seq = fl[9].encode() if fl[9] != "*" else b""
            if fl[10] != "*":
                qual = np.frombuffer(fl[10].encode(), dtype=np.uint8) - 33
            else:
                qual = np.full(len(seq), 0xFF, dtype=np.uint8)
            cigar: list[tuple[int, int]] = []
            if cigar_s != "*":
                num = ""
                for ch in cigar_s:
                    if ch.isdigit():
                        num += ch
                    else:
                        cigar.append((CIGAR_OPS.index(ch), int(num)))
                        num = ""
            ref_id = name_to_id.get(rname, -1)
            mate_ref = ref_id if rnext == "=" else name_to_id.get(rnext, -1)
            tags = {}
            if parse_tags:
                for t in fl[11:]:
                    k, typ, v = t.split(":", 2)
                    tags[k] = int(v) if typ == "i" else (float(v) if typ == "f" else v)
            reads.append(AlignedRead(name, flag, ref_id, pos, mapq, cigar, mate_ref, pnext, tlen, seq, qual.copy(), tags))
    header = BamHeader("\n".join(text_header_lines), ref_names, ref_lengths)
    header.parse_read_groups()
    return header, reads


def read_alignments(
    path: str, parse_tags: bool = False, ref_path: str | None = None
) -> tuple[BamHeader, list[AlignedRead]]:
    if path.endswith(".sam"):
        return read_sam(path, parse_tags)
    if path.endswith(".bam"):
        return read_bam(path, parse_tags)
    if path.endswith(".cram"):
        from graphtyper_tpu_torch.io.cram import read_cram

        return read_cram(path, ref_path=ref_path, parse_tags=parse_tags)
    raise ValueError(f"unsupported alignment format: {path}")


_READ_CACHE: dict = {}
_READ_CACHE_MAX = 6


def prime_read_cache(path: str, header: BamHeader, reads: list[AlignedRead]) -> None:
    """Insert freshly written records for `path` into the read cache so the
    next consumer (discovery/caller) skips the decode entirely (bamshrink
    writes temp BAMs that the same process immediately re-reads)."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if len(_READ_CACHE) >= _READ_CACHE_MAX:
        _READ_CACHE.pop(next(iter(_READ_CACHE)))
    _READ_CACHE[key] = (header, reads)


def read_alignments_cached(
    path: str, parse_tags: bool = False, ref_path: str | None = None
) -> tuple[BamHeader, list[AlignedRead]]:
    """read_alignments with a small keyed cache: the iterative genotyping
    pipeline streams the same per-sample files once per iteration (3x); the
    decode is done once. Tags are always parsed so all flavors share one
    entry. Callers must not mutate the returned records (the caller/discovery
    paths never do; bamshrink, which rewrites records in place, uses the
    uncached reader)."""
    del parse_tags
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    hit = _READ_CACHE.get(key)
    if hit is not None:
        return hit
    out = read_alignments(path, parse_tags=True, ref_path=ref_path)
    if len(_READ_CACHE) >= _READ_CACHE_MAX:
        _READ_CACHE.pop(next(iter(_READ_CACHE)))
    _READ_CACHE[key] = out
    return out


@dataclass
class ReadBatch:
    """Dense padded read tensors — the device-facing read representation."""

    seqs: np.ndarray  # [N, L] uint8 codes (A0 C1 G2 T3, N=4, pad=5)
    lens: np.ndarray  # [N] int32
    quals: np.ndarray  # [N, L] uint8 (pad=0)
    flags: np.ndarray  # [N] uint16
    mapq: np.ndarray  # [N] uint8
    pos: np.ndarray  # [N] int64 0-based mapping position
    ref_id: np.ndarray  # [N] int32
    mate_pos: np.ndarray  # [N] int64
    tlen: np.ndarray  # [N] int32
    sample_idx: np.ndarray  # [N] int32
    names: list[str]
    cigar_ops: np.ndarray  # CSR values: op codes
    cigar_lens: np.ndarray  # CSR values: op lengths
    cigar_offsets: np.ndarray  # [N+1]

    def __len__(self) -> int:
        return len(self.lens)


def pack_reads(reads: list[AlignedRead], sample_idx: np.ndarray | None = None, pad_to: int | None = None) -> ReadBatch:
    n = len(reads)
    lens = np.array([r.query_length for r in reads], dtype=np.int32) if n else np.zeros(0, np.int32)
    lmax = int(lens.max()) if n else 0
    if pad_to is not None:
        lmax = max(lmax, pad_to)
    seqs = np.full((n, lmax), 5, dtype=np.uint8)
    quals = np.zeros((n, lmax), dtype=np.uint8)
    for i, r in enumerate(reads):
        codes = encode(r.seq)
        seqs[i, : len(codes)] = codes
        quals[i, : len(r.qual)] = r.qual
    cig_n = np.array([len(r.cigar) for r in reads], dtype=np.int64) if n else np.zeros(0, np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cig_n, out=offsets[1:])
    ops = np.zeros(int(offsets[-1]), dtype=np.uint8)
    clens = np.zeros(int(offsets[-1]), dtype=np.int32)
    for i, r in enumerate(reads):
        for j, (op, l) in enumerate(r.cigar):
            ops[offsets[i] + j] = op
            clens[offsets[i] + j] = l
    return ReadBatch(
        seqs=seqs,
        lens=lens,
        quals=quals,
        flags=np.array([r.flag for r in reads], dtype=np.uint16),
        mapq=np.array([r.mapq for r in reads], dtype=np.uint8),
        pos=np.array([r.pos for r in reads], dtype=np.int64),
        ref_id=np.array([r.ref_id for r in reads], dtype=np.int32),
        mate_pos=np.array([r.mate_pos for r in reads], dtype=np.int64),
        tlen=np.array([r.tlen for r in reads], dtype=np.int32),
        sample_idx=sample_idx if sample_idx is not None else np.zeros(n, dtype=np.int32),
        names=[r.name for r in reads],
        cigar_ops=ops,
        cigar_lens=clens,
        cigar_offsets=offsets,
    )
