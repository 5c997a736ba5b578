"""Tabix (.tbi) index reader/writer.

Replaces htslib's tbx usage (vcf.cpp write_tbi_index, constructor tabix region
reads). Implements the standard tabix binning scheme (same as BAM/UCSC bins,
min shift 14, depth 5).
"""

from __future__ import annotations

import struct

from graphtyper_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, decompress_all


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end)."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class TabixIndex:
    def __init__(self):
        self.format = 2  # VCF
        self.col_seq = 1
        self.col_beg = 2
        self.col_end = 0
        self.meta = ord("#")
        self.skip = 0
        self.names: list[str] = []
        # per ref: {bin: [(chunk_beg, chunk_end), ...]}, linear index list
        self.bins: list[dict[int, list[tuple[int, int]]]] = []
        self.linear: list[list[int]] = []

    @classmethod
    def load(cls, path: str) -> "TabixIndex":
        data = decompress_all(path)
        if data[:4] != b"TBI\x01":
            raise ValueError("not a tabix index")
        idx = cls()
        off = 4
        (n_ref, idx.format, idx.col_seq, idx.col_beg, idx.col_end, idx.meta, idx.skip, l_nm) = struct.unpack_from(
            "<8i", data, off
        )
        off += 32
        names_blob = data[off : off + l_nm]
        off += l_nm
        idx.names = [n.decode() for n in names_blob.split(b"\x00") if n]
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            idx.bins.append(bins)
            idx.linear.append(linear)
        return idx

    def save(self, path: str) -> None:
        out = BgzfWriter(path)
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        out.write(b"TBI\x01")
        out.write(
            struct.pack(
                "<8i",
                len(self.names),
                self.format,
                self.col_seq,
                self.col_beg,
                self.col_end,
                self.meta,
                self.skip,
                len(names_blob),
            )
        )
        out.write(names_blob)
        for bins, linear in zip(self.bins, self.linear):
            out.write(struct.pack("<i", len(bins)))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out.write(struct.pack("<Ii", bin_id, len(chunks)))
                for cb, ce in chunks:
                    out.write(struct.pack("<QQ", cb, ce))
            out.write(struct.pack("<i", len(linear)))
            out.write(struct.pack(f"<{len(linear)}Q", *linear))
        out.close()

    def query_chunks(self, contig: str, beg: int, end: int) -> list[tuple[int, int]]:
        """Candidate virtual-offset chunks overlapping 0-based [beg, end)."""
        if contig not in self.names:
            return []
        rid = self.names.index(contig)
        bins = self.bins[rid]
        linear = self.linear[rid]
        min_off = 0
        li = beg >> 14
        if li < len(linear):
            min_off = linear[li]
        chunks = []
        for b in reg2bins(beg, end):
            for cb, ce in bins.get(b, []):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        # merge adjacent/overlapping
        merged: list[tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged


class TabixWriter:
    """Accumulates (contig, beg, end, voffset ranges) while writing a bgzf
    text file; produces a .tbi."""

    def __init__(self):
        self.idx = TabixIndex()
        self._cur_name: str | None = None

    def add(self, contig: str, beg: int, end: int, voff_start: int, voff_end: int) -> None:
        if contig != self._cur_name:
            self.idx.names.append(contig)
            self.idx.bins.append({})
            self.idx.linear.append([])
            self._cur_name = contig
        bins = self.idx.bins[-1]
        linear = self.idx.linear[-1]
        b = reg2bin(beg, end)
        chunks = bins.setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_start, voff_end))
        li_end = (max(beg, end - 1)) >> 14
        while len(linear) <= li_end:
            linear.append(0)
        for i in range(beg >> 14, li_end + 1):
            if linear[i] == 0 or voff_start < linear[i]:
                linear[i] = voff_start
        # fill-in: tabix linear index convention fills gaps with prev value at save
    def save(self, path: str) -> None:
        for linear in self.idx.linear:
            prev = 0
            for i in range(len(linear)):
                if linear[i] == 0:
                    linear[i] = prev
                else:
                    prev = linear[i]
        self.idx.save(path)


def load_index(path: str):
    """Load a .tbi or .csi index by magic."""
    data = decompress_all(path)
    if data[:4] == b"CSI\x01":
        return CsiIndex.load(path)
    return TabixIndex.load(path)


def read_region_lines(gz_path: str, tbi_path: str, contig: str, beg: int, end: int) -> list[str]:
    """All text lines of a tabix/CSI-indexed bgzf file whose start position
    falls in 0-based [beg, end) on contig (caller re-filters precisely)."""
    idx = load_index(tbi_path)
    chunks = idx.query_chunks(contig, beg, end)
    lines: list[str] = []
    if not chunks:
        return lines
    with BgzfReader(gz_path) as r:
        for cb, ce in chunks:
            r.seek_virtual(cb)
            blob = r.read_until_voffset(ce)
            # chunk may start mid-record only if previous chunk ended there;
            # tabix chunks always start at record boundaries for the first one
            for raw in blob.split(b"\n"):
                if raw:
                    lines.append(raw.decode())
    return lines


# ---------------------------------------------------------------------------
# CSI (v1): the generalized binning index the reference writes with --is_csi
# (vcf.cpp write_tbi_index csi branch) — required for contigs >= 512 Mb.
# ---------------------------------------------------------------------------


def csi_reg2bin(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    """Generalized reg2bin (CSIv1 spec)."""
    end -= 1
    l = depth
    s = min_shift
    t = ((1 << (depth * 3)) - 1) // 7
    while l > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        l -= 1
        s += 3
        t -= 1 << (l * 3)
    return 0


def csi_reg2bins(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> list[int]:
    out = []
    end -= 1
    l = 0
    t = 0
    s = min_shift + depth * 3
    while l <= depth:
        b = t + (beg >> s)
        e = t + (end >> s)
        out.extend(range(b, e + 1))
        s -= 3
        t += 1 << (l * 3)
        l += 1
    return out


class CsiIndex:
    """CSI v1 index: same chunk structure as tabix with configurable binning
    and the tabix parameters carried in the aux blob."""

    def __init__(self, min_shift: int = 14, depth: int = 5):
        self.min_shift = min_shift
        self.depth = depth
        self.names: list[str] = []
        self.bins: list[dict[int, list[tuple[int, int]]]] = []
        self.loffsets: list[dict[int, int]] = []  # per ref: bin -> loffset

    @classmethod
    def load(cls, path: str) -> "CsiIndex":
        data = decompress_all(path)
        if data[:4] != b"CSI\x01":
            raise ValueError("not a CSI index")
        min_shift, depth, l_aux = struct.unpack_from("<3i", data, 4)
        idx = cls(min_shift, depth)
        off = 16
        aux = data[off : off + l_aux]
        off += l_aux
        if len(aux) >= 32:
            # tabix aux: format, col_seq, col_beg, col_end, meta, skip, l_nm, names
            (l_nm,) = struct.unpack_from("<i", aux, 24)
            names_blob = aux[28 : 28 + l_nm]
            idx.names = [n.decode() for n in names_blob.split(b"\x00") if n]
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            loff: dict[int, int] = {}
            for _ in range(n_bin):
                bin_id, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[bin_id] = chunks
                loff[bin_id] = loffset
            idx.bins.append(bins)
            idx.loffsets.append(loff)
        return idx

    def save(self, path: str) -> None:
        out = BgzfWriter(path)
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        aux = struct.pack("<7i", 2, 1, 2, 0, ord("#"), 0, len(names_blob)) + names_blob
        out.write(b"CSI\x01")
        out.write(struct.pack("<3i", self.min_shift, self.depth, len(aux)))
        out.write(aux)
        out.write(struct.pack("<i", len(self.bins)))
        for bins, loff in zip(self.bins, self.loffsets):
            out.write(struct.pack("<i", len(bins)))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out.write(struct.pack("<IQi", bin_id, loff.get(bin_id, 0), len(chunks)))
                for cb, ce in chunks:
                    out.write(struct.pack("<QQ", cb, ce))
        out.close()

    def query_chunks(self, contig: str, beg: int, end: int) -> list[tuple[int, int]]:
        if contig not in self.names:
            return []
        rid = self.names.index(contig)
        bins = self.bins[rid]
        chunks = []
        for b in csi_reg2bins(beg, end, self.min_shift, self.depth):
            chunks.extend(bins.get(b, []))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged


class CsiWriter:
    """CSI-producing twin of TabixWriter."""

    def __init__(self, min_shift: int = 14, depth: int = 5):
        self.idx = CsiIndex(min_shift, depth)
        self._cur_name: str | None = None

    def add(self, contig: str, beg: int, end: int, voff_start: int, voff_end: int) -> None:
        if contig != self._cur_name:
            self.idx.names.append(contig)
            self.idx.bins.append({})
            self.idx.loffsets.append({})
            self._cur_name = contig
        bins = self.idx.bins[-1]
        loff = self.idx.loffsets[-1]
        b = csi_reg2bin(beg, end, self.idx.min_shift, self.idx.depth)
        chunks = bins.setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_start, voff_end))
        if b not in loff or voff_start < loff[b]:
            loff[b] = voff_start

    def save(self, path: str) -> None:
        self.idx.save(path)


def write_index_for(gz_path: str, use_csi: bool = False) -> str:
    """Build a .tbi/.csi for an existing bgzf VCF by scanning its lines
    (used e.g. after popVCF re-encoding changes the byte layout)."""
    from graphtyper_tpu_torch.io.bgzf import BGZF_EOF, ThreadedBgzfWriter, decompress_all

    text = decompress_all(gz_path)
    # rewrite through the threaded writer so uncompressed offsets map to
    # virtual offsets deterministically
    w = ThreadedBgzfWriter(gz_path)
    spans: list[tuple[str, int, int, int, int]] = []
    for line in text.split(b"\n"):
        if not line:
            continue
        u0 = w.u_offset
        w.write(line + b"\n")
        if line.startswith(b"#"):
            continue
        fields = line.split(b"\t", 4)
        chrom = fields[0].decode()
        pos = int(fields[1])
        ref_len = len(fields[3])
        spans.append((chrom, pos - 1, pos - 1 + ref_len, u0, w.u_offset))
    w.close()
    writer = CsiWriter() if use_csi else TabixWriter()
    for chrom, beg, end, u0, u1 in spans:
        writer.add(chrom, beg, end, w.virtual_offset_of(u0), w.virtual_offset_of(u1))
    idx_path = gz_path + (".csi" if use_csi else ".tbi")
    writer.save(idx_path)
    return idx_path
