"""popVCF encoder/decoder: delta-encoding of repeated genotype fields for
population VCFs.

Reference semantics: include/popvcf/encode.hpp (:15-249) + sequence_utils.hpp
— per sample field, emit:
  '$'       unique in line, same as the field directly above (prev line)
  '%<uid>'  unique in line, equals prev line's unique field <uid>
  '&'       duplicate in line, same as the field above
  '<uid>'   duplicate in line, points at this line's unique field <uid>
  raw       otherwise
uids are base-69 with charset starting at ':' (raw genotype fields always
start with '!'..'9', below ':', so the cases are unambiguous). The
previous-line state clears when the contig changes or pos crosses a 10kb
window, and only lines with equal alt counts roll into the previous-line
slot (encode.hpp clear_line :42-70). Selected via --encoding=popvcf in the
reference (main.cpp:440-444).
"""

from __future__ import annotations

CHAR_SET_SIZE = 69
CHAR_SET_MIN = ord(":")
N_FIELDS_SITE_DATA = 9


def int_to_ascii_string(v: int) -> str:
    out = []
    while v >= CHAR_SET_SIZE:
        out.append(chr(CHAR_SET_MIN + v % CHAR_SET_SIZE))
        v //= CHAR_SET_SIZE
    out.append(chr(CHAR_SET_MIN + v))
    return "".join(out)


def ascii_string_to_int(s: str) -> int:
    v = 0
    for ch in reversed(s):
        v = v * CHAR_SET_SIZE + (ord(ch) - CHAR_SET_MIN)
    return v


class _LineState:
    def __init__(self):
        self.contig: str | None = None
        self.pos = 0
        self.n_alt = -1
        self.unique: list[str] = []
        self.field2uid: list[int] = []
        self.map: dict[str, int] = {}


def _roll(prev: _LineState, cur: _LineState, contig: str, pos: int, n_alt: int) -> tuple[_LineState, _LineState]:
    """encode.hpp clear_line: decide what the previous-line state is for the
    new line (contig, pos, n_alt)."""
    if cur.contig != contig or (pos // 10000) != (cur.pos // 10000):
        prev = _LineState()
    elif n_alt == cur.n_alt:
        prev = cur
    # else: keep old prev
    new_cur = _LineState()
    new_cur.contig, new_cur.pos, new_cur.n_alt = contig, pos, n_alt
    return prev, new_cur


def encode_lines(lines) -> list[str]:
    out_lines: list[str] = []
    prev = _LineState()
    cur = _LineState()
    for line in lines:
        if not line:
            continue
        if line.startswith("#"):
            out_lines.append(line)
            continue
        fields = line.split("\t")
        contig = fields[0]
        pos = int(fields[1])
        n_alt = fields[4].count(",") + 1 if len(fields) > 4 else 0
        prev, cur = _roll(prev, cur, contig, pos, n_alt)

        out = list(fields[:N_FIELDS_SITE_DATA])
        for field_idx, f in enumerate(fields[N_FIELDS_SITE_DATA:]):
            if f not in cur.map:
                cur.map[f] = len(cur.unique)
                cur.field2uid.append(len(cur.unique))
                cur.unique.append(f)
                if field_idx < len(prev.field2uid) and prev.unique[prev.field2uid[field_idx]] == f:
                    out.append("$")  # unique, same as above
                elif f in prev.map:
                    out.append("%" + int_to_ascii_string(prev.map[f]))
                else:
                    out.append(f)  # brand new
            else:
                uid = cur.map[f]
                cur.field2uid.append(uid)
                if field_idx < len(prev.field2uid) and prev.unique[prev.field2uid[field_idx]] == f:
                    out.append("&")  # duplicate, same as above
                else:
                    out.append(int_to_ascii_string(uid))
        out_lines.append("\t".join(out))
    return out_lines


def decode_lines(lines) -> list[str]:
    out_lines: list[str] = []
    prev = _LineState()
    cur = _LineState()
    for line in lines:
        if not line:
            continue
        if line.startswith("#"):
            out_lines.append(line)
            continue
        fields = line.split("\t")
        contig = fields[0]
        pos = int(fields[1])
        n_alt = fields[4].count(",") + 1 if len(fields) > 4 else 0
        prev, cur = _roll(prev, cur, contig, pos, n_alt)

        out = list(fields[:N_FIELDS_SITE_DATA])
        for field_idx, f in enumerate(fields[N_FIELDS_SITE_DATA:]):
            if f == "$" or f == "&":
                val = prev.unique[prev.field2uid[field_idx]]
            elif f.startswith("%"):
                val = prev.unique[ascii_string_to_int(f[1:])]
            elif f and ord(f[0]) >= CHAR_SET_MIN:
                val = cur.unique[ascii_string_to_int(f)]
            else:
                val = f
            if val not in cur.map:
                cur.map[val] = len(cur.unique)
                cur.field2uid.append(len(cur.unique))
                cur.unique.append(val)
            else:
                cur.field2uid.append(cur.map[val])
            out.append(val)
        out_lines.append("\t".join(out))
    return out_lines


def encode_file(in_path: str, out_path: str) -> None:
    from graphtyper_tpu_torch.io.bgzf import BgzfWriter, decompress_all, is_bgzf

    if in_path.endswith(".gz") or is_bgzf(in_path):
        text = decompress_all(in_path).decode()
    else:
        text = open(in_path).read()
    out = encode_lines(text.split("\n"))
    w = BgzfWriter(out_path)
    w.write(("\n".join(out) + "\n").encode())
    w.close()


def decode_file(in_path: str, out_path: str) -> None:
    from graphtyper_tpu_torch.io.bgzf import BgzfWriter, decompress_all, is_bgzf

    if in_path.endswith(".gz") or is_bgzf(in_path):
        text = decompress_all(in_path).decode()
    else:
        text = open(in_path).read()
    out = decode_lines(text.split("\n"))
    w = BgzfWriter(out_path)
    w.write(("\n".join(out) + "\n").encode())
    w.close()
