"""Discovery event model: SNP/indel events, support accumulators, buckets.

Reference semantics: include/graphtyper/typer/event.hpp + src/typer/event.cpp
(Event ordering I<D<X at equal pos; get_log_qual :94-106; has_good_support
:218-253; is_good_indel :273-291; apply_indel_event :293-380; span
computation bucket.cpp:83-168), src/typer/read.cpp (support bookkeeping).
"""

from __future__ import annotations

from dataclasses import dataclass, field

READ_ANTI_SUPPORT = -1
READ_MULTI_SUPPORT = -2

# Event type order at equal positions: I < D < X (event.cpp:173-181)
_TYPE_ORDER = {"I": 0, "D": 1, "X": 2}


@dataclass(frozen=True, order=False, slots=True)
class Event:
    pos: int  # 1-based-ish region-absolute position
    type: str  # 'X' | 'I' | 'D'
    sequence: bytes

    def sort_key(self):
        return (self.pos, _TYPE_ORDER[self.type], self.sequence)

    def __lt__(self, o: "Event") -> bool:
        return self.sort_key() < o.sort_key()

    def to_string(self) -> str:
        return f"{self.pos} {self.type} {self.sequence.decode()}"


@dataclass(slots=True)
class EventSupport:
    hq_count: int = 0
    lq_count: int = 0
    proper_pairs: int = 0
    first_in_pairs: int = 0
    sequence_reversed: int = 0
    clipped: int = 0
    max_mapq: int = 0
    max_distance: int = 0
    uniq_pos1: int = -1
    uniq_pos2: int = -1
    uniq_pos3: int = -1
    phase: dict = field(default_factory=dict)  # Event -> count
    # indel-only
    multi_count: int = 0
    anti_count: int = 0
    span: int = 1
    has_realignment_support: bool = False
    has_indel_good_support: bool = False
    max_log_qual: int = 0
    max_log_qual_file_i: int = -1

    def clear(self) -> None:
        """event.cpp EventSupport::clear — resets read-counting fields but
        keeps indel-specific fields."""
        self.hq_count = 0
        self.lq_count = 0
        self.proper_pairs = 0
        self.first_in_pairs = 0
        self.sequence_reversed = 0
        self.clipped = 0
        self.max_mapq = 0
        self.max_distance = 0
        self.uniq_pos1 = -1
        self.uniq_pos2 = -1
        self.uniq_pos3 = -1

    def get_raw_support(self) -> int:
        return self.hq_count + self.lq_count

    def corrected_support(self) -> float:
        return self.hq_count + self.lq_count / 2.0

    def has_good_support(
        self,
        cov: int,
        filter_on_proper_pairs: bool = True,
        no_filter_on_begin_pos: bool = False,
        filter_on_read_bias: bool = True,
        filter_on_strand_bias: bool = True,
    ) -> bool:
        """event.cpp:218-253."""
        if cov < 1:
            cov = 1
        raw = self.get_raw_support()
        ratio = raw / cov
        is_very_promising = (
            self.uniq_pos3 != -1
            and ((self.hq_count >= 8 and ratio >= 0.35) or (self.hq_count >= 7 and ratio >= 0.40))
            and (not filter_on_proper_pairs or self.proper_pairs >= 6)
        )
        is_promising = (
            self.uniq_pos3 != -1
            and (
                (self.hq_count >= 7 and ratio >= 0.20)
                or (self.hq_count >= 6 and ratio >= 0.30)
                or (self.hq_count >= 5 and ratio >= 0.40)
            )
            and (not filter_on_proper_pairs or self.proper_pairs >= 4)
        )
        return (
            (no_filter_on_begin_pos or self.uniq_pos2 != -1)
            and (not filter_on_proper_pairs or self.proper_pairs >= 2)
            and (self.hq_count >= 3)
            and (
                not filter_on_read_bias
                or is_promising
                or (self.first_in_pairs > 0 and self.first_in_pairs < raw)
            )
            and (
                is_very_promising
                or not filter_on_strand_bias
                or (is_promising and self.sequence_reversed > 0 and self.sequence_reversed < raw)
                or (self.sequence_reversed > 1 and self.sequence_reversed < raw - 1)
            )
            and (self.clipped <= 1 or (self.clipped + 5) <= raw)
            and (self.max_distance >= 10 or (is_promising and self.hq_count >= 10))
            and (self.corrected_support() >= 3.9)
            and (ratio > 0.26 or is_promising)
        )

    def log_qual(self, eps: int = 7) -> int:
        return get_log_qual(self.hq_count + self.lq_count, self.anti_count, eps)

    def is_good_indel(self, eps: int = 7) -> bool:
        """event.cpp:273-291."""
        depth = self.hq_count + self.lq_count + self.anti_count + self.multi_count
        if (
            self.hq_count <= 6
            or self.sequence_reversed <= 0
            or self.sequence_reversed >= depth
            or self.proper_pairs <= 4
            or (self.hq_count < 10 and self.max_mapq <= 10)
        ):
            return False
        qual = 3 * get_log_qual(self.hq_count + self.lq_count, self.anti_count, eps)
        if qual < 50:
            return False
        return qual / depth >= 3.5


def get_log_qual(count: int, anti_count: int, eps: int = 7) -> int:
    gt00 = count * eps
    gt01 = count + anti_count
    gt11 = anti_count * eps
    gt_alt = min(gt01, gt11)
    return gt00 - gt_alt if gt00 > gt_alt else 0


def get_log_qual_double(count: float, anti_count: float, eps: float = 7.0) -> int:
    gt00 = count * eps
    gt01 = count + anti_count
    gt11 = anti_count * eps
    gt_alt = min(gt01, gt11)
    return int(gt00 - gt_alt + 0.5) if gt00 > gt_alt else 0


def apply_indel_event(sequence: bytearray, ref_positions: list[int], event: Event, offset: int) -> bool:
    """event.cpp:293-380 — rewrite a reference copy with an indel applied,
    maintaining the ref position track."""
    ref_pos = event.pos - offset
    if ref_pos <= 0:
        return False
    pos = ref_pos
    event_size = len(event.sequence)
    seq_size = len(sequence)
    if pos >= seq_size:
        return False
    if ref_positions[pos] != ref_pos:
        while pos + 1 < seq_size and ref_positions[pos] < ref_pos:
            pos += 1
        while pos > 0 and ref_positions[pos] > ref_pos:
            pos -= 1
        if ref_positions[pos] != ref_pos:
            return False
    # purity check
    PURITY_PAD = 3
    begin = max(0, pos - PURITY_PAD)
    end = min(len(ref_positions), pos + PURITY_PAD)
    prev = ref_positions[begin]
    for p in range(begin + 1, end):
        if ref_positions[p] == prev + 1:
            prev += 1
        else:
            return False
    if event.type == "D":
        if pos + event_size >= len(ref_positions) or ref_positions[pos + event_size] != ref_pos + event_size:
            return False
        del sequence[pos : pos + event_size]
        del ref_positions[pos : pos + event_size]
    elif event.type == "I":
        sequence[pos:pos] = event.sequence
        ref_positions[pos + 1 : pos + 1] = [pos + 1] * event_size
    else:
        return False
    return True


def compute_indel_span(event: Event, reference: bytes, ref_offset: int) -> int:
    """bucket.cpp:108-165 — homopolymer/repeat span of an indel."""
    REF_SIZE = len(reference)
    span = 0
    count = len(event.sequence)
    if event.type == "I":
        while span < count:
            if ref_offset + span >= REF_SIZE or event.sequence[span] != reference[ref_offset + span]:
                break
            span += 1
        if span == count:
            while ref_offset + span < REF_SIZE:
                if reference[ref_offset + span - count] != reference[ref_offset + span]:
                    break
                span += 1
    else:
        while ref_offset + span + count < REF_SIZE:
            if reference[ref_offset + span] != reference[ref_offset + span + count]:
                break
            span += 1
    return min(span, 0xFFFE) + 1
