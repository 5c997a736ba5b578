"""Variant records during graph construction.

Re-implements the merge algebra of the reference's VarRecord/Alt
(src/graph/var_record.cpp, src/graph/alt.cpp): overlapping VCF records are
merged into combined multi-allelic records, either exhaustively
(`merge_all`, add-all-variants mode) or with suffix-match constraints
(`merge`). Events/anti-events carry phasing constraints (GT_ID /
GT_ANTI_HAPLOTYPE) through merging.

Sequences are `bytes` of ASCII bases.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Allele:
    """An allele sequence plus phasing event sets (alt.hpp Alt / Ref)."""

    seq: bytes = b""
    events: set[int] = field(default_factory=set)
    anti_events: set[int] = field(default_factory=set)

    def copy(self) -> "Allele":
        return Allele(self.seq, set(self.events), set(self.anti_events))


def make_alt(prev: Allele, curr: Allele, jump_size: int) -> Allele:
    """Concatenate prev allele with curr allele's suffix past jump_size,
    unioning events (alt.cpp make_alt)."""
    assert jump_size < len(curr.seq)
    new = prev.copy()
    new.seq = prev.seq + curr.seq[jump_size:]
    new.events |= curr.events
    new.anti_events |= curr.anti_events
    return new


def is_ok_to_merge_alts(prev_alt: Allele, curr_alt: Allele) -> bool:
    """False iff a positive event of curr is an anti-event of prev
    (alt.cpp is_ok_to_merge_alts)."""
    for ev in curr_alt.events:
        if ev < 0:
            continue
        if ev in prev_alt.anti_events:
            return False
    return True


@dataclass
class VarRecord:
    pos: int = 0  # 0-based contig-local position
    ref: Allele = field(default_factory=Allele)
    alts: list[Allele] = field(default_factory=list)
    is_sv: bool = False

    # ---- helpers (var_record.cpp anonymous namespace) ----

    def _insert_prior_sequence(self, previous: "VarRecord") -> None:
        assert self.pos > previous.pos
        prefix = previous.ref.seq[: self.pos - previous.pos]
        self.ref.seq = prefix + self.ref.seq
        for alt in self.alts:
            alt.seq = prefix + alt.seq
        self.pos = previous.pos

    @staticmethod
    def _extend_record(current: "VarRecord", previous: "VarRecord") -> None:
        """Extend `current` (ref + alts) with the tail of previous's ref."""
        size_diff = len(previous.ref.seq) - len(current.ref.seq)
        assert size_diff > 0
        tail = previous.ref.seq[-size_diff:]
        for alt in current.alts:
            alt.seq = alt.seq + tail
        current.ref.seq = current.ref.seq + tail

    def _extend_smaller_record(self, previous: "VarRecord") -> None:
        if len(self.ref.seq) < len(previous.ref.seq):
            VarRecord._extend_record(self, previous)
        elif len(self.ref.seq) > len(previous.ref.seq):
            VarRecord._extend_record(previous, self)

    def _move_alts(self, prev_record: "VarRecord") -> None:
        """Append prev's alts not already present by sequence
        (var_record.cpp move_alts)."""
        n_original = len(self.alts)
        for prev_alt in prev_record.alts:
            if all(self.alts[a].seq != prev_alt.seq for a in range(n_original)):
                self.alts.append(prev_alt)

    # ---- public merge operations ----

    def merge_one_path(self, prev: "VarRecord") -> None:
        """Merge keeping each record's alts as independent paths
        (var_record.cpp:178-205)."""
        assert self.pos >= prev.pos
        if prev.pos < self.pos:
            self._insert_prior_sequence(prev)
        self._extend_smaller_record(prev)
        assert self.ref.seq == prev.ref.seq
        self.ref.events |= prev.ref.events
        self.ref.anti_events |= prev.ref.anti_events
        for alt in self.alts:
            alt.events |= prev.ref.events
            alt.anti_events |= prev.ref.anti_events
        self._move_alts(prev)

    def merge_all(self, prev: "VarRecord") -> None:
        """Exhaustive haplotype-product merge when prev ends exactly where
        this starts; otherwise overlap merge (var_record.cpp:207-280)."""
        assert prev.pos + len(prev.ref.seq) >= self.pos
        if prev.pos + len(prev.ref.seq) == self.pos:
            new_record = VarRecord(prev.pos)
            for prev_alt in prev.alts:
                for curr_alt in self.alts:
                    if is_ok_to_merge_alts(prev_alt, curr_alt):
                        new_record.alts.append(make_alt(prev_alt, curr_alt, 0))
                # A + current-ref path, carrying current ref's events
                new_alt = prev_alt.copy()
                new_alt.seq = prev_alt.seq + self.ref.seq
                new_alt.events |= self.ref.events
                new_alt.anti_events |= self.ref.anti_events
                new_record.alts.append(new_alt)
            # C,D,E -> RC,RD,RE
            for alt in self.alts:
                alt.seq = prev.ref.seq + alt.seq
                alt.events |= prev.ref.events
                alt.anti_events |= prev.ref.anti_events
            # ref -> RS
            self.pos = prev.pos
            self.ref.seq = prev.ref.seq + self.ref.seq
            self.ref.events |= prev.ref.events
            self.ref.anti_events |= prev.ref.anti_events
            self._move_alts(new_record)
            # drop alts whose events collide with their own anti-events
            self.alts = [a for a in self.alts if not (a.events & a.anti_events)]
        else:
            self.merge(prev, 0)

    def merge(self, prev: "VarRecord", extra_suffix: int) -> None:
        """Overlap merge with suffix-match constraint
        (var_record.cpp:282-370)."""
        assert self.pos >= prev.pos
        jump_size = self.pos - prev.pos
        oref_size = len(self.ref.seq)
        if jump_size > 0:
            self._insert_prior_sequence(prev)
        oref_size_pre = len(self.ref.seq)
        assert oref_size + jump_size == oref_size_pre
        self._extend_smaller_record(prev)
        extension_size = len(self.ref.seq) - oref_size_pre
        assert prev.ref.seq == self.ref.seq

        new_record = VarRecord(prev.pos)
        for prev_alt in prev.alts:
            if len(prev_alt.seq) <= oref_size:
                continue
            offset = len(self.ref.seq) - len(prev_alt.seq)
            if jump_size - offset < 0:
                continue
            # count matching suffix bases between extended ref and prev alt
            suffix_matches = 0
            smaller = min(len(self.ref.seq), len(prev_alt.seq))
            for k in range(smaller):
                if self.ref.seq[-1 - k] == prev_alt.seq[-1 - k]:
                    suffix_matches += 1
                else:
                    break
            if suffix_matches >= extension_size + extra_suffix:
                prefix_alt = prev_alt.copy()
                prefix_alt.seq = prev_alt.seq[: jump_size - offset]
                for curr_alt in self.alts:
                    if is_ok_to_merge_alts(prefix_alt, curr_alt):
                        new_record.alts.append(make_alt(prefix_alt, curr_alt, jump_size))

        self.ref.events |= prev.ref.events
        self.ref.anti_events |= prev.ref.anti_events
        for alt in self.alts:
            alt.events |= prev.ref.events
            alt.anti_events |= prev.ref.anti_events

        # drop prev alts anti-phased with the now-merged ref events
        prev.alts = [a for a in prev.alts if not (a.anti_events & self.ref.events)]
        self._move_alts(prev)
        self._move_alts(new_record)

    # ---- misc ----

    def add_suffix(self, suffix: bytes) -> None:
        for alt in self.alts:
            alt.seq = alt.seq + suffix
        self.ref.seq = self.ref.seq + suffix

    def get_common_suffix(self) -> bytes:
        """Longest common suffix of ref+alts, capped so every allele keeps
        >= 1 base (var_record.cpp:372-396)."""
        if not self.ref.seq or any(len(a.seq) == 0 for a in self.alts):
            return b""
        n = 0
        while (
            n < len(self.ref.seq) - 1
            and all(n < len(a.seq) - 1 and a.seq[-1 - n] == self.ref.seq[-1 - n] for a in self.alts)
        ):
            n += 1
        return self.ref.seq[len(self.ref.seq) - n :] if n else b""

    def trim_common_suffix(self) -> None:
        suffix = self.get_common_suffix()
        if suffix:
            cut = len(suffix)
            self.ref.seq = self.ref.seq[:-cut]
            for alt in self.alts:
                alt.seq = alt.seq[:-cut]

    def is_any_seq_larger_than(self, val: int) -> bool:
        return len(self.ref.seq) > val or any(len(a.seq) > val for a in self.alts)

    def is_snp_or_snps(self) -> bool:
        return all(len(a.seq) == len(self.ref.seq) for a in self.alts)

    def end_pos(self) -> int:
        return self.pos + len(self.ref.seq)
