"""Read-to-graph alignment: seeding via the k-mer index, path-lattice merge,
and bounded walk extension; read-pair orientation resolution.

Reference semantics: src/typer/alignment.cpp — align_read (:331),
find_genotype_paths_of_one_of_the_sequences (:23-103), update_paths /
update_unpaired_read_paths (:368-556), get_better_paths (:557);
src/utilities/kmer_help_functions.cpp — query_index (stride K-1 kmers with
IUPAC expansion), query_index_hamming_distance1_without_index (96 probes per
unambiguous kmer).
"""

from __future__ import annotations

import numpy as np

from graphtyper_tpu_torch.constants import (
    IS_CLIPPED,
    IS_FIRST_IN_PAIR,
    IS_MAPQ_BAD,
    IS_PAIRED,
    IS_PROPER_PAIR,
    IS_REVERSED,
    IS_UNMAPPED,
    K,
    MAX_INDEX_LABELS,
    MAX_UNIQUE_KMER_POSITIONS,
)
from graphtyper_tpu_torch.index.kmer_index import KmerIndex, hamming1_keys
from graphtyper_tpu_torch.io.bam import AlignedRead
from graphtyper_tpu_torch.typer.genotype_paths import GenotypePaths, compare_pairs, compare_single
from graphtyper_tpu_torch.utils.dna import encode, revcomp_codes


def num_kmers(length: int) -> int:
    return 0 if length < K else 1 + (length - K) // (K - 1)


def to_uint64_list(codes: np.ndarray, i: int) -> list[int]:
    """Packed keys of codes[i:i+K] with per-letter IUPAC fork
    (type_conversions.cpp to_uint64_vec:208-266): each ambiguity letter forks
    exactly its base set (W->2, B->3, N->4 keys), capped at 97 keys. Key order
    matches the reference: the existing slot takes the LAST member (A<C<G<T
    order) in place, earlier members are appended."""
    from graphtyper_tpu_torch.utils.dna import IUPAC_SETS_BY_CODE

    keys = [0]
    for j in range(i, i + K):
        if len(keys) > 97:
            return []
        c = int(codes[j])
        members = IUPAC_SETS_BY_CODE[c] if c < len(IUPAC_SETS_BY_CODE) else (0, 1, 2, 3)
        if len(members) == 1:
            m = members[0]
            keys = [(k << 2) | m for k in keys]
        else:
            appended: list[int] = []
            last = members[-1]
            for idx in range(len(keys)):
                base = keys[idx] << 2
                for m in members[:-1]:
                    appended.append(base | m)
                keys[idx] = base | last
            keys.extend(appended)
    return keys


def _stride_keys(codes: np.ndarray) -> list[list[int]]:
    """Packed keys per stride-(K-1) kmer position; ambiguous kmers fork via
    to_uint64_list. Bulk-packs the read once (native fast path) instead of
    Horner-packing each kmer in Python."""
    nk = num_kmers(len(codes))
    if nk <= 0:
        return []
    from graphtyper_tpu_torch.utils.dna import pack_kmers

    kmers, valid = pack_kmers(codes, K)
    out = []
    for i in range(nk):
        p = (K - 1) * i
        if valid[p]:
            out.append([int(kmers[p])])
        else:
            out.append(to_uint64_list(codes, p))
    return out


def _expand_spans(index: KmerIndex, begin: np.ndarray, end: np.ndarray, rows: np.ndarray, n_rows: int) -> list[list[tuple[int, int, int]]]:
    """Materialize label tuples per row from multi_get spans (only hits)."""
    out: list[list[tuple[int, int, int]]] = [[] for _ in range(n_rows)]
    ls, le, lv = index.label_start, index.label_end, index.label_var_id
    for h in np.nonzero(end > begin)[0]:
        a, b = int(begin[h]), int(end[h])
        out[rows[h]].extend((int(ls[j]), int(le[j]), int(lv[j])) for j in range(a, b))
    return out


def query_index(codes: np.ndarray, index: KmerIndex, keys_per_pos=None) -> list[list[tuple[int, int, int]]]:
    """Labels for kmers at stride K-1 over the read (one batched lookup)."""
    if keys_per_pos is None:
        keys_per_pos = _stride_keys(codes)
    if not keys_per_pos:
        return []
    flat: list[int] = []
    rows: list[int] = []
    for i, keys in enumerate(keys_per_pos):
        flat.extend(keys)
        rows.extend([i] * len(keys))
    if not flat:
        return [[] for _ in keys_per_pos]
    begin, end = index.multi_get(np.array(flat, dtype=np.uint64))
    out = _expand_spans(index, begin, end, np.array(rows), len(keys_per_pos))
    # IUPAC-forked (multi-key) lookups give up past the label budget
    # (ph_index.cpp:49-57 max_index_labels)
    for i, keys in enumerate(keys_per_pos):
        if len(keys) > 1 and len(out[i]) > MAX_INDEX_LABELS:
            out[i] = []
    return out


def query_index_hamming1(codes: np.ndarray, index: KmerIndex, keys_per_pos=None) -> list[list[tuple[int, int, int]]]:
    """Hamming-1 probing: one batched lookup over all 96*Q mutated keys
    (kmer_help_functions.cpp:93-119; ambiguous kmers are skipped)."""
    if keys_per_pos is None:
        keys_per_pos = _stride_keys(codes)
    if not keys_per_pos:
        return []
    base_rows = [i for i, keys in enumerate(keys_per_pos) if len(keys) == 1]
    if not base_rows:
        return [[] for _ in keys_per_pos]
    base = np.array([keys_per_pos[i][0] for i in base_rows], dtype=np.uint64)
    muts = hamming1_keys(base)  # [Q, 96] in reference probe order
    begin, end = index.multi_get(muts.reshape(-1))
    rows = np.repeat(np.array(base_rows), muts.shape[1])
    out = _expand_spans(index, begin, end, rows, len(keys_per_pos))
    # every Hamming-1 probe set is a multi-key lookup: give up past the
    # label budget (ph_index.cpp:49-57 max_index_labels)
    for i in base_rows:
        if len(out[i]) > MAX_INDEX_LABELS:
            out[i] = []
    return out


def find_genotype_paths(graph, index: KmerIndex, codes: np.ndarray, geno: GenotypePaths) -> None:
    """find_genotype_paths_of_one_of_the_sequences (alignment.cpp:23-103)."""
    keys_per_pos = _stride_keys(codes)
    h0 = query_index(codes, index, keys_per_pos)
    h1 = query_index_hamming1(codes, index, keys_per_pos)
    assert len(h0) > 0

    # Stop if all kmers are extremely common
    if all(len(l) >= MAX_UNIQUE_KMER_POSITIONS for l in h0):
        return

    read_start = 0
    for l0, l1 in zip(h0, h1):
        geno.add_next_kmer_labels(graph, l0, read_start, read_start + K - 1, 0)
        geno.add_next_kmer_labels(graph, l1, read_start, read_start + K - 1, 1)
        read_start += K - 1

    geno.remove_short_paths()
    geno.walk_read_starts(graph, codes, -1)
    geno.walk_read_ends(graph, codes, -1)
    geno.update_longest_path_size()
    geno.remove_short_paths()
    geno.remove_paths_with_too_many_mismatches()
    if graph.is_sv_graph:
        geno.remove_fully_special_paths(graph)
    geno.remove_non_ref_paths_when_read_matches_ref()
    geno.update_longest_path_size()
    geno.remove_short_paths()
    if graph.is_sv_graph:
        geno.remove_support_from_read_ends(graph)
    geno.read2 = codes


def align_read(
    graph,
    index: KmerIndex,
    read: AlignedRead,
    force_align_both_orientations: bool = False,
) -> tuple[GenotypePaths, GenotypePaths]:
    """align_read (alignment.cpp:331-366): forward codes always; reverse
    complement unless proper-pair geometry says otherwise."""
    codes = encode(read.seq)
    rcodes = revcomp_codes(codes)
    geno1 = GenotypePaths(read.flag, len(codes))
    geno2 = GenotypePaths(read.flag, len(codes))
    if len(codes) < 2 * K - 1:
        return geno1, geno2

    # reference checks read-reversed vs mate-reversed flags (0x10 vs 0x20)
    proper_geometry = (read.flag & IS_PAIRED) == 0 or (
        read.ref_id == read.mate_ref_id
        and -1200 < read.tlen < 1200
        and bool(read.flag & 0x10) != bool(read.flag & 0x20)
    )
    find_genotype_paths(graph, index, codes, geno1)
    if not proper_geometry or force_align_both_orientations:
        find_genotype_paths(graph, index, rcodes, geno2)
    return geno1, geno2


def _clipped_count(read: AlignedRead) -> int:
    if read.cigar:
        if read.cigar[0][0] == 4:
            return read.cigar[0][1]
        if read.cigar[-1][0] == 4:
            return read.cigar[-1][1]
    return 0


def _score_diff(read: AlignedRead) -> int:
    as_ = read.tags.get("AS", -1)
    xs = read.tags.get("XS", -1)
    if as_ == -1 or as_ < xs:
        return 0
    if xs == -1:
        xs = 0
    return min(as_ - xs, 255)


def update_paths(genos: tuple[GenotypePaths, GenotypePaths], read: AlignedRead) -> None:
    """Paired-read flag/metadata propagation (alignment.cpp:483-556)."""
    geno1, geno2 = genos
    geno1.flags = read.flag & ~IS_PROPER_PAIR
    geno1.mapq = read.mapq
    geno1.ml_insert_size = abs(read.tlen)
    if not (read.flag & IS_UNMAPPED):
        geno1.original_pos = read.pos
        geno2.original_pos = read.pos
    if read.mapq < 25:
        geno1.flags |= IS_MAPQ_BAD
    if _clipped_count(read) > 3:
        geno1.flags |= IS_CLIPPED
        geno2.flags |= IS_CLIPPED
    sd = _score_diff(read)
    geno1.score_diff = sd
    geno2.score_diff = sd
    geno2.flags = (read.flag ^ IS_REVERSED) & ~IS_PROPER_PAIR
    if read.mapq < 25:
        geno2.flags |= IS_MAPQ_BAD
    geno2.mapq = geno1.mapq
    geno2.ml_insert_size = geno1.ml_insert_size
    # base qualities oriented with each alignment (raw phred; the reference
    # stores ascii and subtracts 33 at use, alignment.cpp:397-401 +
    # vcf_writer.cpp:562-563)
    if read.qual is not None and len(read.qual):
        geno1.qual2 = read.qual
        geno2.qual2 = read.qual[::-1]


def update_unpaired_read_paths(genos: tuple[GenotypePaths, GenotypePaths], read: AlignedRead) -> GenotypePaths | None:
    """Unpaired orientation selection (alignment.cpp:368-450)."""
    cmp = compare_single(genos[0], genos[1])
    if cmp == 0:
        return None
    geno = genos[0] if cmp == 1 else genos[1]
    if cmp == 1:
        geno.flags = read.flag & ~IS_PROPER_PAIR
    else:
        geno.flags = (read.flag ^ IS_REVERSED) & ~IS_PROPER_PAIR
    geno.mapq = read.mapq
    if not (read.flag & IS_UNMAPPED):
        geno.original_pos = read.pos
    if read.mapq < 25:
        geno.flags |= IS_MAPQ_BAD
    if _clipped_count(read) > 3:
        geno.flags |= IS_CLIPPED
    geno.score_diff = _score_diff(read)
    if read.qual is not None and len(read.qual):
        geno.qual2 = read.qual if cmp == 1 else read.qual[::-1]
    return geno


def get_better_paths(
    genos1: tuple[GenotypePaths, GenotypePaths], genos2: tuple[GenotypePaths, GenotypePaths]
) -> tuple[GenotypePaths, GenotypePaths] | None:
    """Resolve mate-pair orientations (alignment.cpp:557-638): pick the
    (fwd-of-one, rev-of-other) combination that aligns best."""
    arr: list[GenotypePaths | None] = [None, None, None, None]

    def get_index(flags: int) -> int:
        return int((flags & IS_FIRST_IN_PAIR) != 0) + 2 * int((flags & IS_REVERSED) == 0)

    for g in (genos1[0], genos1[1], genos2[0], genos2[1]):
        arr[get_index(g.flags)] = g
    if any(a is None for a in arr):
        return None
    pair1 = (arr[3], arr[0])  # first fwd + second rev
    pair2 = (arr[1], arr[2])  # first rev + second fwd
    cmp = compare_pairs(pair1[0], pair1[1], pair2[0], pair2[1])
    if cmp == 1:
        pair1[0].flags |= IS_PROPER_PAIR
        pair1[1].flags |= IS_PROPER_PAIR
        return pair1
    if cmp == 2:
        pair2[0].flags |= IS_PROPER_PAIR
        pair2[1].flags |= IS_PROPER_PAIR
        return pair2
    return None
