"""Framework-wide constants.

Mirrors the semantic constants of the reference graphtyper
(graphtyper's include/graphtyper/constants.hpp.in) — the *values* must match
for output parity, but the data layout around them is TPU-native (dense numpy /
JAX tensors, not C++ objects).
"""

from __future__ import annotations

# K-mer size used by the index (constants.hpp.in:20)
K = 32

INVALID_ID = 0xFFFFFFFF
INVALID_NUM = 0xFFFF

# Maximum number of haplotype sequences enumerated per variant site
# (constants.hpp.in:23)
MAX_NUMBER_OF_HAPLOTYPES = 2560

# Number of matches that triggers splitting a variant (constants.hpp.in:26)
SPLIT_VAR_THRESHOLD = 5
MAX_READ_LENGTH = 151

# Positions >= SPECIAL_START are "special" positions: indices into the
# special-position table rather than genomic coordinates (constants.hpp.in:33)
SPECIAL_START = 0xD0000000

AS_LONG_AS_POSSIBLE = 0xFFFFFFFF

# Alignment constraints (constants.hpp.in:40-46)
MAX_UNIQUE_KMER_POSITIONS = 512
# multi-key index lookups (IUPAC forks; Hamming-1 probe sets) drop entirely
# past this label budget (ph_index.cpp:49-57, options.hpp max_index_labels=75)
MAX_INDEX_LABELS = 75
OPTIMAL_INSERT_SIZE = 300
MAX_SEED_NUMBER_ALLOWING_MISMATCHES = 64
MAX_SEED_NUMBER_FOR_WALKING = 256
MAX_NUM_LOCATIONS_PER_PATH = 256
EPSILON_0_EXPONENT = 12
INSERT_SIZE_WHEN_NOT_PROPER_PAIR = 0x7FFFFFFF

# Smith-Waterman scores (constants.hpp.in:49-53)
SCORE_MATCH = 1
SCORE_MISMATCH = 4
SCORE_GAP_OPEN = 7
SCORE_GAP_EXTEND = 1
SCORE_CLIP = 5

IS_ANY_HAP_SUPPORT = 1
IS_ANY_ANTI_HAP_SUPPORT = 2

# Read flag bits (constants.hpp.in:63-78). The first 12 match SAM flags.
IS_PAIRED = 1 << 0
IS_PROPER_PAIR = 1 << 1
IS_UNMAPPED = 1 << 2
IS_MATE_UNMAPPED = 1 << 3
IS_REVERSED = 1 << 4
IS_MATE_REVERSED = 1 << 5
IS_FIRST_IN_PAIR = 1 << 6
IS_SECOND_IN_PAIR = 1 << 7
IS_SECONDARY = 1 << 8
IS_QC_FAIL = 1 << 9
IS_DUPLICATION = 1 << 10
IS_SUPPLEMENTARY = 1 << 11
# graphtyper-specific flag extensions
IS_MAPQ_BAD = 1 << 12
IS_CLIPPED = 1 << 13
IS_LOW_BASE_QUAL = 1 << 14

# Graph construction merge windows (graph.cpp:89-90)
MAX_VAR_MERGE_DIST = 10
MAX_INDEL_MERGE_DIST = 2

# Indexer path-explosion caps (indexer.cpp:15-19)
MAX_TOTAL_VAR_NUM = 181
MAX_TOTAL_VAR_COUNT = 4

# PL conversion factor: 10*log10(2) (vcf.cpp:72)
LOG10_HALF_TIMES_10 = 3.01029995663981195213738894724493026768189881462108541

# DNA encoding: 2-bit codes; 4 = N/other (our own packing, used device-side)
DNA_A = 0
DNA_C = 1
DNA_G = 2
DNA_T = 3
DNA_N = 4
