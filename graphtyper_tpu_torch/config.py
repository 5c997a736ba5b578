"""Framework configuration: the full option catalog of the reference
(include/graphtyper/utilities/options.hpp:14-117) as an explicit immutable
dataclass passed through call chains — no mutable global singleton.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

from graphtyper_tpu_torch.constants import SPLIT_VAR_THRESHOLD


@dataclass
class Options:
    # general
    log: str = ""
    stats: str = ""  # debug stats dump dir (vcf_writer.cpp:442, main.cpp:660)
    output_dir: str = "results"
    threads: int = os.cpu_count() or 1
    verbose: bool = False
    vverbose: bool = False
    no_cleanup: bool = False
    no_asterisks: bool = False
    no_decompose: bool = False
    no_bamshrink: bool = False
    no_sample_name_reordering: bool = False
    no_variant_overlapping: bool = False
    normal_and_no_variant_overlapping: bool = False
    is_all_biallelic: bool = False
    is_only_cigar_discovery: bool = False
    is_discovery_only_for_paired_reads: bool = False
    is_sam_merging_allowed: bool = False
    ploidy: int = 2
    is_dropping_genotypes: bool = False
    split_var_threshold: int = SPLIT_VAR_THRESHOLD
    is_segment_calling: bool = False
    is_lr_calling: bool = False
    force_ignore_segment: bool = False
    uncompressed_sample_names: bool = False
    encoding: str = "v"  # 'v' VCF, 'p' popVCF
    bgzf_compression_level: int = -1

    # filtering
    filter_on_mapq: bool = True
    filter_on_proper_pairs: bool = True
    filter_on_read_bias: bool = True
    filter_on_strand_bias: bool = True
    no_filter_on_begin_pos: bool = False
    no_filter_on_coverage: bool = False
    lr_mapq_filter: int = 5
    lr_coverage_filter: int = 100

    # bamshrink
    bamshrink_max_fraglen: int = 1000
    bamshrink_min_matching: int = 55
    bamshrink_is_not_filtering_mapq0: bool = False
    bamshrink_min_readlen: int = 75
    bamshrink_min_readlen_low_mapq: int = 94
    bamshrink_min_unpair_readlen: int = 94
    bamshrink_as_filter_threshold: int = 40
    force_use_input_ref_for_cram_reading: bool = False

    # constructor
    vcf: str = ""
    prior_vcf: str = ""
    add_all_variants: bool = False

    # indexing
    max_index_labels: int = 75

    # calling
    hq_reads: bool = False
    # Pallas TPU Smith-Waterman routing for realignment: "auto" (default —
    # device kernel whenever a TPU backend is active and the batch is worth
    # dispatching, shapes bucketed to amortize compiles), "on", or "off".
    device_sw: str = "auto"
    force_device_sw: bool = False  # legacy alias for device_sw="on"
    # native C++ batch aligner (native/gt_align.cpp); "on" | "off". Path-level
    # parity with the Python aligner is asserted by
    # tests/typer/test_native_align.py; "off" keeps the Python loop.
    native_aligner: str = "on"
    # native C++ pooled caller loop (gt_call_pool: dedup + pairing +
    # observation extraction + connections); "on" | "off". State-level parity
    # asserted by tests/pipeline/test_native_caller.py. Applies to the non-SV
    # path without --stats; other modes use the Python loop.
    native_caller: str = "on"
    # batched device scoring of the PL-triangle/coverage/stats updates
    # (ops/site_scoring.py); "on" | "off". Bit-identical to the per-read host
    # path (tests/typer/test_device_scoring.py asserts parity), so it is on
    # by default; "off" keeps the reference-shaped per-read loop.
    device_scoring: str = "on"
    # device k-mer seeding (ops/seed_probe.py): the 97-probe exact+Hamming-1
    # index probing per kmer runs as one launch of csrc/seed_probe.cu per
    # pool and call iteration on the pool's device (the plain PyTorch
    # version on "cpu"), with the host verifying only the surviving
    # candidates — bit-identical to host probing (the membership bitset has
    # no false negatives). Non-SV pools of the in-memory caller only.
    # Default "auto" = off, as in the JAX package: the host seed filter
    # (native gt_seed_filter_build — the Hamming-1 expansion flipped to the
    # build side) probes ~2 bitset words per kmer in L2/L3. "on" runs the
    # device pass.
    device_seed: str = "auto"
    # device-resident alignment (ops/device_align.py): the call iteration's
    # align stage runs as one launch of csrc/device_align.cu per pool (in
    # memory) or per read batch (streaming, one batch ahead of the host)
    # against the device-resident k-mer index + reference arena; rows
    # resolved "clean" (single exact-seed chain, in-node tail — the
    # parity-provable tier) synthesize their path set in C++ with
    # seed+lattice+walk skipped, the other rows go to the host aligner.
    # "verify" runs BOTH on clean rows and counts divergences
    # (gt_device_align_stats). Non-SV pools only. "auto" resolves to off, as
    # in the JAX package; env GT_DEVICE_ALIGN overrides. A kernel that fails
    # to build or launch raises; nothing falls back to the host.
    device_align: str = "auto"
    # discovery first-pass aggregation routing (ops/discovery_pileup.py):
    # "auto" runs the split extract->aggregate->gates path with the row-count
    # threshold picking numpy vs the device segment-sum; "on" forces the
    # device aggregation; "off" keeps the monolithic native pass
    # (gt_first_pass, the parity oracle).
    device_discovery: str = "auto"
    # bounded-memory streaming pooled caller (native/gt_align.cpp
    # gt_stream_*): BAM files merge through a BGZF stream + heap and flow in
    # fixed-size batches, so RSS stays O(batch) at cohort scale (the
    # reference's hts_parallel_reader design). "auto" (on for big pools),
    # "on", or "off". Byte-identical to the in-memory caller.
    streaming_caller: str = "auto"
    is_csi: bool = False
    force_align_both_orientations: bool = False
    sam_flag_filter: int = 3840
    max_files_open: int = 864
    soft_cap_of_variants_in_100_bp_window: int = 22
    get_sample_names_from_filename: bool = False
    output_all_variants: bool = False
    is_one_genotype_per_haplotype: bool = False
    force_no_filter_bad_alts: bool = False
    force_no_filter_zero_qual: bool = False
    variant_suffix_id: str = ""
    primer_bedpe: str = ""
    is_extra_call_only_iteration: bool = False
    genotype_aln_min_support: int = 4
    genotype_aln_min_support_ratio: float = 0.21
    genotype_dis_min_support: int = 8
    genotype_dis_min_support_ratio: float = 0.30
    num_alleles_in_batch: int = 250

    # haplotype extraction
    max_extracted_haplotypes: int = 100
    minimum_extract_variant_support: int = 2
    minimum_extract_score_over_homref: int = 27
    impurity_threshold: float = 0.15

    def with_cohort_size(self, num_samples: int) -> "Options":
        """Cohort-size parameter adaptation (genotype.cpp:693-732)."""
        opts = self
        if num_samples >= 1000:
            opts = replace(opts, genotype_aln_min_support=7, genotype_aln_min_support_ratio=0.26)
        if num_samples >= 500:
            opts = replace(opts, is_all_biallelic=True)
        return opts


DEFAULT_OPTIONS = Options()

# Process-wide options set once by the CLI at startup (the reference uses a
# mutable Options::instance() singleton, options.hpp; here the instance is an
# immutable dataclass swapped in whole so library callers can still pass
# their own `opts` explicitly).
_CURRENT: Options = DEFAULT_OPTIONS


def set_options(opts: Options) -> None:
    global _CURRENT
    _CURRENT = opts


def current_options() -> Options:
    return _CURRENT
