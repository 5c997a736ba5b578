"""Command-line interface of the torch port.

Usage: python -m graphtyper_tpu_torch.cli genotype ref.fa --sam a.bam ... \\
           --region chr1:1-200000 -O out [--device cuda]

Port of the `genotype` subcommand of graphtyper_tpu/cli.py (cmd_genotype
:156, its parser :390, _add_common :134); its option helpers are copied.
The device defaults to cuda and the command fails when there is no GPU;
`--device cpu` runs the plain PyTorch versions instead. The multi-host flags raise NotImplementedError
until the parallel slice is ported; the other subcommands are still to
port (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys


def _read_sams_arg(args) -> list[str]:
    """--sam / --sams file-of-files handling (main.cpp subcommand pattern)."""
    sams: list[str] = []
    if getattr(args, "sam", None):
        sam = args.sam
        sams.extend(sam if isinstance(sam, list) else [sam])
    if getattr(args, "sams", None):
        with open(args.sams) as f:
            sams.extend(l.strip() for l in f if l.strip())
    if getattr(args, "sam_positional", None):
        sams.extend(args.sam_positional)
    return sams


def _add_advanced(p: argparse.ArgumentParser) -> None:
    """The reference's advanced option catalog (main.cpp subcmd_genotype
    "advanced" flags), mapped 1:1 onto config.Options fields."""
    g = p.add_argument_group("advanced")
    g.add_argument("--no_asterisks", action="store_true")
    g.add_argument("--no_filter_on_mapq", action="store_true")
    g.add_argument("--no_filter_on_proper_pairs", action="store_true")
    g.add_argument("--no_filter_on_read_bias", action="store_true")
    g.add_argument("--no_filter_on_strand_bias", action="store_true")
    g.add_argument("--no_filter_on_begin_pos", action="store_true")
    g.add_argument("--no_filter_on_coverage", action="store_true")
    g.add_argument("--force_no_filter_zero_qual", action="store_true")
    g.add_argument("--get_sample_names_from_filename", action="store_true")
    g.add_argument("--no_sample_name_reordering", action="store_true")
    g.add_argument("--no_variant_overlapping", action="store_true")
    g.add_argument("--normal_and_no_variant_overlapping", action="store_true")
    g.add_argument("--is_all_biallelic", action="store_true")
    g.add_argument("--is_sam_merging_allowed", action="store_true")
    g.add_argument("--max_files_open", type=int, default=None)
    g.add_argument("--genotype_aln_min_support", type=int, default=None)
    g.add_argument("--genotype_aln_min_support_ratio", type=float, default=None)
    g.add_argument("--genotype_dis_min_support", type=int, default=None)
    g.add_argument("--genotype_dis_min_support_ratio", type=float, default=None)
    g.add_argument("--bamshrink_max_fraglen", type=int, default=None)
    g.add_argument("--bamshrink_min_matching", type=int, default=None)
    g.add_argument("--bamshrink_min_readlen", type=int, default=None)
    g.add_argument("--bamshrink_min_readlen_low_mapq", type=int, default=None)
    g.add_argument("--bamshrink_is_not_filtering_mapq0", action="store_true")
    g.add_argument("--primer_bedpe", default=None)
    g.add_argument("--encoding", choices=["vcf", "popvcf"], default=None)
    g.add_argument("--bgzf_compression_level", type=int, default=None,
                   help="BGZF output compression level (-1 = zlib default; "
                        "popvcf encoding defaults to 9)")
    g.add_argument("--uncompressed_sample_names", action="store_true",
                   help="Write sample names as 0-level BGZF blocks and emit "
                        "their byte range to <prefix>.samples_byte_range")
    g.add_argument("--stats", default=None, help="Directory for debug stats dumps (per-read/per-path TSVs)")
    g.add_argument("--force_device_sw", action="store_true",
                   help="device_sw on: every realignment batch on the device's SW kernel")


def _options_from_args(args):
    """Build a config.Options from parsed CLI flags (only fields the user
    actually set are overridden)."""
    from dataclasses import replace

    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS

    opts = DEFAULT_OPTIONS
    over = {}
    # subcommand default pool widths (main.cpp:900 genotype_sv, :1065
    # genotype_lr, :722 genotype_hla); an explicit --max_files_open wins
    fn = getattr(args, "fn", None)
    sub = getattr(fn, "__name__", "")
    if getattr(args, "max_files_open", None) is None:
        if sub in ("cmd_genotype_sv", "cmd_genotype_lr"):
            over["max_files_open"] = 128
        elif sub == "cmd_genotype_hla":
            over["max_files_open"] = 1024
    for store_true in (
        "no_asterisks", "no_filter_on_begin_pos", "no_filter_on_coverage",
        "force_no_filter_zero_qual", "get_sample_names_from_filename",
        "no_sample_name_reordering", "no_variant_overlapping",
        "normal_and_no_variant_overlapping", "is_all_biallelic",
        "is_sam_merging_allowed", "bamshrink_is_not_filtering_mapq0", "force_device_sw",
        "no_decompose", "no_cleanup", "no_bamshrink", "output_all_variants",
        "uncompressed_sample_names",
    ):
        if getattr(args, store_true, False):
            over[store_true] = True
    # negative flags -> positive Options fields
    for flag, field_name in (
        ("no_filter_on_mapq", "filter_on_mapq"),
        ("no_filter_on_proper_pairs", "filter_on_proper_pairs"),
        ("no_filter_on_read_bias", "filter_on_read_bias"),
        ("no_filter_on_strand_bias", "filter_on_strand_bias"),
    ):
        if getattr(args, flag, False):
            over[field_name] = False
    for value_opt in (
        "max_files_open", "genotype_aln_min_support", "genotype_aln_min_support_ratio",
        "genotype_dis_min_support", "genotype_dis_min_support_ratio",
        "bamshrink_max_fraglen", "bamshrink_min_matching", "bamshrink_min_readlen",
        "bamshrink_min_readlen_low_mapq", "primer_bedpe", "stats",
    ):
        v = getattr(args, value_opt, None)
        if v is not None:
            over[value_opt] = v
    if getattr(args, "encoding", None):
        over["encoding"] = "p" if args.encoding == "popvcf" else "v"
        # level 9 is already fast in popvcf encoding mode (main.cpp:442-444)
        if args.encoding == "popvcf" and getattr(args, "bgzf_compression_level", None) is None:
            over["bgzf_compression_level"] = 9
    if getattr(args, "bgzf_compression_level", None) is not None:
        over["bgzf_compression_level"] = args.bgzf_compression_level
    if getattr(args, "threads", None):
        over["threads"] = args.threads
    if getattr(args, "output", None):
        over["output_dir"] = args.output
    return replace(opts, **over) if over else opts


def _read_avg_cov(path: str, n_sams: int) -> list[float] | None:
    """Parse --avg_cov_by_readlen (one value per SAM; main.cpp:147-184).
    Returns None on error after printing the reason."""
    try:
        with open(path) as f:
            avg_cov = [float(l.strip()) for l in f if l.strip()]
    except (OSError, ValueError) as e:
        print(f"error: could not read --avg_cov_by_readlen file: {e}", file=sys.stderr)
        return None
    if len(avg_cov) != n_sams:
        print("error: --avg_cov_by_readlen line count != number of SAM/BAM files", file=sys.stderr)
        return None
    return avg_cov


def _add_common(p: argparse.ArgumentParser) -> None:
    """graphtyper_tpu/cli.py:134 plus --device."""
    import os

    p.add_argument("--output", "-O", default="results", help="Output directory")
    p.add_argument("--region", default=".", help="Genomic region chr[:begin[-end]]")
    p.add_argument("--sam", action="append", help="One SAM/BAM file (repeatable)")
    p.add_argument("--sams", help="File with one SAM/BAM path per line")
    p.add_argument("sam_positional", nargs="*", help="SAM/BAM files")
    p.add_argument("--threads", type=int, default=os.cpu_count())
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--vverbose", action="store_true")
    p.add_argument("--log", default="", help="Log file ('-' for stderr)")
    p.add_argument("--no_bamshrink", action="store_true")
    p.add_argument("--num_hosts", type=int, default=0,
                   help="Multi-host region sharding (not ported yet)")
    p.add_argument("--host_id", type=int, default=None, help="(not ported yet)")
    p.add_argument("--coordinator", default=None, help="(not ported yet)")
    p.add_argument("--no_decompose", action="store_true")
    p.add_argument("--no_cleanup", action="store_true")
    p.add_argument("--output_all_variants", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; fails without a GPU) or cpu")


def cmd_genotype(args) -> int:
    """graphtyper_tpu/cli.py:156 on the resolved device."""
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.pipeline.genotype import genotype_only_with_a_vcf, genotype_regions

    if (args.num_hosts and args.num_hosts > 1) or args.coordinator or args.host_id is not None:
        raise NotImplementedError("multi-host genotyping is not ported to the torch package yet")
    device = resolve_device(args.device)
    sams = _read_sams_arg(args)
    if not sams:
        print("error: no SAM/BAM files given", file=sys.stderr)
        return 1
    regions = [args.region]
    if args.region_file:
        with open(args.region_file) as f:
            regions = [line.strip() for line in f if line.strip()]
    avg_cov = None
    if args.avg_cov_by_readlen:
        avg_cov = _read_avg_cov(args.avg_cov_by_readlen, len(sams))
        if avg_cov is None:
            return 1
    for region in regions:
        if args.vcf:
            print(genotype_only_with_a_vcf(args.ref, sams, args.vcf, region, args.output, device))
        else:
            outs = genotype_regions(
                args.ref,
                sams,
                region,
                args.output,
                device,
                avg_cov_by_readlen=avg_cov,
                prior_vcf=args.prior_vcf or None,
                output_all_variants=args.output_all_variants,
            )
            for o in outs:
                print(o)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="graphtyper-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("genotype", help="Discover and genotype SNPs/indels")
    p.add_argument("ref", help="Reference FASTA")
    p.add_argument("--vcf", default="", help="Genotype only the sites of this VCF (single iteration)")
    p.add_argument("--prior_vcf", default="", help="Add these prior sites to discovery")
    p.add_argument("--region_file", default="", help="File with one region per line")
    p.add_argument(
        "--avg_cov_by_readlen",
        default="",
        help="File with average coverage divided by read length, one value per line (one per SAM)",
    )
    _add_common(p)
    _add_advanced(p)
    p.set_defaults(fn=cmd_genotype)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from graphtyper_tpu_torch.config import set_options
    from graphtyper_tpu_torch.utils.log import setup_logging

    setup_logging(args.log, args.verbose, args.vverbose)
    set_options(_options_from_args(args))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
