"""Command-line interface of the torch port.

Usage: python -m graphtyper_tpu_torch.cli <subcommand> [args]

Port of graphtyper_tpu/cli.py with all of its subcommands (the parsers of
:386-498): genotype, genotype_sv, genotype_camou, genotype_hla, discover
and call do device work and take `--device` (default cuda, which fails
when there is no GPU; `--device cpu` runs the plain PyTorch versions).
genotype_lr, popvcf, construct, check, index, bamshrink, vcf_break_down,
vcf_concatenate and vcf_merge are host-only and take no `--device`, as in
the JAX package. Its option helpers are copied. The multi-host flags of
`genotype` (--num_hosts, --host_id, --coordinator) shard the regions over
processes (parallel/distributed.py); with --coordinator host:port the
processes also join one gloo process group there.
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
    """graphtyper_tpu/cli.py:134."""
    import os

    p.add_argument("--output", "-O", default="results", help="Output directory")
    p.add_argument("--region", default=".", help="Genomic region chr[:begin[-end]]")
    p.add_argument("--sam", action="append",
                   help="One SAM/BAM file (repeatable); SAM/BAM paths may also follow as "
                        "positional arguments, before or after the options")
    p.add_argument("--sams", help="File with one SAM/BAM path per line")
    # the positional SAM/BAM paths: what parse_args leaves over
    p.set_defaults(sam_positional=[])
    p.add_argument("--threads", type=int, default=os.cpu_count())
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--vverbose", action="store_true")
    p.add_argument("--log", default="", help="Log file ('-' for stderr)")
    p.add_argument("--no_bamshrink", action="store_true")
    p.add_argument("--num_hosts", type=int, default=0,
                   help="Shard regions across this many hosts (multi-host run)")
    p.add_argument("--host_id", type=int, default=None,
                   help="This host's id in a multi-host run (0-based)")
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed (gloo) rendezvous address host:port; host 0 listens there")
    p.add_argument("--no_decompose", action="store_true")
    p.add_argument("--no_cleanup", action="store_true")
    p.add_argument("--output_all_variants", action="store_true")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; fails without a GPU) or cpu")


def cmd_genotype(args) -> int:
    """graphtyper_tpu/cli.py:156 on the resolved device."""
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.pipeline.genotype import genotype_only_with_a_vcf, genotype_regions

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
    # multi-host region sharding (parallel/distributed.py): each host
    # genotypes its deterministic share of the regions; the union of the
    # hosts' region-structured outputs is the complete result
    if args.num_hosts and args.num_hosts > 1:
        from graphtyper_tpu_torch.parallel import distributed

        if args.coordinator:
            distributed.initialize(args.coordinator, args.num_hosts, args.host_id)
        try:
            outs = distributed.genotype_regions_distributed(
                args.ref,
                sams,
                regions,
                args.output,
                device,
                n_hosts=args.num_hosts,
                host=args.host_id,
                avg_cov_by_readlen=avg_cov,
                prior_vcf=args.prior_vcf or None,
                output_all_variants=args.output_all_variants,
            )
        finally:
            distributed.shutdown()
        for o in outs:
            print(o)
        return 0

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


def cmd_genotype_sv(args) -> int:
    """graphtyper_tpu/cli.py:229 on the resolved device."""
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.pipeline.genotype import genotype_sv

    device = resolve_device(args.device)
    sams = _read_sams_arg(args)
    avg_cov = None
    if args.avg_cov_by_readlen:
        avg_cov = _read_avg_cov(args.avg_cov_by_readlen, len(sams))
        if avg_cov is None:
            return 1
    print(genotype_sv(args.ref, args.sv_vcf, sams, args.region, args.output, device,
                      avg_cov_by_readlen=avg_cov))
    return 0


def cmd_genotype_lr(args) -> int:
    from graphtyper_tpu_torch.config import current_options
    from graphtyper_tpu_torch.pipeline.genotype_lr import genotype_lr

    print(genotype_lr(args.ref, _read_sams_arg(args), args.region, args.output, opts=current_options()))
    return 0


def cmd_genotype_camou(args) -> int:
    """graphtyper_tpu/cli.py:255 on the resolved device."""
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.pipeline.genotype_camou import genotype_camou

    device = resolve_device(args.device)
    print(genotype_camou(args.ref, args.interval_bed, _read_sams_arg(args), args.output, device))
    return 0


def cmd_genotype_hla(args) -> int:
    """graphtyper_tpu/cli.py:266 on the resolved device."""
    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.pipeline.genotype_hla import genotype_hla

    device = resolve_device(args.device)
    out = genotype_hla(
        args.ref,
        args.hla_vcf,
        _read_sams_arg(args),
        args.region,
        args.output,
        device,
        interval_fn=args.interval_file,
        segment_fasta_files=args.segment_fasta or None,
    )
    print(out)
    return 0


def cmd_popvcf(args) -> int:
    from graphtyper_tpu_torch.io.popvcf import decode_file, encode_file

    if args.mode == "encode":
        encode_file(args.input, args.output)
    else:
        decode_file(args.input, args.output)
    print(args.output)
    return 0


def cmd_discover(args) -> int:
    """graphtyper_tpu/cli.py:294 on the resolved device."""
    import os

    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.graph.coords import AbsolutePosition
    from graphtyper_tpu_torch.io.fasta import FastaFile
    from graphtyper_tpu_torch.typer.discovery import streamlined_discovery

    device = resolve_device(args.device)
    vcf = streamlined_discovery(_read_sams_arg(args), args.ref, args.region, [], device)
    fasta = FastaFile(args.ref)
    os.makedirs(args.output, exist_ok=True)
    out = os.path.join(args.output, "discovered.vcf.gz")
    vcf.write(out, fasta.contigs, AbsolutePosition(fasta.contigs), is_dropping_genotypes=True)
    print(out)
    return 0


def cmd_construct(args) -> int:
    from graphtyper_tpu_torch.graph.build import construct_graph

    g = construct_graph(args.ref, args.vcf or "", args.region, is_sv_graph=args.sv_graph)
    g.save(args.graph)
    print(f"Graph constructed: {len(g.ref_nodes)} ref nodes, {len(g.var_nodes)} var nodes -> {args.graph}")
    return 0


def cmd_call(args) -> int:
    """Call variants of a pre-constructed graph on the resolved device
    (graphtyper_tpu/cli.py:318; the reference advertises this subcommand
    but never wired it, main.cpp:1374 vs :1394-1430)."""
    import os

    from graphtyper_tpu_torch.device import resolve_device
    from graphtyper_tpu_torch.graph.graph import Graph
    from graphtyper_tpu_torch.index.build import index_graph
    from graphtyper_tpu_torch.pipeline.caller import call_pools
    from graphtyper_tpu_torch.pipeline.vcf_operations import vcf_merge_and_break

    device = resolve_device(args.device)
    g = Graph.load(args.graph)
    index = index_graph(g)
    region = g.genomic_region
    result = call_pools(g, index, _read_sams_arg(args), device, region=region, is_writing_hap=False)
    os.makedirs(args.output, exist_ok=True)
    out_vcf = os.path.join(args.output, f"{region.chr or 'graph'}_calls.vcf.gz")
    vcf_merge_and_break([result.vcf], out_vcf, region.to_string(), g, filter_zero_qual=True)
    print(out_vcf)
    return 0


def cmd_check(args) -> int:
    from graphtyper_tpu_torch.graph.graph import Graph

    g = Graph.load(args.graph)
    ok = g.check()
    print(f"Graph {args.graph}: size={g.size()} check={'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


def cmd_index(args) -> int:
    print("The 'index' subcommand is deprecated: the k-mer index is built in-memory per iteration.", file=sys.stderr)
    return 0


def cmd_bamshrink(args) -> int:
    from graphtyper_tpu_torch.graph.coords import GenomicRegion
    from graphtyper_tpu_torch.pipeline.bamshrink import bamshrink

    region = GenomicRegion.parse(args.region)
    print(bamshrink(args.sam, region.chr, region.begin, region.end, args.output_sam, args.avg_cov_by_readlen))
    return 0


def cmd_vcf_break_down(args) -> int:
    from graphtyper_tpu_torch.pipeline.vcf_tools import vcf_break_down_file

    vcf_break_down_file(args.graph, args.vcf, args.output, region=args.region)
    return 0


def cmd_vcf_concatenate(args) -> int:
    from graphtyper_tpu_torch.pipeline.vcf_operations import vcf_concatenate

    vcf_concatenate(args.vcfs, args.output)
    return 0


def cmd_vcf_merge(args) -> int:
    from graphtyper_tpu_torch.pipeline.vcf_tools import vcf_merge_files

    vcf_merge_files(args.vcfs, args.output)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """graphtyper_tpu/cli.py:386, with `--device` on the device subcommands."""
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
    _add_device(p)
    p.set_defaults(fn=cmd_genotype)

    p = sub.add_parser("genotype_sv", help="Genotype structural variants from an SV VCF")
    p.add_argument("ref")
    p.add_argument("sv_vcf")
    p.add_argument(
        "--avg_cov_by_readlen",
        default="",
        help="File with average coverage divided by read length, one value per line (one per SAM; main.cpp:910-912)",
    )
    _add_common(p)
    _add_advanced(p)
    _add_device(p)
    p.set_defaults(fn=cmd_genotype_sv)

    p = sub.add_parser("genotype_lr", help="Genotype from long-read pileups")
    p.add_argument("ref")
    _add_common(p)
    _add_advanced(p)
    p.set_defaults(fn=cmd_genotype_lr)

    p = sub.add_parser("genotype_camou", help="Genotype camouflaged (multi-copy) regions")
    p.add_argument("ref")
    p.add_argument("interval_bed")
    _add_common(p)
    _add_advanced(p)
    _add_device(p)
    p.set_defaults(fn=cmd_genotype_camou)

    p = sub.add_parser("genotype_hla", help="Genotype HLA alleles (WIP, as in the reference)")
    p.add_argument("--interval_file", default=None,
                   help="BED intervals for multi-interval bamshrink preprocessing")
    p.add_argument("--segment_fasta", action="append", default=[],
                   help="Per-gene panel FASTA for whole-segment calling (repeatable)")
    p.add_argument("ref")
    p.add_argument("hla_vcf")
    _add_common(p)
    _add_advanced(p)
    _add_device(p)
    p.set_defaults(fn=cmd_genotype_hla)

    p = sub.add_parser("popvcf", help="Encode/decode population VCFs (popVCF)")
    p.add_argument("mode", choices=["encode", "decode"])
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_popvcf)

    p = sub.add_parser("discover", help="Run only the discovery step, emit a sites VCF")
    p.add_argument("ref")
    _add_common(p)
    _add_advanced(p)
    _add_device(p)
    p.set_defaults(fn=cmd_discover)

    p = sub.add_parser("construct", help="Construct a graph from FASTA + VCF")
    p.add_argument("graph", help="Output graph file (.npz)")
    p.add_argument("ref")
    p.add_argument("--vcf", default="")
    p.add_argument("--region", default=".")
    p.add_argument("--sv_graph", action="store_true")
    p.set_defaults(fn=cmd_construct)

    p = sub.add_parser("call", help="Call variants of a graph")
    p.add_argument("graph")
    p.add_argument("--sam", action="append", default=[])
    p.add_argument("--sams", default="")
    p.add_argument("--output", "-O", default="call_results")
    _add_device(p)
    p.set_defaults(fn=cmd_call)

    p = sub.add_parser("check", help="Check a constructed graph")
    p.add_argument("graph")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("index", help="(deprecated)")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("bamshrink", help="Filter and shrink reads for a region")
    p.add_argument("sam")
    p.add_argument("output_sam")
    p.add_argument("--region", required=True)
    p.add_argument("--avg_cov_by_readlen", type=float, default=-1.0)
    p.set_defaults(fn=cmd_bamshrink)

    p = sub.add_parser("vcf_break_down", help="Decompose variants of a VCF")
    p.add_argument("graph")
    p.add_argument("vcf")
    p.add_argument("--output", required=True)
    p.add_argument("--region", default=".")
    p.set_defaults(fn=cmd_vcf_break_down)

    p = sub.add_parser("vcf_concatenate", help="Concatenate VCF files")
    p.add_argument("vcfs", nargs="+")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_vcf_concatenate)

    p = sub.add_parser("vcf_merge", help="Merge sample-pool VCF files")
    p.add_argument("vcfs", nargs="+")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_vcf_merge)

    return ap


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse a command line. The subcommands that take SAM/BAM paths take
    them as positional arguments anywhere after their own positionals:
    argparse leaves them over and they become `sam_positional`. Anything
    else left over is refused as argparse refuses it. (A positional with
    nargs="*" behind the subcommand's own positionals is matched by
    argparse differently across Python 3.12 patch releases once options
    stand between them.)"""
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    paths = [a for a in extra if a != "--"]
    if any(a.startswith("-") and a != "-" for a in paths) or (paths and not hasattr(args, "sam_positional")):
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if hasattr(args, "sam_positional"):
        args.sam_positional = paths
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from graphtyper_tpu_torch.config import set_options
    from graphtyper_tpu_torch.utils.log import setup_logging

    setup_logging(
        getattr(args, "log", ""), getattr(args, "verbose", False), getattr(args, "vverbose", False)
    )
    set_options(_options_from_args(args))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
