"""Command-line interface of the torch port.

Usage: python -m graphtyper_tpu_torch.cli genotype ref.fa --sam a.bam ... \\
           --region chr1:1-200000 -O out [--device cuda]

Port of the `genotype` subcommand of graphtyper_tpu/cli.py (cmd_genotype
:156, its parser :390, _add_common :134). The device defaults to cuda and
the command fails when there is no GPU; `--device cpu` runs the plain
PyTorch versions instead. The multi-host flags raise NotImplementedError
until the parallel slice is ported; the other subcommands are still to
port (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys

from graphtyper_tpu.cli import _add_advanced, _options_from_args, _read_avg_cov, _read_sams_arg


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
    from graphtyper_tpu.config import set_options
    from graphtyper_tpu.utils.log import setup_logging

    setup_logging(args.log, args.verbose, args.vverbose)
    set_options(_options_from_args(args))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
