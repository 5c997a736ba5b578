"""The control of the comparison that decides `correct`, and a planted
fault, each put in the program's place over the cell's own regions, at
the cell's own size, for each seed; their records go through the
harness's own decision (`benchmark.run.decide`). The harness's runs never
run them.

- `half_depth` (the control): the reference with one guarantee of the
  configuration broken (every read of a sample counts toward its
  genotype): it calls each sample from half of its read pairs (pairs 0-1
  of every 4, so both haplotypes keep their share).
- `false_sites` (a fault): the reference's own calls, plus a false allele
  beside every FALSE_EVERY-th allele that some sample carries: a SNP
  FALSE_SHIFT bp to its right, with its genotypes, as a discovery that
  emits a site twice, once at a wrong place, would report it.

    python -m benchmark.control --workload <name> --seeds <n> [<n> ...] [--fault half_depth|false_sites]

prints one JSON line a seed with the numbers that `benchmark.run`
compares and the `correct` it decides (false, for both).
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import reference
from benchmark.gen import make_region

FALSE_EVERY = 20
FALSE_SHIFT = 3


def half_depth(reg, full: reference.SiteCalls) -> dict:
    half = [(r.pair // 2) % 2 == 0 for r in reg.reads]
    return reference.control_calls(reg, reference.call_region(reg.seq, reg.variants, reg.reads, keep=half))


def false_sites(reg, full: reference.SiteCalls) -> dict:
    out = reference.control_calls(reg, full)
    for i, (pos, ref, alt) in enumerate(sorted(out)):
        at = pos + len(ref) + FALSE_SHIFT
        if i % FALSE_EVERY or at >= len(reg.seq):
            continue
        base = reg.seq[at : at + 1].tobytes()
        gt, ad, pl = out[(pos, ref, alt)]
        out.setdefault((at, base, b"T" if base != b"T" else b"G"), (gt, ad, pl))
    return out


FAULTS = {"half_depth": half_depth, "false_sites": false_sites}


def fault_records(seed: int, cfg: dict, length: int, n_regions: int, fault: str) -> list[dict]:
    """`reference.compare` of the fault's records in each region."""
    per_job = []
    for i in range(1, n_regions + 1):
        reg = make_region(seed, i, f"r{i - 1}", length, cfg)
        full = reference.call_region(reg.seq, reg.variants, reg.reads)
        per_job.append(reference.compare(FAULTS[fault](reg, full), reg.seq, reg.variants, full))
    return per_job


def main(argv=None) -> int:
    from benchmark.run import cell, decide

    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), default="half_depth")
    args = ap.parse_args(argv)
    _, work, cfg, traffic = cell(args.workload)
    for seed in args.seeds:
        ok, got = decide(fault_records(seed, cfg, traffic["job_bp"], traffic["regions_in_rotation"], args.fault))
        print(json.dumps({"workload": work["name"], "fault": args.fault, "seed": seed, "correct": ok, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
