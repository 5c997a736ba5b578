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

Of a `genotype_sv` cell (benchmark/reference_sv.py):

- `sv_rotate` (the control): the SV reference's calls with one guarantee
  of the configuration broken (each sample's calls are its own): every
  SV's genotypes moved from sample s to sample s + 1 (the last to the
  first).
- `sv_drop` (a fault): the SV reference's calls with the record of every
  DROP_EVERY-th SV of a region left out.

    python -m benchmark.control --workload <name> --seeds <n> [<n> ...] [--fault <name>]

prints one JSON line a seed with the numbers that `benchmark.run`
compares and the `correct` it decides (false, for each). The fault
defaults to the control of the cell's subcommand.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmark import reference, reference_sv
from benchmark.gen import make_region

FALSE_EVERY = 20
FALSE_SHIFT = 3
DROP_EVERY = 10


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


def sv_rotate(svs, gt: np.ndarray) -> dict:
    return reference_sv.control_calls(svs, np.roll(gt, 1, axis=1))


def sv_drop(svs, gt: np.ndarray) -> dict:
    out = reference_sv.control_calls(svs, gt)
    for j in range(0, len(svs), DROP_EVERY):
        out.pop(svs.ids[j], None)
    return out


SV_FAULTS = {"sv_rotate": sv_rotate, "sv_drop": sv_drop}


def fault_records(seed: int, cfg: dict, length: int, n_regions: int, fault: str) -> list[dict]:
    """`reference.compare` of the fault's records in each region."""
    per_job = []
    for i in range(1, n_regions + 1):
        reg = make_region(seed, i, f"r{i - 1}", length, cfg)
        full = reference.call_region(reg.seq, reg.variants, reg.reads)
        per_job.append(reference.compare(FAULTS[fault](reg, full), reg.seq, reg.variants, full))
    return per_job


def sv_fault_records(seed: int, cfg: dict, length: int, n_regions: int, fault: str) -> list[dict]:
    """`reference_sv.compare` of the fault's records in each region."""
    from benchmark.run import sv_references

    refs = sv_references(seed, cfg, length, list(range(n_regions)))
    return [reference_sv.compare(SV_FAULTS[fault](svs, gt), svs, length, gt) for gt, svs in refs.values()]


def main(argv=None) -> int:
    from benchmark.run import cell, decide

    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS) + sorted(SV_FAULTS))
    args = ap.parse_args(argv)
    _, work, cfg, traffic = cell(args.workload)
    sub = traffic.get("subcommand", "genotype")
    faults = SV_FAULTS if sub == "genotype_sv" else FAULTS
    fault = args.fault or ("sv_rotate" if sub == "genotype_sv" else "half_depth")
    if fault not in faults:
        raise SystemExit(f"fault {fault!r} is not one of a {sub} cell's: {sorted(faults)}")
    records = sv_fault_records if sub == "genotype_sv" else fault_records
    for seed in args.seeds:
        ok, got = decide(records(seed, cfg, traffic["job_bp"], traffic["regions_in_rotation"], fault), sub)
        print(json.dumps({"workload": work["name"], "fault": fault, "seed": seed, "correct": ok, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
