"""The plain reference against the port on a tiny cohort on the CPU: it
agrees with the port's output, and fails an output with one PL changed
and the control (its own calls from half of the reads)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import reference
from benchmark.gen import make_inputs, make_region

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
LENGTH = 30_000
SEED = 2**32 + 17


def config(name: str, **over) -> dict:
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return {**json.load(f), **over}


def numbers(job: dict, reg, ref: reference.SiteCalls) -> dict:
    got = reference.compare(job, reg.seq, reg.variants, ref)
    return {"pl_mismatch": got["pl_mismatch_pairs"] / got["pairs"], "ad_gap": got["ad_abs"] / max(got["ad_ref"], 1),
            "pl_steps": got["pl_steps"], "isolated_pairs": got["isolated_pairs"]}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A 6-sample cohort genotyped by the port on the CPU, with the
    reference's calls of the same reads."""
    from graphtyper_tpu_torch import cli
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions

    cfg = config("cohort48", n_samples=6)
    d = tmp_path_factory.mktemp("cohort")
    fasta, _, (reg,) = make_inputs(SEED, cfg, LENGTH, 1, str(d / "in"))
    where = f"{reg.contig}:1-{LENGTH}"
    args = cli.parse_args(["genotype", fasta, "--region", where, "-O", str(d / "out"), "--threads", "1",
                           "--device", "cpu", *reg.bams])
    set_options(cli._options_from_args(args))
    try:
        outs = genotype_regions(fasta, reg.bams, where, str(d / "out"), "cpu")
    finally:
        set_options(DEFAULT_OPTIONS)
    full = make_region(SEED, 1, reg.contig, LENGTH, cfg)
    ref = reference.call_region(full.seq, full.variants, full.reads)
    return reg, full, ref, outs


def test_agrees_with_the_port(cohort):
    reg, _, ref, outs = cohort
    got = numbers(reference.read_vcfs(outs, reg.seq, len(reg.samples)), reg, ref)
    assert got["isolated_pairs"] > 50
    assert got["ad_gap"] == 0
    assert got["pl_steps"] <= 1
    assert got["pl_mismatch"] < 0.15


def test_fails_one_changed_pl(cohort):
    from benchmark.run import LIMITS

    reg, _, ref, outs = cohort
    job = reference.read_vcfs(outs, reg.seq, len(reg.samples))
    iso = np.flatnonzero(reference.isolated(reg.variants, LENGTH))
    key = next(k for k in (reference.normalize(int(reg.variants.pos[v]), reg.variants.ref[v], reg.variants.alt[v],
                                               reg.seq) for v in iso) if k in job)
    gt, ad, pl = job[key]
    pl = pl.copy()
    s = int(np.argmax(pl.max(axis=1)))
    pl[s, int(np.argmax(pl[s]))] = 0      # the least likely genotype made as likely as the call
    job[key] = (gt, ad, pl)
    assert numbers(job, reg, ref)["pl_steps"] > LIMITS["pl_steps"]


def test_control_fails(cohort):
    """The reference in the program's place, from half of each sample's
    read pairs (the configuration's depth broken), fails the limits."""
    from benchmark.run import LIMITS

    reg, full, ref, _ = cohort
    half = [(r.pair // 2) % 2 == 0 for r in full.reads]
    ctl = reference.call_region(full.seq, full.variants, full.reads, keep=half)
    got = numbers(reference.control_calls(full, ctl), reg, ref)
    assert got["ad_gap"] > LIMITS["ad_gap"]
    assert got["pl_mismatch"] > LIMITS["pl_mismatch"]
    assert got["pl_steps"] > LIMITS["pl_steps"]
