"""The port's `genotype_sv` against the benchmark's plain SV reference
(benchmark/reference_sv.py), on the CPU: one region that benchmark.gen
makes from the `sv48` configuration's rates (DEL, DUP, INV and INS panel
sites among its SNPs and indels, 30x, 2x151 bp) at 8 samples and 200 kb
(28 SVs), scored through `benchmark.run.decide` with the cell's limits.

- Every SV but the insertions: `correct` under the cell's limits, and the
  deletions' and inversions' (SV, sample) pairs agree with the reference
  at 98 % or more.
- The insertions: the port calls a homozygous carrier 0/1 and drops some
  singletons (ROADMAP C.5), so their agreement is a strict expected
  failure, which a repair flips.
"""

import os

import numpy as np
import pytest

from benchmark import harness, reference_sv
from benchmark import run as bench_run
from benchmark.gen import write_region
from benchmark.gen.bam import write_fasta
from benchmark.gen.sv import SVs
from graphtyper_tpu_torch import config
from graphtyper_tpu_torch.pipeline.genotype import genotype_sv

SEED = 2**31 + 1234567
LENGTH = 200_000
N_SAMPLES = 8


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """The reference's GT and SVs, and the port's GT of each SV (0 where it
    wrote no record, as `reference_sv.compare` reads a missing one), and
    which SVs have a record."""
    tmp = str(tmp_path_factory.mktemp("torch_sv_reference"))
    cfg = dict(harness.load_json(harness.HERE, "configs", "sv48.json"), n_samples=N_SAMPLES)
    reg = write_region(SEED, 1, "r0", LENGTH, cfg, tmp)
    fasta = os.path.join(tmp, "ref.fa")
    write_fasta(fasta, [(reg.contig, reg.seq)])
    config.set_options(config.DEFAULT_OPTIONS)
    try:
        out = genotype_sv(fasta, reg.panel, reg.bams, f"r0:1-{LENGTH}", os.path.join(tmp, "out"), "cpu")
    finally:
        config.set_options(config.DEFAULT_OPTIONS)
    gt, svs = bench_run.sv_reference_gts(SEED, cfg, LENGTH, 1, "r0")
    calls = reference_sv.read_sv_vcfs([out], N_SAMPLES)
    got = np.stack([calls.get(i, np.zeros(N_SAMPLES, dtype=np.int64)) for i in svs.ids])
    return gt, svs, calls, got


def _subset(svs: SVs, keep: np.ndarray) -> SVs:
    idx = np.flatnonzero(keep)
    return SVs([svs.kind[j] for j in idx], svs.x1[idx], svs.size[idx], [svs.inserted[j] for j in idx],
               [svs.ids[j] for j in idx])


def _agreement(scored, kinds) -> tuple[int, int]:
    """(pairs, pairs that agree) over the (SV, sample) pairs of `kinds`
    that `compare` counts: SVs whole inside the region and EDGE from its
    ends, where either side calls an alternate allele."""
    gt, svs, _, got = scored
    inner = (svs.x1 - 1 >= reference_sv.EDGE) & (svs.x2 <= LENGTH - reference_sv.EDGE)
    mine = inner & np.isin(np.array(svs.kind), kinds)
    pairs = mine[:, None] & ((gt > 0) | (got > 0))
    return int(pairs.sum()), int((pairs & (got == gt)).sum())


def test_the_region_has_every_kind(scored):
    _, svs, _, _ = scored
    assert len(svs) >= 20 and set(svs.kind) == {"DEL", "DUP", "INV", "INS"}


def test_the_port_is_correct_but_for_insertions(scored):
    gt, svs, calls, _ = scored
    keep = np.array(svs.kind) != "INS"
    ok, numbers = bench_run.decide([reference_sv.compare(calls, _subset(svs, keep), LENGTH, gt[keep])],
                                   "genotype_sv")
    assert ok, numbers
    # every SV: the genotypes' share stays under its limit, insertions and all
    _, every = bench_run.decide([reference_sv.compare(calls, svs, LENGTH, gt)], "genotype_sv")
    assert every["sv_gt_mismatch"] <= bench_run.SV_LIMITS["sv_gt_mismatch"], every


def test_deletions_and_inversions_agree_with_the_reference(scored):
    pairs, agree = _agreement(scored, ["DEL", "INV"])
    assert pairs >= 30 and agree >= 0.98 * pairs, (pairs, agree)


@pytest.mark.xfail(strict=True, reason="ROADMAP C.5: genotype_sv calls a homozygous insertion 0/1 and drops "
                                       "insertion singletons (QUAL 0)")
def test_insertions_agree_with_the_reference(scored):
    gt, svs, calls, _ = scored
    pairs, agree = _agreement(scored, ["INS"])
    assert pairs > 0 and agree >= 0.98 * pairs, (pairs, agree)
    carried = [i for j, i in enumerate(svs.ids) if svs.kind[j] == "INS" and (gt[j] > 0).any()]
    assert all(i in calls for i in carried)
