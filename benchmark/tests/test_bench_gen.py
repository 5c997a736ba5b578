"""The benchmark's generator: the model's promises, and files that the
port's readers read back."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark.gen import make_inputs, make_region
from benchmark.gen.model import haplotype

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def config(name: str, **over) -> dict:
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return {**json.load(f), **over}


def _hap_offsets(hpos: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return np.searchsorted(hpos, pos, side="left")


@pytest.mark.parametrize("error_rate", [0.0, 0.002])
def test_reads_follow_their_haplotype(error_rate):
    cfg = config("wgs30x", error_rate=error_rate)
    reg = make_region(11, 1, "r0", 20_000, cfg)
    reads = reg.reads[0]
    L = cfg["read_length"]
    plain = np.array([len(c) == 1 for c in reads.cigars])
    mism = 0
    for h in (0, 1):
        hseq, hpos = haplotype(reg.seq, reg.variants, reg.genotypes[:, 0, h])
        sel = np.flatnonzero(plain & (reads.pair % 2 == h))
        off = _hap_offsets(hpos, reads.pos[sel])
        assert (hpos[off] == reads.pos[sel]).all()
        win = np.lib.stride_tricks.sliding_window_view(hseq, L)[off]
        diff = reads.seq[sel] != win
        mism += int(diff.sum())
        # away from errors the read is its haplotype exactly
        if error_rate == 0:
            assert not diff.any()
    n_bases = int(plain.sum()) * L
    expected = error_rate * n_bases
    # Binomial(n, p) within 5 standard deviations (3/4 of errors change the base; all do here)
    assert abs(mism - expected) <= 5 * np.sqrt(expected + 1)


def test_counts_follow_the_configuration():
    cfg = config("cohort48")
    n, length = cfg["n_samples"], 50_000
    reg = make_region(3, 2, "r1", length, cfg)
    n_pairs = int(cfg["coverage"] * length / (2 * cfg["read_length"]))
    assert [len(r) for r in reg.reads] == [2 * n_pairs] * n
    assert reg.genotypes.shape == (len(reg.variants), n, 2)
    # Watterson's density for 96 haplotypes: theta * sum(1/i, i < 96)
    n_sites = len(reg.variants)
    assert n_sites == round((length - 200) * cfg["theta"] * sum(1 / i for i in range(1, 2 * n)))
    assert int((~reg.variants.is_snp).sum()) == round(n_sites * cfg["indel_share"])
    assert (reg.variants.pos[1:] >= reg.variants.ref_end[:-1] + 1).all()
    # the neutral spectrum: every site segregates, on i haplotypes with p ~ 1/i
    carriers = reg.genotypes.sum(axis=(1, 2))
    assert carriers.min() >= 1 and carriers.max() <= 2 * n - 1
    singletons = float((carriers == 1).mean())
    assert 0.5 / 5.136 < singletons < 2 / 5.136
    assert float((carriers <= 9).mean()) > 0.4
    # every seed makes the same amount of work: sites, carried alleles, genotypes
    other = make_region(4, 2, "r1", length, cfg)
    assert len(other.variants) == n_sites
    assert sorted(other.genotypes.sum(axis=(1, 2)).tolist()) == sorted(carriers.tolist())
    one = make_region(3, 2, "r1", length, config("wgs30x"))
    assert (one.genotypes.sum(axis=2) > 0).all()
    kinds = np.unique(one.genotypes[:, 0], axis=0, return_counts=True)[1]
    assert len(kinds) == 3 and kinds.max() - kinds.min() <= 1


def test_same_seed_same_bytes(tmp_path):
    cfg = config("wgs30x")
    outs = []
    for d in ("a", "b"):
        fasta, warm, regions = make_inputs(2**33 + 5, cfg, 20_000, 2, str(tmp_path / d))
        outs.append([open(p, "rb").read() for r in [warm, *regions] for p in (*r.bams, *(b + ".bai" for b in r.bams))]
                    + [open(fasta, "rb").read()])
    assert outs[0] == outs[1]
    fasta, warm, regions = make_inputs(2**33 + 6, cfg, 20_000, 2, str(tmp_path / "c"))
    assert open(regions[0].bams[0], "rb").read() != outs[0][2]


def test_files_read_back_through_the_port(tmp_path):
    from graphtyper_tpu_torch.io.bai import read_region_bam_bytes
    from graphtyper_tpu_torch.io.bam import read_alignments
    from graphtyper_tpu_torch.io.fasta import FastaFile

    cfg = config("cohort48", n_samples=2)
    fasta, warm, regions = make_inputs(9, cfg, 30_000, 1, str(tmp_path))
    reg = regions[0]
    again = make_region(9, 1, reg.contig, 30_000, cfg)
    fa = FastaFile(fasta)
    assert fa.fetch(reg.contig, 0, 30_000) == reg.seq.tobytes()
    fa.close()
    for bam, reads in zip(reg.bams, again.reads):
        header, got = read_alignments(bam, parse_tags=True)
        assert len(got) == len(reads)
        assert [r.pos for r in got] == reads.pos.tolist()
        assert [r.flag for r in got] == reads.flag.tolist()
        assert all(r.seq == bytes(s) for r, s in zip(got[:500], reads.seq[:500]))
        cig = [[(w & 0xF, w >> 4) for w in c.tolist()] for c in reads.cigars]
        assert [[tuple(x) for x in r.cigar] for r in got] == cig
        assert {r.tags["RG"] for r in got} == {"rg_" + os.path.basename(bam).split(".")[1]}
        # a region query through the index returns every read overlapping it
        raw = read_region_bam_bytes(bam, [(reg.contig, 10_000, 12_000)])
        sub = tmp_path / "sub.bam"
        from graphtyper_tpu_torch.io.bgzf import BgzfWriter

        with BgzfWriter(str(sub)) as w:
            w.write(raw)
        _, part = read_alignments(str(sub), parse_tags=False)
        want = set(np.flatnonzero((reads.pos < 12_000) & (reads.end > 10_000)).tolist())
        have = {i for i, r in enumerate(got) if r.pos < 12_000 and r.pos + sum(
            n for op, n in r.cigar if op in (0, 2)) > 10_000}
        assert want == have
        assert {(r.name, r.flag) for r in part} >= {(got[i].name, got[i].flag) for i in want}
