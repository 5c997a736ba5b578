"""The benchmark's input generator: regions of a configuration, made from
the seed, written as indexed BAMs beside one FASTA.

`make_inputs` draws every region from its own stream of the seed (region
i of seed s is the same whatever the other regions are), so the warm-up
region and the K regions in rotation are made alike. A configuration with
an `svs` block (benchmark/gen/sv.py) also places structural variants,
draws them from a second stream of the region, and writes each region's
sites-only SV panel beside its BAMs; without the block nothing changes."""

from __future__ import annotations

import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np

from benchmark.gen import sv as sv_model
from benchmark.gen.bam import write_bam, write_fasta
from benchmark.gen.model import Reads, Variants, haplotype, make_variants, neutral_genotypes, neutral_site_rate, \
    own_site_genotypes, random_reference, simulate_reads


@dataclass
class Region:
    """One simulated region: a contig of its own, the truth, and each
    sample's reads and BAM path."""

    contig: str
    seq: np.ndarray
    variants: Variants
    genotypes: np.ndarray        # [V, n_samples, 2] alleles
    samples: list[str]
    reads: list[Reads]
    bams: list[str]
    n_reads: int = 0
    svs: sv_model.SVs | None = None     # with an `svs` block: the SVs,
    sv_genotypes: np.ndarray | None = None   # [N, n_samples, 2] their alleles,
    panel: str = ""                      # and the panel VCF's path once written


def make_region(seed: int, index: int, contig: str, length: int, cfg: dict) -> Region:
    """Region `index` of `seed` under configuration `cfg` (the shapes of a
    configuration file), with its reads; no file is written."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    seq = random_reference(rng, length)
    n = cfg["n_samples"]
    spec = cfg.get("svs")
    svs = sv_gts = None
    blocked = []
    if spec:
        sv_rng = np.random.default_rng(np.random.SeedSequence([seed, index, 1]))
        svs = sv_model.make_svs(sv_rng, seq, spec, cfg["read_length"])
        sv_gts = sv_model.sv_genotypes(sv_rng, spec, len(svs), n)
        blocked = svs.zones()
    if cfg["genotypes"] == "neutral":
        rate, indel_share = neutral_site_rate(cfg["theta"], 2 * n), cfg["indel_share"]
    else:
        rate, indel_share = cfg["snp_rate"], cfg["indel_rate"] / cfg["snp_rate"]
    free = length - sum(b - a for a, b in blocked)
    n_sites = round((free - 200) * rate)
    variants = make_variants(rng, seq, n_sites, round(n_sites * indel_share), cfg["max_indel_len"], blocked)
    gts = (neutral_genotypes if cfg["genotypes"] == "neutral" else own_site_genotypes)(rng, n_sites, n)
    n_pairs = int(cfg["coverage"] * length / (2 * cfg["read_length"]))
    samples = [f"{cfg['sample_prefix']}{s:03d}" for s in range(n)]
    reads = []
    for s in range(n):
        if svs is None:
            haps = [haplotype(seq, variants, gts[:, s, h]) for h in range(2)]
            reads.append(simulate_reads(rng, haps, n_pairs, cfg["read_length"], cfg["insert_mean"],
                                        cfg["insert_sd"], cfg["error_rate"], cfg["base_quality"]))
        else:
            haps = [sv_model.sv_haplotype(seq, variants, gts[:, s, h], svs, sv_gts[:, s, h]) for h in range(2)]
            reads.append(sv_model.simulate_sv_reads(rng, haps, n_pairs, cfg["read_length"], cfg["insert_mean"],
                                                    cfg["insert_sd"], cfg["error_rate"], cfg["base_quality"],
                                                    cfg["mapq"]))
    return Region(contig, seq, variants, gts, samples, reads, [], sum(len(r) for r in reads), svs, sv_gts)


def write_region(seed: int, index: int, contig: str, length: int, cfg: dict, out_dir: str) -> Region:
    """Region `index` of `seed`, written as one indexed BAM a sample under
    `out_dir`; the region keeps its truth and drops its reads."""
    r = make_region(seed, index, contig, length, cfg)
    for sample, reads in zip(r.samples, r.reads):
        path = os.path.join(out_dir, f"{r.contig}.{sample}.bam")
        write_bam(path, r.contig, len(r.seq), sample, reads, mapq=cfg["mapq"])
        r.bams.append(path)
    if r.svs is not None:
        r.panel = os.path.join(out_dir, f"{r.contig}.panel.vcf")
        sv_model.write_panel(r.panel, r.contig, r.seq, r.svs)
    r.reads = []
    return r


def make_inputs(seed: int, cfg: dict, length: int, n_regions: int, out_dir: str) -> tuple:
    """The warm-up region (contig `w`) and `n_regions` regions in rotation
    (contigs `r0`, `r1`, ...), one FASTA for all of them and one indexed
    BAM a sample and region under `out_dir`, a region a process in spawned
    processes, at most one a core (so that no region waits on another's
    hold of the interpreter). Returns (fasta, warm-up region, regions)."""
    os.makedirs(out_dir, exist_ok=True)
    names = ["w"] + [f"r{i}" for i in range(n_regions)]
    workers = min(os.cpu_count() or 1, len(names))
    with ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn")) as pool:
        regions = list(pool.map(write_region, [seed] * len(names), range(len(names)), names,
                                [length] * len(names), [cfg] * len(names), [out_dir] * len(names)))
    fasta = os.path.join(out_dir, "ref.fa")
    write_fasta(fasta, [(r.contig, r.seq) for r in regions])
    return fasta, regions[0], regions[1:]
