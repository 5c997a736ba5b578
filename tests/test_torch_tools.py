"""The port's repo tools on the CPU device, against the JAX package:

- tools/fuzz_diff: seed 1 (a 2-sample BAM cohort) with every leg clean,
  and its reference run's records equal to graphtyper_tpu's `genotype` on
  the same cohort;
- tools/soak_population: a reduced recipe (8 samples x 60 kb x 8x, two
  region units over 2 region workers, max_files_open 2 so sam_merge
  chunking and the multi-pool reduction engage) whose record md5 equals
  graphtyper_tpu's `genotype_regions` on the same cohort at threads=1 (the
  JAX package's prepared-pool cache frees pools in use at more threads)."""

import json
import os
from dataclasses import replace

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline import genotype as ref_genotype
from graphtyper_tpu_torch import config
from graphtyper_tpu_torch.tools import fuzz_diff, soak_population


def _reset():
    for c in (config, ref_config):
        c.set_options(c.DEFAULT_OPTIONS)


FUZZ_LEGS = {"reference", "python_caller", "python_aligner", "stream_on", "threads1", "threads4", "host_sw",
             "bai", "cram", "cram_pyrans", "sam", "regions", "vcf_mode", "popvcf", "sv", "device_align",
             "device_seed"}


def test_fuzz_seed_clean_and_reference_matches_jax(tmp_path):
    _reset()
    try:
        res = fuzz_diff.fuzz_seed(1, str(tmp_path / "fuzz"), "cpu")
        assert res.fails == []
        assert set(res.walls) == FUZZ_LEGS  # a BAM seed on the CPU runs every leg but "cpu"
        ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, threads=1))
        want = ref_genotype.genotype(res.sim.fasta, res.sim.sams, res.region, str(tmp_path / "jax"))
    finally:
        _reset()
    got = fuzz_diff.vcf_text(res.ref_out)
    assert len(got) > 3 and got == fuzz_diff.vcf_text(want)


def test_soak_reduced_recipe_matches_jax(tmp_path, capsys):
    cache = str(tmp_path / "soak")
    _reset()
    try:
        rc = soak_population.main(["--samples", "8", "--kb", "60", "--coverage", "8", "--processes", "2",
                                   "--max-files-open", "2", "--device", "cpu", "--cache", cache])
        out = capsys.readouterr().out.strip().splitlines()
        _reset()
        with open(os.path.join(cache, "meta.json")) as f:
            meta = json.load(f)
        ref_config.set_options(replace(ref_config.DEFAULT_OPTIONS, threads=1, max_files_open=2))
        want = ref_genotype.genotype_regions(meta["fasta"], meta["sams"], "chrP:1-60000",
                                             str(tmp_path / "jax"), processes=1)
    finally:
        _reset()
    assert rc == 0 and out[-2].startswith("rss: ")
    got = json.loads(out[-1])
    assert set(got) == {"samples", "kb", "coverage", "n_reads", "wall_s", "reads_per_sec", "peak_tree_rss_mb",
                        "n_records", "md5"}
    md5, n_records = soak_population.records_md5(want)
    assert len(want) == 2 and got["n_records"] == n_records > 0 and got["md5"] == md5
    assert got["n_reads"] == meta["n_reads"] > 0 and 0 < got["peak_tree_rss_mb"] < 12000
