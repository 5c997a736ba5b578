"""GT_SCORING_STATS of the port (ops/site_scoring.py _write_scoring_stats)
against the JAX package's on one cohort: one line per finalize with the
JAX line's keys, the same observation rows in all (host_rows +
device_rows), and with GT_DEVICE_ALIGN=on the same verdict rows
(align_rows). On the CPU device the port ships nothing to a card
(h2d_bytes 0), and it applies no row on the host path (host_rows 0)."""

import json
import os
from dataclasses import replace

import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.ops import site_scoring as ref_scoring
from graphtyper_tpu.pipeline import genotype as ref_genotype
from graphtyper_tpu_torch import config
from graphtyper_tpu_torch.ops import site_scoring
from graphtyper_tpu_torch.pipeline import genotype as port_genotype
from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = tmp_path_factory.mktemp("scoring_stats")
    cfg = SimConfig(region_length=30_000, coverage=16.0, n_samples=3, seed=71, out_format="bam",
                    error_rate=0.01)
    return simulate_cohort(str(d / "sim"), cfg), f"{cfg.chrom}:1-{cfg.region_length}"


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run(writer, fn, stats_path, device_align, monkeypatch):
    """Lines that `fn()` writes; the writer is called once before, so the
    first line holds only this run (each line is the change since the last)."""
    monkeypatch.setenv("GT_SCORING_STATS", stats_path + ".before")
    writer()
    monkeypatch.setenv("GT_SCORING_STATS", stats_path)
    monkeypatch.setenv("GT_DEVICE_ALIGN", device_align)
    try:
        fn()
    finally:
        monkeypatch.delenv("GT_DEVICE_ALIGN")
        monkeypatch.delenv("GT_SCORING_STATS")
    return _lines(stats_path)


@pytest.mark.parametrize("device_align", ["off", "on"])
def test_scoring_stats_match_jax(cohort, tmp_path, device_align, monkeypatch):
    sim, region = cohort
    for c in (config, ref_config):
        c.set_options(replace(c.DEFAULT_OPTIONS, threads=1))
    try:
        want = _run(ref_scoring._write_scoring_stats,
                    lambda: ref_genotype.genotype(sim.fasta, sim.sams, region, str(tmp_path / "ref")),
                    str(tmp_path / "ref.jsonl"), device_align, monkeypatch)
        got = _run(site_scoring._write_scoring_stats,
                   lambda: port_genotype.genotype(sim.fasta, sim.sams, region, str(tmp_path / "port"), "cpu"),
                   str(tmp_path / "port.jsonl"), device_align, monkeypatch)
    finally:
        for c in (config, ref_config):
            c.set_options(c.DEFAULT_OPTIONS)
    assert want and len(got) == len(want)  # one line per finalize
    for line in got:
        assert set(line) == set(want[0])
        assert line["pid"] == os.getpid()
        assert line["host_rows"] == 0 and line["host_apply_wall_s"] == 0 and line["h2d_bytes"] == 0

    def total(lines, *keys):
        return sum(line[k] for line in lines for k in keys)

    rows = total(got, "host_rows", "device_rows")
    assert rows > 0 and rows == total(want, "host_rows", "device_rows")
    assert total(got, "device_wall_s") > 0
    align = total(got, "align_rows")
    assert align == total(want, "align_rows")
    assert (align > 0) == (device_align == "on")
