"""Discovery parity of the torch port on the CPU device: the forked first
pass (`run_first_pass_rows`, `aggregate_cohort`) against the JAX package's
native first pass and its own split path, and the forked
`streamlined_discovery` (device pileup plus SW realignment) against the JAX
one on a noisy cohort whose realignment matters. Every compared value is an
integer or a string: the tolerance is 0."""

from dataclasses import replace

import numpy as np
import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.io.fasta import FastaFile
from graphtyper_tpu.pipeline.native_caller import _bam_bytes, _parse_bam_header_meta
from graphtyper_tpu.typer import discovery as ref_discovery
from graphtyper_tpu.typer import native_discovery as ref_nd
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.typer import discovery as port_discovery
from graphtyper_tpu_torch.typer import native_discovery as port_nd

# a cohort whose realignment outcomes change the emitted sites: with every
# SW result discarded, discovery keeps one indel fewer
CFG = SimConfig(region_length=50_000, coverage=10, n_samples=4, error_rate=0.02, out_format="bam",
                seed=2)
REGION = f"{CFG.chrom}:1-{CFG.region_length}"

FIELDS = (
    "hq_count", "lq_count", "proper_pairs", "first_in_pairs", "sequence_reversed", "clipped",
    "max_mapq", "max_distance", "uniq_pos1", "uniq_pos2", "uniq_pos3", "span", "max_log_qual",
    "has_indel_good_support", "has_realignment_support",
)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    sim = simulate_cohort(str(tmp_path_factory.mktemp("torch_discovery") / "sim"), CFG)
    fa = FastaFile(sim.fasta)
    reference = fa.fetch(CFG.chrom, 0, CFG.region_length)
    fa.close()
    files = []
    for p in sim.sams:
        data = _bam_bytes(p)
        files.append((data, _parse_bam_header_meta(data)[0].index(CFG.chrom)))
    return sim, reference, files


def _first_pass_state(out):
    """The first pass's state with each package's Event objects as their
    sort keys, so that the two packages' states compare."""
    buckets, sample_haps = out
    state = []
    for b in buckets:
        for ev in sorted(b.events, key=lambda e: e.sort_key()):
            info = b.events[ev]
            phase = sorted((e.sort_key(), n) for e, n in info.phase.items())
            state.append((ev.sort_key(), [getattr(info, f) for f in FIELDS], phase))
    haps = {
        ev.sort_key(): (sorted(e.sort_key() for e in h.ever_together),
                        sorted(e.sort_key() for e in h.always_together))
        for ev, h in sample_haps.items()
    }
    return state, haps


def test_first_pass_rows_match_reference(cohort):
    _sim, reference, files = cohort
    opts, port_opts = ref_config.current_options(), config.current_options()
    for data, target in files:
        want = _first_pass_state(ref_nd.run_first_pass_native(data, target, 0, reference, opts))
        assert _first_pass_state(ref_nd.run_first_pass_rows(data, target, 0, reference, opts)) == want
        got = port_nd.run_first_pass_rows(data, target, 0, reference, port_opts, "cpu")
        assert _first_pass_state(got) == want
        assert want[0], "the first pass found no events"


def test_aggregate_cohort_matches_reference(cohort):
    _sim, reference, files = cohort
    xs = [ref_nd.fp_extract(data, target, 0, reference) for data, target in files]
    assert all(x is not None for x in xs)
    before = counters.COUNTS["pileup_rows"]
    got = port_nd.aggregate_cohort(xs, "cpu")
    want = ref_nd.aggregate_cohort(xs)
    assert len(got) == len(want) == len(files)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert counters.COUNTS["pileup_rows"] == before + sum(len(x["r_ev"]) for x in xs)


def _variants(vcf):
    return [(v.abs_pos, v.seqs, sorted(v.infos.items())) for v in vcf.variants]


@pytest.mark.parametrize("device_discovery", ["auto", "on", "off"])
def test_streamlined_discovery_matches_reference(cohort, device_discovery):
    sim, _reference, _files = cohort
    for cfg in (config, ref_config):  # each package reads its own options
        cfg.set_options(replace(cfg.DEFAULT_OPTIONS, device_discovery=device_discovery))
    counters.reset()
    try:
        ref_names: list[str] = []
        want = ref_discovery.streamlined_discovery(list(sim.sams), sim.fasta, REGION, ref_names)
        names: list[str] = []
        got = port_discovery.streamlined_discovery(list(sim.sams), sim.fasta, REGION, names, "cpu")
    finally:
        for cfg in (config, ref_config):
            cfg.set_options(cfg.DEFAULT_OPTIONS)
    assert names == ref_names
    assert _variants(got) == _variants(want)
    assert any(len(s) != 1 for v in got.variants for s in v.seqs), "no indel was discovered"
    seen = counters.totals()
    assert seen.get("sw_plain", 0) >= 1, seen  # realignment reached the SW path
    assert (seen.get("pileup_rows", 0) > 0) == (device_discovery != "off"), seen
