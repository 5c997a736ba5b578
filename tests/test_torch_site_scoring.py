"""Observation scoring parity of the torch port: `apply_tier` against the
JAX package's jitted `_apply_tier_impl` (CPU) and its numpy twin
`_apply_rows_numpy`, and the port's `ObsBatcher` against the JAX one on the
same `add` stream. Every total is an integer: the tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtyper_tpu.graph import graph as ref_graph
from graphtyper_tpu.models import genotype_model as ref_model
from graphtyper_tpu.ops import site_scoring as ref
from graphtyper_tpu.ops.site_scoring import COV_PAD, OBS_FIELDS
from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.graph import graph as port_graph
from graphtyper_tpu_torch.models import genotype_model as port_model
from graphtyper_tpu_torch.ops import site_scoring as port


def _random_cols(rng, n, A, n_sites, n_samples):
    cols = {}
    cols["site"] = rng.integers(0, n_sites, n)
    cols["sample"] = rng.integers(0, n_samples, n)
    cols["eps"] = rng.integers(1, 60, n)
    cols["apply_score"] = rng.integers(0, 2, n)  # about half the rows score nothing
    mask = (1 << A) - 1 if A < 64 else (1 << 64) - 1
    bits = rng.integers(0, 1 << 63, n, dtype=np.uint64) | (rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63))
    bits &= np.uint64(mask)
    cols["bits_lo"] = (bits & np.uint64(0xFFFFFFFF)).astype(np.int64)
    cols["bits_hi"] = (bits >> np.uint64(32)).astype(np.int64)
    cols["cov"] = rng.integers(-2, A, n)  # includes COV_MULTI_REF/ALT
    cols["clipped_scaled"] = rng.integers(0, 100, n)
    cols["clipped_flag"] = rng.integers(0, 2, n)
    cols["mapq_sq"] = rng.integers(0, 60 * 60, n)
    cols["mm_scaled"] = rng.integers(0, 50, n)
    cols["sdiff"] = rng.integers(0, 30, n)
    cols["strand"] = rng.integers(0, 4, n)
    cols["proper"] = rng.integers(0, 2, n)
    return {k: cols[k].astype(np.int64) for k in OBS_FIELDS}


def _padded_matrix(cols, n, n_pad):
    """The JAX flush's chunk layout: n real rows, then padding rows with
    eps 0, bits 0, cov COV_PAD and zero scalars."""
    mat = np.zeros((len(OBS_FIELDS), n_pad), dtype=np.int32)
    mat[:, :n] = port.obs_matrix(cols, n)
    mat[OBS_FIELDS.index("cov"), n:] = COV_PAD
    return mat


@pytest.mark.parametrize("A", [2, 4, 8, 64])
def test_apply_tier_matches_reference(A):
    rng = np.random.default_rng(100 + A)
    n, n_pad, n_sites, n_samples = 733, 1024, 9, 3
    cols = _random_cols(rng, n, A, n_sites, n_samples)
    if A == 64:
        assert (cols["bits_hi"] >> 31).any(), "bit 63 must be exercised"
    mat = _padded_matrix(cols, n, n_pad)

    got = port.totals_to_numpy(
        port.split_totals(port.apply_tier(torch.from_numpy(mat), A, n_sites, n_samples), A, n_sites, n_samples)
    )
    jit = ref._split_out_vec(
        np.asarray(ref._jitted_apply_tier()(jnp.asarray(mat), A=A, n_sites=n_sites, n_samples=n_samples)),
        A, n_sites, n_samples,
    )
    host = ref._apply_rows_numpy(cols, n, A, n_sites, n_samples)
    assert got.keys() == jit.keys() == host.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(jit[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], host[k], err_msg=k)
    assert got["log_delta"].any() and got["pa_strand"].any()


def test_totals_round_trip():
    rng = np.random.default_rng(3)
    cols = _random_cols(rng, 50, 4, 5, 2)
    want = ref._apply_rows_numpy(cols, 50, 4, 5, 2)
    back = port.totals_to_numpy(port.totals_from_numpy(want, "cpu"))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _sites(cnums, n_samples, graph, model):
    """Sites of one package (its graph and genotype-model modules)."""
    sites = []
    for i, c in enumerate(cnums):
        s = model.HaplotypeSite(graph.Genotype(id=100 + i, num=c, first_variant_node=0))
        s.clear_and_resize_samples(n_samples)
        sites.append(s)
    return sites


def _feed(batcher, rng, cnums, n_rows, n_samples):
    """One deterministic `add` stream, rows spread over every tier."""
    for _ in range(n_rows):
        site = int(rng.integers(0, len(cnums)))
        c = cnums[site]
        explains = {int(a) for a in rng.integers(0, c, int(rng.integers(1, 4)))}
        batcher.add(
            site, c, int(rng.integers(0, n_samples)), int(rng.integers(1, 40)), explains,
            int(rng.integers(-2, c)), int(rng.integers(0, 90)), int(rng.integers(0, 2)),
            int(rng.integers(0, 3600)), int(rng.integers(0, 40)), int(rng.integers(0, 20)),
            int(rng.integers(0, 4)), int(rng.integers(0, 2)),
        )


def _site_state(sites):
    out = []
    for s in sites:
        vs = s.var_stats
        out.append((
            s.log_scores.tolist(), s.gt_coverages.tolist(), vs.clipped_reads, vs.mapq_squared,
            [(p.clipped_bp, p.mapq_squared, p.mismatches, p.score_diff) for p in vs.per_allele],
            [(r.r1_forward, r.r2_forward, r.r1_reverse, r.r2_reverse) for r in vs.read_strand],
            [(h.max_log_score, h.ambiguous_depth, h.ambiguous_depth_alt, h.alt_proper_pair_depth)
             for h in s.hap_samples],
        ))
    return out


def test_obs_batcher_matches_reference():
    """Same add stream into both batchers: equal flushed totals per tier
    (through totals_to_numpy), then equal materialized site state."""
    cnums = [2, 3, 2, 5, 8, 2, 40, 4]
    n_samples = 3
    ref_sites = _sites(cnums, n_samples, ref_graph, ref_model)
    port_sites = _sites(cnums, n_samples, port_graph, port_model)
    rb = ref.ObsBatcher(ref_sites, n_samples)
    pb = port.ObsBatcher(port_sites, n_samples, "cpu")
    _feed(rb, np.random.default_rng(8), cnums, 600, n_samples)
    _feed(pb, np.random.default_rng(8), cnums, 600, n_samples)
    assert sorted(pb.tiers) == sorted(rb.tiers) == [2, 4, 8, 64]

    before = counters.COUNTS["scoring_rows"]
    for tier in sorted(rb.tiers):
        rb._flush_tier(tier, rb.tiers[tier])
        pb._flush_tier(tier, pb.tiers[tier])
        for k, v in rb._totals[tier].items():
            np.testing.assert_array_equal(pb._totals[tier][k], v, err_msg=f"tier {tier} {k}")
    assert counters.COUNTS["scoring_rows"] == before + 600

    _feed(rb, np.random.default_rng(9), cnums, 300, n_samples)
    _feed(pb, np.random.default_rng(9), cnums, 300, n_samples)
    rb.finalize()
    pb.finalize()
    np.testing.assert_array_equal(pb._eps_sum, rb._eps_sum)
    assert _site_state(port_sites) == _site_state(ref_sites)
    assert any(np.asarray(s.log_scores).any() for s in port_sites)


def test_site_scorer_refuses_host_scoring():
    """device_scoring="off" would pick the JAX package's host loop; the port
    refuses it instead of ignoring it."""
    from dataclasses import replace

    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options
    from graphtyper_tpu_torch.typer.scoring import SiteScorer

    set_options(replace(DEFAULT_OPTIONS, device_scoring="off"))
    try:
        with pytest.raises(ValueError, match="device_scoring"):
            SiteScorer(None, ["s0"], "cpu")
    finally:
        set_options(DEFAULT_OPTIONS)
