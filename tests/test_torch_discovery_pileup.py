"""First-pass aggregation parity of the torch port: `aggregate_rows` on the
CPU device against the JAX package's numpy twin `_aggregate_host` and its
jitted segment-sum `_jitted_agg_cached`. Integer counters: tolerance 0."""

import numpy as np
import pytest
import torch

from graphtyper_tpu.ops import discovery_pileup as ref
from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.ops.discovery_pileup import aggregate_rows, segment_counters


def _rows(seed, n, n_events):
    """Random rows; events whose id is a multiple of 7 get none, so empty
    segments (maxima clamped to 0) occur."""
    rng = np.random.default_rng(seed)
    ev = rng.integers(0, n_events, n)
    ev = np.where(ev % 7 == 0, (ev + 1) % n_events, ev)
    return dict(
        r_ev=np.sort(ev).astype(np.int32),
        r_dhq=rng.integers(-2, 3, n).astype(np.int32),
        r_dlq=rng.integers(-1, 2, n).astype(np.int32),
        r_bits=rng.integers(0, 16, n).astype(np.uint8),
        r_mapq=rng.integers(0, 61, n).astype(np.uint8),
        r_dist=rng.integers(0, 151, n).astype(np.int32),
        r_readpos=np.where(rng.random(n) < 0.7, rng.integers(0, 151, n), -1).astype(np.int64),
    )


def _args(r, n_events):
    return (r["r_ev"], r["r_dhq"], r["r_dlq"], r["r_bits"], r["r_mapq"], r["r_dist"],
            r["r_readpos"], n_events)


@pytest.mark.parametrize("seed,n,n_events", [(0, 5000, 300), (1, 40, 90), (2, 1, 1)])
def test_aggregate_rows_matches_host_twin(seed, n, n_events):
    r = _rows(seed, n, n_events)
    before = counters.COUNTS["pileup_rows"]
    got = aggregate_rows(*_args(r, n_events), device="cpu")
    want = ref.aggregate_rows(*_args(r, n_events), device=False)
    np.testing.assert_array_equal(got, want)
    assert counters.COUNTS["pileup_rows"] == before + n


def test_aggregate_rows_empty():
    r = _rows(0, 0, 5)
    got = aggregate_rows(*_args(r, 5), device="cpu")
    np.testing.assert_array_equal(got, ref.aggregate_rows(*_args(r, 5), device=False))


def test_segment_counters_match_jitted_with_overflow_segment():
    """The jitted op's own padded layout: rows past n go to the overflow
    segment ev == n_events and are dropped; empty events read 0."""
    n_events, n, n_pad = 200, 3000, 4096
    r = _rows(5, n, n_events)
    mat = np.zeros((6, n_pad), dtype=np.int32)
    for i, k in enumerate(("r_ev", "r_dhq", "r_dlq", "r_bits", "r_mapq", "r_dist")):
        mat[i, :n] = r[k]
    mat[0, n:] = n_events
    mat[4, n:] = 99  # overflow rows must not leak into any maximum
    want = np.asarray(ref._jitted_agg_cached()(mat, n_events))[:n_events]
    got = segment_counters(torch.from_numpy(mat), n_events).numpy()
    np.testing.assert_array_equal(got, want)
    host = ref._aggregate_host(mat[:, :n].astype(np.int64), n_events)
    np.testing.assert_array_equal(got, host)
    assert (got[::7, 6] == 0).all()  # empty segments clamp to 0
