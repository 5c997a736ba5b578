"""The port's torch device ops on the card against the same ops on the CPU
(which tests/test_torch_site_scoring.py and test_torch_discovery_pileup.py
hold to the JAX package): scoring `apply_tier` and the pileup's
`segment_counters`. Integer outputs, tolerance 0. Skips without a GPU; run
on the card with  python -m pytest tests/test_torch_ops_cuda.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_discovery_pileup import _rows
from test_torch_site_scoring import _padded_matrix, _random_cols

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("A", [2, 4, 8, 64])
def test_apply_tier_cuda_matches_cpu(cuda, A):
    from graphtyper_tpu_torch.ops.site_scoring import apply_tier

    rng = np.random.default_rng(200 + A)
    n_sites, n_samples = 57, 4
    mat = torch.from_numpy(_padded_matrix(_random_cols(rng, 5000, A, n_sites, n_samples), 5000, 5120))
    got = apply_tier(mat.to(cuda), A, n_sites, n_samples).cpu()
    want = apply_tier(mat, A, n_sites, n_samples)
    assert torch.equal(got, want)


def test_segment_counters_cuda_matches_cpu(cuda):
    from graphtyper_tpu_torch.ops.discovery_pileup import segment_counters

    r = _rows(9, 200_000, 7000)
    mat = torch.from_numpy(np.stack([r[k].astype(np.int64) for k in (
        "r_ev", "r_dhq", "r_dlq", "r_bits", "r_mapq", "r_dist")]))
    assert torch.equal(segment_counters(mat.to(cuda), 7000).cpu(), segment_counters(mat, 7000))
