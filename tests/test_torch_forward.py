"""The fused genotyping step of the port (ops/hamming.py, ops/likelihood.py,
ops/genotype_step.py, entry.py) against the JAX package's on the same
seeded numpy inputs, on the CPU. With integer eps every output is an
integer below 2^24, so they must be equal; with float eps the float32 sums
may differ in order, held to rtol 1e-5. The shapes take N and pad codes,
odd read lengths and haplotype counts that are no multiple of 8, which the
int8 product pads."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from graphtyper_tpu.ops import genotype_step as ref_step
from graphtyper_tpu.ops import hamming as ref_hamming
from graphtyper_tpu.ops import likelihood as ref_likelihood
from graphtyper_tpu_torch import entry
from graphtyper_tpu_torch.ops import genotype_step, hamming, likelihood

# (R, L, H, A)
SHAPES = [(1, 1, 1, 2), (13, 7, 5, 3), (37, 151, 21, 4), (256, 160, 64, 8), (300, 33, 9, 16)]


def _inputs(R, L, H, A, seed, float_eps=False, codes=6):
    """Reads sampled from the windows with errors, N (4) and pad (5) codes
    in both, one allele a window."""
    rng = np.random.default_rng(seed)
    haps = rng.integers(0, 4, size=(H, L)).astype(np.uint8)
    reads = haps[rng.integers(0, H, size=R)].copy()
    for arr in (reads, haps):
        hit = rng.random(arr.shape) < 0.05
        arr[hit] = rng.integers(0, codes, size=int(hit.sum())).astype(np.uint8)
    hap_allele = np.zeros((H, A), dtype=np.float32)
    hap_allele[np.arange(H), rng.integers(0, A, size=H)] = 1.0
    eps = (rng.uniform(3.5, 9.5, size=R) if float_eps else rng.integers(4, 9, size=R)).astype(np.float32)
    return reads, haps, hap_allele, eps


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_mismatch_matrix_equals_jax(shape):
    R, L, H, _ = shape
    reads, haps, _, _ = _inputs(*shape, seed=R + L)
    got = hamming.mismatch_matrix(*_t(reads, haps))
    assert got.dtype == torch.int32 and got.shape == (R, H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_hamming.mismatch_matrix(reads, haps)))


def test_one_hot_acgt_zeroes_n_and_pad():
    codes = np.array([[0, 1, 2, 3, 4, 5, 15]], dtype=np.uint8)
    got = hamming.one_hot_acgt(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_hamming.one_hot_acgt(codes)))
    assert got.dtype == torch.int8 and int(got[0, 4:].sum()) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_genotype_forward_exact_with_integer_eps(shape):
    args = _inputs(*shape, seed=7 + shape[0])
    delta, B = genotype_step.genotype_forward(*_t(*args))
    ref_delta, ref_B = ref_step.genotype_forward(*args)
    np.testing.assert_array_equal(delta.numpy(), np.asarray(ref_delta))
    np.testing.assert_array_equal(B.numpy(), np.asarray(ref_B))


@pytest.mark.parametrize("max_mismatches", [0, 3, 10])
def test_genotype_forward_float_eps(max_mismatches):
    args = _inputs(211, 97, 27, 6, seed=5, float_eps=True)
    delta, B = genotype_step.genotype_forward(*_t(*args), max_mismatches=max_mismatches)
    ref_delta, ref_B = ref_step.genotype_forward(*args, max_mismatches=max_mismatches)
    np.testing.assert_array_equal(B.numpy(), np.asarray(ref_B))
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref_delta), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("float_eps", [False, True])
def test_score_update_matches_jax(float_eps):
    rng = np.random.default_rng(11)
    A = 7
    explains = [set(rng.choice(A + 2, size=rng.integers(0, 4), replace=False).tolist()) for _ in range(90)]
    B = likelihood.batch_explains_to_matrix(explains, A)
    np.testing.assert_array_equal(B, ref_likelihood.batch_explains_to_matrix(explains, A))
    eps = (rng.uniform(2, 9, 90) if float_eps else rng.integers(2, 9, 90)).astype(np.float32)
    dense = likelihood.score_update_dense(*_t(B, eps)).numpy()
    ref_dense = np.asarray(ref_likelihood.score_update_dense(B, eps, A))
    if float_eps:
        np.testing.assert_allclose(dense, ref_dense, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(dense, ref_dense)
        np.testing.assert_array_equal(likelihood.score_update_triangle(*_t(B, eps), A),
                                      ref_likelihood.score_update_triangle(B, eps, A))
    for got, want in zip(likelihood.triangle_indices(A), ref_likelihood.triangle_indices(A)):
        np.testing.assert_array_equal(got, want)


def test_entry_matches_graft_entry():
    fn, args = entry.entry("cpu")
    ref_fn, ref_args = ref_entry.entry()
    for got, want in zip(args, ref_args):
        np.testing.assert_array_equal(got.numpy(), want)
    assert all(a.device.type == "cpu" for a in args)
    delta, B = fn(*args)
    ref_delta, ref_B = ref_fn(*ref_args)
    assert delta.shape == (8, 8) and B.shape == (256, 8)
    np.testing.assert_array_equal(delta.numpy(), np.asarray(ref_delta))
    np.testing.assert_array_equal(B.numpy(), np.asarray(ref_B))
    assert float(B.sum()) > 0  # the reads hit their windows


def test_entry_asks_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        entry.entry()
