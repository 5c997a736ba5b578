"""The port's row-scan SW (`ops/sw_pallas.py sw_align_pallas`) on the CPU
against the JAX package's `sw_align_pallas` in interpret mode, as
tests/ops/test_sw.py:113 runs it, and the SW microbench entry point
`tools.bench_sw` on the CPU device. Every output is an integer: the
tolerance is 0. The CUDA kernel itself is held on the card
(tests/test_torch_sw_cuda.py, chip_smoke.py)."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphtyper_tpu.ops.sw_pallas import sw_align_pallas as ref_sw_align_pallas
from graphtyper_tpu_torch import counters
from graphtyper_tpu_torch.ops import sw_rot
from graphtyper_tpu_torch.ops.sw_pallas import sw_align_pallas, sw_align_plain
from test_torch_sw_batches import e_tie_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
# one shape for every batch, so the interpret-mode kernel compiles once
B, MX, NX = 16, 24, 128


def _batch(seed, *, alphabet=4, noisy=True, qlen=None, dlen=None, iupac=False):
    """Seeded numpy batch: random pairs, half of them noisy copies of a
    database window unless `noisy` is False. `qlen` / `dlen` give the
    length ranges [lo, hi]."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(*(qlen or (8, MX)), size=B, endpoint=True).astype(np.int32)
    dlens = rng.integers(*(dlen or (30, NX)), size=B, endpoint=True).astype(np.int32)
    Q = np.full((B, MX), 5, dtype=np.uint8)
    D = np.full((B, NX), 5, dtype=np.uint8)
    for b in range(B):
        Q[b, : qlens[b]] = rng.integers(0, alphabet, qlens[b])
        D[b, : dlens[b]] = rng.integers(0, alphabet, dlens[b])
        m = qlens[b]
        if noisy and b % 2 == 0 and dlens[b] >= m:
            st = rng.integers(0, dlens[b] - m + 1)
            Q[b, :m] = D[b, st : st + m]
            Q[b, rng.integers(0, m)] = rng.integers(0, 4)
        if iupac:
            Q[b, rng.integers(0, MX, 2)] = 4
            D[b, rng.integers(0, NX, 4)] = rng.integers(4, 6, 4)
    return Q, qlens, D, dlens


def _ties():
    """Two-letter pairs and repeats: many equal-score alignments, so the
    begin/end tie rules decide the output."""
    Q, qlens, D, dlens = _batch(41, alphabet=2)
    motif = np.array([0, 1, 1], np.uint8)
    D[:4] = np.resize(motif, NX)
    Q[:4] = np.resize(motif, MX)
    Q[1, 6:9] = 3  # a substitution run inside the repeat
    Q[2, :12] = D[2, 5:17]  # a deletion of 4 bases inside the repeat
    Q[2, 12:] = D[2, 21 : 21 + MX - 12]
    return Q, qlens, D, dlens


def _query_length_edges():
    """qlen = 1 and qlen = M."""
    Q, qlens, D, dlens = _batch(42)
    qlens[::2] = 1
    qlens[1::2] = MX
    return Q, qlens, D, dlens


CASES = {
    "random": lambda: _batch(40, noisy=False),
    "noisy_copies": lambda: _batch(43),
    "ties": _ties,
    "query_length_edges": _query_length_edges,
    "dlen_below_qlen": lambda: _batch(44, qlen=(16, MX), dlen=(2, 15)),
    "codes_4_and_5": lambda: _batch(45, iupac=True),
    "e_ties": lambda: e_tie_batch(46, B, MX, NX),
}


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_interpret(case):
    Q, qlens, D, dlens = CASES[case]()
    want = ref_sw_align_pallas(Q, qlens, D, dlens, block_b=8, interpret=True)
    got = sw_align_pallas(*_tensors(Q, qlens, D, dlens))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _earliest_running_argmax(T):
    """The E scan with the other tie rule: the earliest column among equal
    prefix values."""
    cummax = torch.cummax(T, dim=1).values
    before = torch.cat([torch.full_like(cummax[:, :1], torch.iinfo(T.dtype).min), cummax[:, :-1]], 1)
    idx = torch.arange(T.shape[1], dtype=torch.int64)
    return cummax, torch.cummax(torch.where(T > before, idx[None, :], 0), dim=1).values


def test_e_ties_separate_the_scan_tie_rules(monkeypatch):
    """On the E-tie batch the Pallas kernel's rule (the latest column wins,
    sw_pallas.py:55) and the opposite rule give different database begins
    on most pairs, so a kernel that breaks the rule fails the batch."""
    Q, qlens, D, dlens = CASES["e_ties"]()
    want = [np.asarray(w) for w in ref_sw_align_pallas(Q, qlens, D, dlens, block_b=8, interpret=True)]
    t = _tensors(Q, qlens, D, dlens)
    monkeypatch.setattr(sw_rot, "_running_argmax", _earliest_running_argmax)
    flipped = [x.numpy() for x in sw_align_plain(*t)]
    np.testing.assert_array_equal(flipped[0], want[0])  # the same scores
    assert (flipped[1] != want[1]).sum() >= B // 2


def test_cpu_tensor_routes_to_plain():
    Q, qlens, D, dlens = _ties()
    t = _tensors(Q, qlens, D, dlens)
    before = counters.totals()
    got = sw_align_pallas(*t)
    after = counters.totals()
    assert after.get("sw_plain", 0) == before.get("sw_plain", 0) + 1
    assert after.get("sw_row", 0) == before.get("sw_row", 0)
    for w, g in zip(sw_align_plain(*t), got):
        np.testing.assert_array_equal(w.numpy(), g.numpy())


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A tensor off the CPU takes the kernel route and never the plain
    version: with no nvcc the build fails and the call raises. Meta tensors
    stand in for CUDA tensors here."""
    from graphtyper_tpu_torch import kernels

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernel_build")
    monkeypatch.setattr(kernels, "_LIB", None)
    q = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    d = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    ln = torch.zeros(4, dtype=torch.int32, device="meta")
    plain_before = counters.COUNTS["sw_plain"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sw_align_pallas(q, ln, d, ln)
    assert counters.COUNTS["sw_plain"] == plain_before


@pytest.mark.parametrize("kernel", ["--row", "--rot"])
def test_bench_sw_cpu_reports_parity(kernel):
    proc = subprocess.run(
        [sys.executable, "-m", "graphtyper_tpu_torch.tools.bench_sw", kernel, "--device", "cpu",
         "--pairs", "16"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "parity OK on 16 alignments" in proc.stdout, proc.stdout
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["parity"] and last["device"] == "cpu" and last["pairs"] == 16
    assert last["launches"] == {"sw_plain": 1}  # the plain version, never a kernel


def test_bench_sw_without_card_raises(monkeypatch):
    from graphtyper_tpu_torch.tools import bench_sw

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench_sw.main(["--row", "--pairs", "4"])


def test_bench_batch_is_the_jax_tools():
    """The tool's batch generator is tools/bench_sw.py:52-65 at B pairs:
    at B = 4096 the shapes, the length spread and the planted copies."""
    from graphtyper_tpu_torch.tools.bench_sw import make_batch

    q, qlens, d, dlens = make_batch()
    assert q.shape == (4096, 152) and d.shape == (4096, 256)
    assert qlens.max() == 152 and 32 <= qlens.min() < 152
    assert dlens.max() == 256 and 152 <= dlens.min() < 256
    hits = sum(bool((np.lib.stride_tricks.sliding_window_view(d[i], 152) == q[i]).sum(1).max() >= 148)
               for i in range(0, 64, 2))
    assert hits == 32
