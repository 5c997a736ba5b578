"""The benchmark's command from the checkout's root: on the card a short run
of a cell is correct; without a card it fails and prints no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(workload: str, seconds: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", "2147483801",
                           "--seconds", seconds, "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=900, env=env)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("runs where there is no GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["wgs30x.stream", "cohort48.pool"])
def test_a_short_run_is_correct_on_the_card(card, workload):
    out = _run(workload, "3")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}


def test_without_a_card_it_fails_and_prints_nothing(no_card):
    out = _run("wgs30x.stream", "1")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
