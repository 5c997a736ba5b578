"""`genotype_sv` over several call pools against one pool, on the CPU: one
region that benchmark.gen makes from the `sv48` configuration (DEL, DUP,
INV and INS panel sites among its SNPs and indels, 30x, 2x151 bp).

- 24 samples at `--threads 1` (one streaming pool) and at `--threads 2`
  (two streaming pools of 12), with and without avg_cov_by_readlen (the
  COVERAGE model's per-pool slices): the same VCF bytes; the two pools
  stream at once and share one pool's batch of records.
- 8 of the samples at `--threads 1` and `--threads 8` (eight in-memory
  pools of one): the same VCF bytes.
- The `sv_pools` counter counts the pools of each call.
"""

import gzip
import hashlib
import os
import threading
from dataclasses import replace

import pytest

from benchmark import harness
from benchmark.gen import write_region
from benchmark.gen.bam import write_fasta
from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.pipeline import native_caller
from graphtyper_tpu_torch.pipeline.genotype import genotype_sv

SEED = 2**31 + 1234567
LENGTH = 60_000
N_SAMPLES = 24
#: the streaming caller, unpatched
STREAM = native_caller.run_native_call_pool_stream


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    """(work directory, FASTA, the region) of 24 samples."""
    tmp = str(tmp_path_factory.mktemp("torch_sv_pools"))
    cfg = dict(harness.load_json(harness.HERE, "configs", "sv48.json"), n_samples=N_SAMPLES)
    reg = write_region(SEED, 1, "r0", LENGTH, cfg, tmp)
    fasta = os.path.join(tmp, "ref.fa")
    write_fasta(fasta, [(reg.contig, reg.seq)])
    return tmp, fasta, reg


def _genotype_sv(region, monkeypatch, name: str, threads: int, bams: list, avg_cov) -> tuple:
    """(md5 of the VCF's bytes, each streamed pool's `batch_records`, the
    `sv_pools` counter) of one `genotype_sv` call at `threads`."""
    tmp, fasta, reg = region
    batches, lock = [], threading.Lock()

    def spy(*a, **kw):
        with lock:
            batches.append(kw["batch_records"])
        return STREAM(*a, **kw)

    monkeypatch.setattr(native_caller, "run_native_call_pool_stream", spy)
    config.set_options(replace(config.DEFAULT_OPTIONS, threads=threads))
    counters.reset()
    try:
        out = genotype_sv(fasta, reg.panel, bams, f"r0:1-{LENGTH}", os.path.join(tmp, name), "cpu",
                          avg_cov_by_readlen=avg_cov)
        pools = counters.totals()["sv_pools"]
    finally:
        config.set_options(config.DEFAULT_OPTIONS)
        counters.reset()
    with gzip.open(out, "rb") as f:
        body = f.read()
    assert b"AGGREGATED" in body
    return hashlib.md5(body).hexdigest(), batches, pools


@pytest.mark.parametrize("with_cov", [False, True])
def test_two_streaming_pools_write_the_vcf_of_one(region, monkeypatch, with_cov):
    bams = region[2].bams
    avg_cov = [30 / 151] * len(bams) if with_cov else None
    one, one_batches, one_pools = _genotype_sv(region, monkeypatch, f"one_{with_cov}", 1, bams, avg_cov)
    two, two_batches, two_pools = _genotype_sv(region, monkeypatch, f"two_{with_cov}", 2, bams, avg_cov)
    assert two == one
    assert (one_pools, two_pools) == (1, 2)
    assert one_batches == [native_caller.STREAM_BATCH_RECORDS]
    # both pools stream, and share one pool's batch between them
    assert len(two_batches) == 2 and sum(two_batches) <= native_caller.STREAM_BATCH_RECORDS


def test_eight_in_memory_pools_write_the_vcf_of_one(region, monkeypatch):
    bams = region[2].bams[:8]
    one, one_batches, one_pools = _genotype_sv(region, monkeypatch, "one8", 1, bams, None)
    eight, eight_batches, eight_pools = _genotype_sv(region, monkeypatch, "eight8", 8, bams, None)
    assert eight == one
    assert (one_pools, eight_pools) == (1, 8)
    assert one_batches == eight_batches == []
