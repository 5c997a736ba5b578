"""Pools that run at once must not free each other's prepared reads.

`call_pools` runs min(threads, pools) pools in threads, and `split_pools`
makes one pool a thread, so a cohort of more files than the prepared-pool
cache holds (4) evicts entries that other pool threads still read. The
port pins each entry while a pool uses it (pipeline/native_caller.py
`_get_prep`, `_PrepEntry.release`). Held here: the port's CLI on the CPU
device at --threads 8 on tests/pipeline/test_pool_merge.py's 6-sample
cohort writes the JAX package's single-thread VCF every time, and the
cache frees no entry before its last release."""

import gzip
import os
import random
import subprocess
import sys
import threading
from dataclasses import replace

import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline.genotype import genotype as ref_genotype
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.io.native import get_lib
from graphtyper_tpu_torch.pipeline import native_caller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/pipeline/test_pool_merge.py test_multi_pool_genotype_identical
POOL_MERGE = SimConfig(region_length=5000, coverage=14.0, n_samples=6, seed=51)
RUNS = 3


def _masked(path):
    """The uncompressed VCF with its ##fileDate line masked."""
    with gzip.open(path, "rt") as f:
        return ["##fileDate=" if line.startswith("##fileDate=") else line for line in f.read().splitlines()]


@pytest.fixture(scope="module")
def pool_merge(tmp_path_factory):
    root = tmp_path_factory.mktemp("pool_concurrency")
    sim = simulate_cohort(str(root / "sim"), POOL_MERGE)
    old = ref_config.current_options()
    try:
        ref_config.set_options(replace(old, threads=1, max_files_open=864))
        ref = ref_genotype(sim.fasta, sim.sams, f"{POOL_MERGE.chrom}:1-5000", str(root / "ref"))
    finally:
        ref_config.set_options(old)
    return sim, root, _masked(ref)


@pytest.mark.parametrize("run", range(RUNS))
def test_eight_threads_six_pools_match_reference(pool_merge, run):
    """Six single-file pools at once in a fresh process (a crash fails the
    test, not the worker), against the JAX package's run at threads=1."""
    sim, root, want = pool_merge
    out = str(root / f"port_{run}")
    argv = [sys.executable, "-m", "graphtyper_tpu_torch.cli", "genotype", sim.fasta, "--region",
            f"{POOL_MERGE.chrom}:1-5000", "-O", out, "--threads", "8", "--device", "cpu"]
    for s in sim.sams:
        argv += ["--sam", s]
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    outs = proc.stdout.split()
    assert len(outs) == 1
    got = _masked(outs[0])
    assert any(not line.startswith("#") for line in got)
    assert got == want


class _CountingLib:
    """The engine with its gt_call_prepare_bam and gt_prep_free calls
    counted; `in_use` counts the handles the test's users are reading, and
    freeing one of them fails. (The engine's allocator may hand a freed
    address out again, so handles are counted, not told apart.)"""

    def __init__(self, lib):
        self._lib = lib
        self.prepared = 0
        self.freed = []
        self.in_use = {}
        self.lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def gt_call_prepare_bam(self, *args):
        handle = self._lib.gt_call_prepare_bam(*args)
        with self.lock:
            self.prepared += 1
        return handle

    def gt_prep_free(self, handle):
        with self.lock:
            assert self.in_use.get(handle, 0) == 0, "freed a prepared pool that a user still reads"
            self.freed.append(handle)
        self._lib.gt_prep_free(handle)


@pytest.fixture()
def single_file_pools(tmp_path, monkeypatch):
    """Six one-file BAM pools, an empty cache, and the counting engine; the
    entries left in the cache are freed afterwards."""
    cfg = SimConfig(region_length=3000, coverage=5.0, n_samples=6, seed=51, out_format="bam")
    sim = simulate_cohort(str(tmp_path / "sim"), cfg)
    lib = get_lib()
    native_caller._setup_lib(lib)
    cache = {}
    monkeypatch.setattr(native_caller, "_PREP_CACHE", cache)
    counting = _CountingLib(lib)
    region = GenomicRegion.parse(f"{cfg.chrom}:1-{cfg.region_length}")

    def get(i):
        return native_caller._get_prep(counting, [sim.sams[i]], region, 3840, False)

    yield get, counting, cache
    for entry in cache.values():
        assert entry.pins == 0
        entry._free(lib)


def test_no_free_until_the_last_release(single_file_pools):
    get, lib, _ = single_file_pools
    entries = [get(i) for i in range(6)]
    handles = [e.handle for e in entries]
    assert len(set(handles)) == 6 and all(h for h in handles)
    # four fit in the cache; the first two are evicted but still pinned
    assert [e.cached for e in entries] == [False, False, True, True, True, True]
    assert lib.freed == []
    assert get(5) is entries[5]  # a hit on a live entry takes another pin
    assert entries[5].pins == 2
    for i, e in enumerate(entries):
        e.release(lib)
        # only the evicted entries go, each at its last release
        assert lib.freed == handles[: min(i + 1, 2)]
    assert entries[0].handle is None and entries[0].kmers_dev is None
    assert entries[5].pins == 1 and entries[5].handle == handles[5]
    entries[5].release(lib)
    assert lib.freed == handles[:2]


def test_threads_never_free_a_pinned_pool(single_file_pools):
    """Eight threads take and release random pools of six, so entries are
    evicted while others read them. No handle is freed while in use, and
    every prepared pool not in the cache at the end was freed once."""
    get, lib, cache = single_file_pools
    old = sys.getswitchinterval()
    errors = []

    def user(seed):
        rng = random.Random(seed)
        try:
            for _ in range(25):
                entry = get(rng.randrange(6))
                with lib.lock:
                    lib.in_use[entry.handle] = lib.in_use.get(entry.handle, 0) + 1
                handle = entry.handle
                assert handle is not None and entry.n_rows > 0
                with lib.lock:
                    lib.in_use[handle] -= 1
                entry.release(lib)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=user, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert 0 < len(lib.freed) == lib.prepared - len(cache)
    assert all(e.pins == 0 for e in cache.values())
