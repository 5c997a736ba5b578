"""The realignment order of discovery does not depend on the hash salt.

Discovery realigns the indels that lack good support, each with the good
indels near it, in one ordered list a file. `Event` hashes its `str` and
`bytes` fields, which Python salts per process (PYTHONHASHSEED), and the
list comes out of a set. The reference orders its events by position, then
I < D < X, then sequence (event.cpp:173-181), a total order; the JAX
package sorts by position alone, so two indels at one position keep the
set's order, which differs between processes. The port sorts by the full
key. Here a contig carries, at each of four positions, two insertions of
different sequences and a deletion, each on a few reads among reference
reads; the port's `genotype` runs on the CPU device in fresh processes
under several hash seeds, and the realigned indels' order, the SW
launches and the VCF bytes must be one. The JAX package runs under the
same seeds; whether its order varies is recorded, not asserted. The port's
VCF must be the JAX package's under every seed where the JAX package's
realignment order is the port's, and under every seed when the JAX
package's VCF does not vary with the seed."""

import fcntl
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
HASH_SEEDS = ("0", "1", "2")
AT_ONCE = 3  # processes running at a time
SITES = (600, 1200, 1800, 2400)


def tied_indel_input(out_dir: str, seed: int = 5, n_ref: int = 14, n_var: int = 7):
    """(fasta, sam, region): a 3 kb contig `chrT` and one sample's read
    pairs; at each of SITES, n_ref pairs from the reference and n_var from
    each of three haplotypes (+TTG, +CA, a 3 bp deletion), every pair within
    a fragment of the site so that its reads overlap all three indels."""
    from graphtyper_tpu_torch.utils.simulate import (
        _apply_haplotype, _cigar_from_positions, _random_seq, _write_fasta)

    rng = np.random.default_rng(seed)
    L, chrom, RL = 3000, "chrT", 151
    seq = _random_seq(rng, L)
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, "ref.fa")
    _write_fasta(fasta, chrom, seq)
    haps = [(seq, np.arange(L))]
    for p in SITES:
        base = seq[p : p + 1].tobytes()
        for ref, alt in ((base, base + b"TTG"), (base, base + b"CA"), (seq[p : p + 4].tobytes(), base)):
            haps.append(_apply_haplotype(seq, [(p, ref, alt)], np.array([1])))
    recs = []
    for k, p in enumerate(SITES):
        for h, n in [(0, n_ref)] + [(1 + 3 * k + j, n_var) for j in range(3)]:
            hs, hp = haps[h]
            for _ in range(n):
                frag = int(rng.integers(220, 280))
                lo = int(np.searchsorted(hp, p)) - frag + 40
                start = int(rng.integers(lo, lo + frag - 80))
                p1, p2 = int(hp[start]), int(hp[start + frag - RL])
                c1 = _cigar_from_positions(hp[start : start + RL])
                c2 = _cigar_from_positions(hp[start + frag - RL : start + frag])
                r1 = hs[start : start + RL].tobytes().decode()
                r2 = hs[start + frag - RL : start + frag].tobytes().decode()
                tlen, q, name = p2 + RL - p1, "I" * RL, f"r{len(recs)}"
                recs.append((p1, f"{name}\t99\t{chrom}\t{p1 + 1}\t60\t{c1}\t=\t{p2 + 1}\t{tlen}\t{r1}\t{q}\tRG:Z:rg"))
                recs.append((p2, f"{name}\t147\t{chrom}\t{p2 + 1}\t60\t{c2}\t=\t{p1 + 1}\t{-tlen}\t{r2}\t{q}\tRG:Z:rg"))
    recs.sort(key=lambda t: t[0])
    sam = os.path.join(out_dir, "s.sam")
    with open(sam, "w") as f:
        f.write(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{L}\n@RG\tID:rg\tSM:s0\n")
        for _, line in recs:
            f.write(line + "\n")
    return fasta, sam, f"{chrom}:1-{L}"


# one `genotype` run in a fresh process: the lists handed to
# realign_to_indels, the SW launches (the port's counters) and the md5 of
# the output VCF without its ##fileDate line
RUN = textwrap.dedent(
    """
    import gzip, hashlib, json, sys
    pkg, fasta, sam, region, out = sys.argv[1:6]
    sys.path.insert(0, sys.argv[6])
    import importlib
    disc = importlib.import_module(pkg + ".typer.discovery")
    genotype = importlib.import_module(pkg + ".pipeline.genotype").genotype
    orders = []
    realign = disc.realign_to_indels
    def recording(work, *a, **k):
        orders.append([e.to_string() for e in work])
        return realign(work, *a, **k)
    disc.realign_to_indels = recording
    if pkg == "graphtyper_tpu_torch":
        from graphtyper_tpu_torch import counters
        counters.reset()
        path = genotype(fasta, [sam], region, out, "cpu")
        launches = counters.totals().get("sw_plain", 0)
    else:
        path = genotype(fasta, [sam], region, out)
        launches = None
    h = hashlib.md5()
    with gzip.open(path, "rb") as f:
        for line in f:
            if not line.startswith(b"##fileDate"):
                h.update(line)
    print("RESULT " + json.dumps({"orders": orders, "launches": launches, "vcf_md5": h.hexdigest()}))
    """
)


def _run_all(tmp: pathlib.Path) -> dict:
    """{"package seed": the run's result}, AT_ONCE runs at a time."""
    fasta, sam, region = tied_indel_input(str(tmp / "in"))
    todo = [(pkg, seed) for pkg in ("graphtyper_tpu_torch", "graphtyper_tpu") for seed in HASH_SEEDS]
    results, running = {}, {}
    while todo or running:
        while todo and len(running) < AT_ONCE:
            pkg, seed = todo.pop(0)
            env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu")
            out = str(tmp / f"{pkg}_{seed}")
            running[pkg, seed] = subprocess.Popen(
                [sys.executable, "-c", RUN, pkg, fasta, sam, region, out, str(REPO)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        key = next(iter(running))
        out, err = running.pop(key).communicate(timeout=600)
        assert "RESULT " in out, (key, err[-4000:])
        results[" ".join(key)] = json.loads(out.split("RESULT ", 1)[1])
    return results


@pytest.fixture(scope="session")
def runs(tmp_path_factory):
    """{(package, hash seed): the run's result}. Under pytest-xdist the
    first worker to ask makes the runs and the others read its file."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        got = _run_all(tmp_path_factory.mktemp("realign_order"))
    else:
        shared = tmp_path_factory.getbasetemp().parent / "realign_order"
        shared.mkdir(exist_ok=True)
        with open(shared / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            done = shared / "results.json"
            if not done.exists():
                done.write_text(json.dumps(_run_all(shared)))
            got = json.loads(done.read_text())
    return {tuple(k.split(" ")): v for k, v in got.items()}


def test_input_ties_indels_at_one_position(runs):
    """The input is the case the order has to decide: a realignment list
    holds two or more indels at one position."""
    orders = runs["graphtyper_tpu_torch", HASH_SEEDS[0]]["orders"]
    assert orders
    positions = [e.split()[0] for work in orders for e in work]
    assert len(positions) > len(set(positions)), orders


def test_port_order_launches_and_vcf_do_not_depend_on_the_hash_seed(runs, record_property):
    port = [runs["graphtyper_tpu_torch", s] for s in HASH_SEEDS]
    for r in port[1:]:
        assert r["orders"] == port[0]["orders"]
        assert r["launches"] == port[0]["launches"]
        assert r["vcf_md5"] == port[0]["vcf_md5"]
    assert port[0]["launches"] > 0
    jax = [runs["graphtyper_tpu", s] for s in HASH_SEEDS]
    varies = any(r["orders"] != jax[0]["orders"] for r in jax[1:])
    jax_md5s = {r["vcf_md5"] for r in jax}
    record_property("jax_package_order_varies_with_hash_seed", varies)
    record_property("jax_package_vcf_varies_with_hash_seed", len(jax_md5s) > 1)
    print(f"JAX package: realignment order varies with PYTHONHASHSEED: {varies}")
    for seed, r in zip(HASH_SEEDS, jax):
        if r["orders"] == port[0]["orders"] or len(jax_md5s) == 1:
            assert r["vcf_md5"] == port[0]["vcf_md5"], seed


def test_port_order_is_the_reference_event_order(runs):
    """Within each realignment list, indels of one support class follow the
    reference's event order: position, then I < D < X, then sequence."""
    type_order = {"I": 0, "D": 1, "X": 2}
    for work in runs["graphtyper_tpu_torch", HASH_SEEDS[0]]["orders"]:
        keys = [(int(p), type_order[t], s) for p, t, s in (e.split() for e in work)]
        # the list is good-support indels, then the rest; each run sorted
        runs_sorted = [keys[0:1]]
        for prev, k in zip(keys, keys[1:]):
            if k < prev:
                runs_sorted.append([k])
            else:
                runs_sorted[-1].append(k)
        assert len(runs_sorted) <= 2, work
