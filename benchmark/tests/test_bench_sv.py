"""The harness's `genotype_sv` path and the span readers, on the CPU at a
small size: the dispatch leaves `genotype` cells as they were, the
generator's SV reads follow the aligner's rule, the SV reference calls
the truth, its control and fault read `correct` false, and whole runs of
a tiny SV cell from a BENCHMARK.json of the test's own read `correct`
false with the timed path broken underneath."""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import time

import numpy as np
import pytest

from benchmark import control, harness, reference_sv, spans
from benchmark import run as bench_run
from benchmark.gen import make_inputs, make_region

CONFIGS = os.path.join(harness.HERE, "configs")
SEED = 2**31 + 1234567


def config(name: str, **over) -> dict:
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return {**json.load(f), **over}


# ---- the `genotype` cells as before ---------------------------------------

#: sha256 of a configuration's inputs (3 samples at most, 20 kb, 2 regions in
#: rotation, SEED): every BAM and BAI, the FASTA and its .fai, and the truth;
#: and what `decide` makes of the control's and the fault's records. Both as
#: the parent of the SV generator made them.
BEFORE = {
    "wgs30x": ("7a198c9d0d91879669eeb32d6af754ce5d92367d1add8181d8212dde321ba84d",
               {"half_depth": {"pl_mismatch": 1.0, "ad_gap": 0.50177304964539, "pl_steps": 12, "false_sites": 0.0},
                "false_sites": {"pl_mismatch": 0.0, "ad_gap": 0.0, "pl_steps": 0,
                                "false_sites": 0.05405405405405406}}),
    "cohort48": ("f40a8121e80238a1f7d30a4d30c229368b3ef9b95cea6f0969741589d8640adf",
                 {"half_depth": {"pl_mismatch": 1.0, "ad_gap": 0.50814332247557, "pl_steps": 7, "false_sites": 0.0},
                  "false_sites": {"pl_mismatch": 0.0, "ad_gap": 0.0, "pl_steps": 0,
                                  "false_sites": 0.04285714285714286}}),
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_a_configuration_without_svs_makes_what_it_made(name, tmp_path):
    cfg = config(name)
    cfg["n_samples"] = min(cfg["n_samples"], 3)
    fasta, warm, regions = make_inputs(SEED, cfg, 20_000, 2, str(tmp_path))
    h = hashlib.sha256()
    for r in [warm, *regions]:
        assert r.svs is None and r.panel == ""
        for b in r.bams:
            h.update(open(b, "rb").read())
            h.update(open(b + ".bai", "rb").read())
    h.update(open(fasta, "rb").read())
    h.update(open(fasta + ".fai", "rb").read())
    for r in [warm, *regions]:
        h.update(r.variants.pos.tobytes())
        h.update(b"".join(r.variants.ref))
        h.update(b"".join(r.variants.alt))
        h.update(r.genotypes.tobytes())
    digest, numbers = BEFORE[name]
    assert h.hexdigest() == digest
    for fault, want in numbers.items():
        ok, got = bench_run.decide(control.fault_records(SEED, cfg, 30_000, 1, fault))
        assert ok is False and got == want
        assert set(got) == set(bench_run.LIMITS)


def test_traffic_without_a_subcommand_runs_genotype(monkeypatch, capsys):
    """A traffic file with no `subcommand` runs `genotype_regions` as it
    did, one CLI invocation a job, and the result's `limits` are the four
    numbers of a `genotype` cell."""
    from benchmark.tests.test_bench_harness import _run_cpu

    calls = []

    def record(real):
        def run(ref, sams, region, out, device, **kw):
            calls.append((len(sams), region, str(device), kw))
            return real(ref, sams, region, out, device, **kw)
        return run

    assert "subcommand" not in harness.load_json(harness.HERE, "traffic", "pool50k.json")
    res = _run_cpu(monkeypatch, capsys, "cohort48.pool", 4, wrap=record)
    assert res["correct"] is True
    assert list(res["limits"]) == list(bench_run.LIMITS)
    assert calls and all(c == (4, c[1], "cpu", {"avg_cov_by_readlen": None, "prior_vcf": None,
                                                "output_all_variants": False}) for c in calls)
    assert calls[0][1] == "w:1-30000" and all(c[1].endswith(":1-30000") for c in calls)
    jobs = bench_run.Jobs("ref.fa", [], "jobs", None)
    assert jobs.run == jobs.run_genotype


# ---- the generator's SVs ---------------------------------------------------

def _sv_config(**over) -> dict:
    cfg = config("sv48", n_samples=4, error_rate=0.0, theta=1e-12)
    cfg["svs"] = {**cfg["svs"], **over}
    return cfg


def test_sv_counts_follow_the_block():
    cfg = config("sv48", n_samples=8)
    a, b = make_region(SEED, 1, "r0", 200_000, cfg), make_region(SEED + 1, 1, "r0", 200_000, cfg)
    n = round(200_000 * cfg["svs"]["rate"])
    for r in (a, b):
        assert len(r.svs) == n and r.sv_genotypes.shape == (n, 8, 2)
        assert sorted(r.svs.kind) == sorted(a.svs.kind)
        assert sorted(r.svs.size.tolist()) == sorted(a.svs.size.tolist())
        assert sorted(r.sv_genotypes.sum(axis=(1, 2)).tolist()) == sorted(a.sv_genotypes.sum(axis=(1, 2)).tolist())
        assert set(r.svs.kind) == {"DEL", "DUP", "INV", "INS"}
        assert (r.svs.x1 - 1 >= 1000).all() and (r.svs.x2 + 1000 <= 200_000).all()
        # no SNP or indel enters an SV's zone
        for lo, hi in r.svs.zones():
            assert not ((r.variants.ref_end > lo) & (r.variants.pos < hi)).any()
        assert len({len(x) for x in r.reads}) == 1
    assert a.svs.x1.tolist() != b.svs.x1.tolist()


def _aligned(read_seq: np.ndarray, cigar: np.ndarray, pos: int):
    """(reference positions, read offsets) of the M bases, and the soft
    clips' lengths at the start and the end."""
    ref_at, read_at, r, q, clips = [], [], pos, 0, [0, 0]
    for k, w in enumerate(cigar.tolist()):
        op, n = w & 0xF, w >> 4
        if op == 0:
            ref_at += range(r, r + n)
            read_at += range(q, q + n)
            r, q = r + n, q + n
        elif op == 1:
            q += n
        elif op == 2:
            r += n
        elif op == 4:
            clips[0 if k == 0 else 1] = n
            q += n
    return np.array(ref_at), np.array(read_at), clips


def test_sv_reads_follow_the_aligner_rule():
    """With no errors and no small sites, every mapped read's aligned bases
    are the reference's; a read across a junction is clipped on its
    shorter side; a read in an inversion's inside is on the other strand
    there; a read wholly inside an insertion is unmapped at its mate's
    place (or has none); a pair is proper only where its reads face each
    other at an ordinary distance."""
    cfg = _sv_config(min_bp=200, max_bp=2000, shares={"DEL": 1, "DUP": 1, "INV": 1, "INS": 1})
    reg = make_region(SEED, 1, "r0", 60_000, cfg)
    assert len(reg.variants) == 0
    seen = {"clipped": 0, "read 1 reverse": 0, "unmapped": 0, "unplaced": 0, "improper": 0}
    inv = [(a, b) for k, a, b in zip(reg.svs.kind, reg.svs.x1.tolist(), reg.svs.x2.tolist()) if k == "INV"]
    for reads in reg.reads:
        placed = reads.pos >= 0
        assert (np.diff(reads.pos[placed]) >= 0).all() and placed[: placed.sum()].all()
        by_name = {}
        for i in range(len(reads)):
            by_name.setdefault(int(reads.pair[i]), []).append(i)
            flag, cig = int(reads.flag[i]), reads.cigars[i]
            if flag & 0x4:
                assert len(cig) == 0 and reads.mapq[i] == 0 and reads.tlen[i] == 0
                seen["unmapped"] += 1
                seen["unplaced"] += reads.pos[i] < 0
                continue
            ref_at, read_at, clips = _aligned(reads.seq[i], cig, int(reads.pos[i]))
            assert (reads.seq[i][read_at] == reg.seq[ref_at]).all()
            assert reads.end[i] == ref_at[-1] + 1
            if any(clips):
                seen["clipped"] += 1
                assert len(read_at) >= max(clips)
                # the clipped bases are not the reference's beside the alignment
                if clips[1] >= 10:
                    nxt = reg.seq[ref_at[-1] + 1 : ref_at[-1] + 1 + clips[1]]
                    assert (reads.seq[i][-clips[1]:][: len(nxt)] != nxt).any()
            elif any(a <= reads.pos[i] and reads.end[i] <= b for a, b in inv) and flag & 0x40:
                seen["read 1 reverse"] += bool(flag & 0x10)
        for i, j in by_name.values():
            fi, fj = int(reads.flag[i]), int(reads.flag[j])
            assert bool(fi & 0x8) == bool(fj & 0x4) and bool(fi & 0x20) == bool(fj & 0x10)
            if fi & 0x4 and not fj & 0x4:
                assert reads.pos[i] == reads.pos[j] and reads.mate_pos[j] == reads.pos[j]
            if not (fi & 0x4 or fj & 0x4):
                assert reads.mate_pos[i] == reads.pos[j] and reads.tlen[i] == -reads.tlen[j]
            seen["improper"] += not fi & 0x2
    assert all(v > 0 for v in seen.values()), seen


def test_an_inversion_read_is_the_other_strand():
    """Unclipped reads wholly inside an inversion: SEQ is the reference at
    their place on both haplotypes; read 1 lies on the reverse strand only in a
    sample that carries it (its inverted haplotype's reads), never in one
    that does not."""
    cfg = _sv_config(min_bp=1500, max_bp=1500, shares={"INV": 1}, rate=1 / 10_000)
    reg = make_region(SEED, 2, "r0", 30_000, cfg)
    a, b = int(reg.svs.x1[0]), int(reg.svs.x2[0])
    carried = reg.sv_genotypes[0].sum(axis=1)
    assert carried.any() and not carried.all()
    for s, reads in enumerate(reg.reads):
        whole = np.array([len(c) == 1 for c in reads.cigars])
        inside = np.flatnonzero((reads.pos >= a) & (reads.end <= b) & whole)
        assert len(inside) > 100
        for i in inside:
            assert (reads.seq[i] == reg.seq[reads.pos[i] : reads.end[i]]).all()
        r1 = inside[(reads.flag[inside] & 0x40) > 0]
        reverse = int(((reads.flag[r1] & 0x10) > 0).sum())
        assert (reverse > 0) == bool(carried[s])


def test_the_panel_lists_each_sv(tmp_path):
    cfg = config("sv48", n_samples=2)
    fasta, warm, (reg,) = make_inputs(SEED, cfg, 40_000, 1, str(tmp_path))
    lines = [line.split("\t") for line in open(reg.panel) if not line.startswith("#")]
    assert [c[2] for c in lines] == reg.svs.ids
    for c, k, a, b, s, ins in zip(lines, reg.svs.kind, reg.svs.x1.tolist(), reg.svs.x2.tolist(),
                                  reg.svs.size.tolist(), reg.svs.inserted):
        info = dict(kv.split("=") for kv in c[7].strip().split(";"))
        assert (c[0], int(c[1]), c[3], c[4]) == (reg.contig, a, chr(reg.seq[a - 1]), f"<{k}>")
        assert info["SVTYPE"] == k and abs(int(info["SVLEN"])) == s and int(info["END"]) == (a if k == "INS" else b)
        assert info.get("SEQ", "").encode() == ins


# ---- the SV reference --------------------------------------------------------

def test_the_sv_reference_calls_the_truth():
    """Against the placed genotypes, over the (SV, sample) pairs where
    either carries the SV: deletions, inversions and insertions, whose
    junctions tell the alleles apart, all but a read-count tail (a
    heterozygote with 1 of ~11 alternate spans, once in this region); a
    duplication keeps both reference junctions, and its share of spans and
    its depth miss now and then."""
    cfg = config("sv48", n_samples=8)
    reg = make_region(SEED, 1, "r0", 200_000, cfg)
    gt = reference_sv.call_svs(reg.seq, reg.svs, reg.reads)
    truth = reg.sv_genotypes.sum(axis=2).astype(np.int64)
    pairs = (gt > 0) | (truth > 0)
    kinds = np.array(reg.svs.kind)
    agree = lambda sel: (gt[sel] == truth[sel])[pairs[sel]].mean()
    assert agree(kinds != "DUP") >= 0.97 and pairs[kinds != "DUP"].sum() > 80
    assert agree(kinds == "DUP") >= 0.8


def test_junctions_are_the_haplotypes():
    """Each alternate junction is in a haplotype that carries the SV and in
    none without it; each reference junction (but a duplication's) in
    none with it."""
    from benchmark.gen.sv import sv_haplotype

    cfg = _sv_config(min_bp=60, max_bp=3000, shares={"DEL": 1, "DUP": 1, "INV": 1, "INS": 1})
    reg = make_region(SEED, 3, "r0", 60_000, cfg)
    for j in range(len(reg.svs)):
        ref_w, alt_w = reference_sv.junctions(reg.seq, reg.svs, j)
        only = np.zeros(len(reg.svs), dtype=np.uint8)
        only[j] = 1
        hap = sv_haplotype(reg.seq, reg.variants, np.zeros(0, np.uint8), reg.svs, only).seq.tobytes()
        ref = reg.seq.tobytes()
        for w in alt_w:
            assert w.tobytes() in hap and w.tobytes() not in ref
        for w in ref_w:
            assert w.tobytes() in ref
            assert (w.tobytes() in hap) == (reg.svs.kind[j] == "DUP")


def test_the_sv_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, benchmark.reference_sv, benchmark.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'graphtyper_tpu', 'graphtyper_tpu_torch', "
            "'jax', 'jaxlib', 'flax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(harness.HERE), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


@pytest.mark.parametrize("fault,fails", [("sv_rotate", "sv_gt_mismatch"), ("sv_drop", "sv_missed")])
def test_the_sv_control_and_fault_read_false(fault, fails):
    cfg = config("sv48", n_samples=12)
    ok, got = bench_run.decide(control.sv_fault_records(SEED, cfg, 100_000, 2, fault), "genotype_sv")
    assert ok is False and set(got) == set(bench_run.SV_LIMITS)
    assert got[fails] > bench_run.SV_LIMITS[fails]
    assert bench_run.decide([reference_sv.compare(reference_sv.control_calls(svs, gt), svs, 100_000, gt)
                             for gt, svs in bench_run.sv_references(SEED, cfg, 100_000, [0, 1]).values()],
                            "genotype_sv") == (True, {"sv_gt_mismatch": 0.0, "sv_missed": 0.0})


# ---- whole runs of a tiny SV cell ------------------------------------------------

@pytest.fixture
def sv_cell(tmp_path, monkeypatch):
    """A checkout root of the test's own: a BENCHMARK.json that lists one
    `genotype_sv` cell, beside the benchmark's own files; the cell a pool
    of one sample, 60 kb jobs, 2 regions in rotation."""
    root = tmp_path / "root"
    root.mkdir()
    os.symlink(harness.HERE, root / "benchmark")
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cfg = config("sv48", n_samples=1, sample_prefix="t")
    (root / "tiny_sv.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny_sv", "source": cfg["source"], "file": "tiny_sv.json", "reduced": [],
                             "why": "a test's"})
    bench["workloads"].append({"name": "tiny_sv.pool", "config": "tiny_sv", "traffic": "sv200k", "chips": 1,
                               "why": "a test's"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", str(root))
    real = bench_run.cell

    def small(name):
        b, w, c, t = real(name)
        return b, w, c, dict(t, job_bp=60_000, regions_in_rotation=2)

    monkeypatch.setattr(bench_run, "cell", small)
    return "tiny_sv.pool"


def _run_sv(monkeypatch, capsys, workload, wrap=None) -> dict:
    import torch

    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options
    from graphtyper_tpu_torch.pipeline import genotype

    if wrap is not None:
        monkeypatch.setattr(genotype, "genotype_sv", wrap(genotype.genotype_sv))
    args = bench_run.parse_args(["--workload", workload, "--seed", str(SEED), "--seconds", "0.1", "--trace", "0"])
    try:
        assert bench_run.run_cell(args, torch.device("cpu"), time.time()) == 0
    finally:
        set_options(DEFAULT_OPTIONS)
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    # the numbers compared are the last lines of standard error
    tail = out.err.strip().splitlines()[-len(res["limits"]):]
    assert [line.split(" = ")[0] for line in tail] == [f"compared {k}" for k in res["limits"]]
    return res


def _no_records(real):
    def run(ref, sv_vcf, sams, region, out, device, **kw):
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "empty.vcf.gz")
        with gzip.open(path, "wt") as f:
            f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\n")
        return path
    return run


def _one_sample_altered(real):
    """The first sample's GT changed at every record where it is produced:
    0/0 made 0/1, any other made 0/0."""
    def run(ref, sv_vcf, sams, region, out, device, **kw):
        path = real(ref, sv_vcf, sams, region, out, device, **kw)
        with gzip.open(path, "rt") as f:
            lines = f.read().rstrip("\n").split("\n")
        for i, line in enumerate(lines):
            if line.startswith("#"):
                continue
            col = line.split("\t")
            vals = col[9].split(":")
            vals[0] = "0/1" if vals[0] in ("0/0", "0|0") else "0/0"
            col[9] = ":".join(vals)
            lines[i] = "\t".join(col)
        with gzip.open(path, "wt") as f:
            f.write("\n".join(lines) + "\n")
        return path
    return run


def test_an_sv_run_compares_its_own_numbers(sv_cell, monkeypatch, capsys):
    res = _run_sv(monkeypatch, capsys, sv_cell)
    assert list(res["limits"]) == list(bench_run.SV_LIMITS) and res["attempted"] >= 1
    assert res["device"]["platform"] == "cpu"
    assert all(0 <= v["value"] < 1 and v["limit"] == bench_run.SV_LIMITS[k] for k, v in res["limits"].items())


@pytest.mark.parametrize("fault,number", [(_no_records, "sv_missed"), (_one_sample_altered, "sv_gt_mismatch")])
def test_an_sv_run_with_its_timed_path_broken_reads_false(sv_cell, monkeypatch, capsys, fault, number):
    """No records: every SV is missed. One sample's GT altered at every
    record, in a pool of one sample: every pair differs."""
    res = _run_sv(monkeypatch, capsys, sv_cell, wrap=fault)
    assert res["correct"] is False and res["limits"][number]["value"] == 1.0


# ---- the span readers --------------------------------------------------------

def _recorded_spans():
    """Two jobs of one process and a worker: a job root, a unit under it,
    stages under the unit, a pool wait, and a call pool on another thread."""
    from graphtyper_tpu_torch.counters import Span

    ms = 1_000_000
    out = []
    for j, t in enumerate((0, 1000 * ms)):
        job = 10 + 100 * j
        out += [Span("job", t, t + 900 * ms, job, None, job, 1, 1, None),
                Span("pool.wait", t + 10 * ms, t + 30 * ms, job + 1, job, job, 1, 1, None),
                Span("unit", t + 30 * ms, t + 880 * ms, job + 2, job, job, 2, 5, None),
                Span("bamshrink", t + 40 * ms, t + 140 * ms, job + 3, job + 2, job, 2, 5, 100),
                Span("discovery", t + 140 * ms, t + 240 * ms, job + 4, job + 2, job, 2, 5, 100),
                Span("discovery.pileup", t + 200 * ms, t + 220 * ms, job + 5, job + 4, job, 2, 5, 9),
                Span("graph.build", t + 240 * ms, t + 260 * ms, job + 6, job + 2, job, 2, 5, None),
                Span("index.build", t + 260 * ms, t + 270 * ms, job + 7, job + 2, job, 2, 5, None),
                Span("call", t + 270 * ms, t + 800 * ms, job + 8, job + 2, job, 2, 5, None),
                Span("call.pool", t + 280 * ms, t + 780 * ms, job + 9, job + 8, job, 2, 6, 4),
                Span("scoring.flush", t + 700 * ms, t + 750 * ms, job + 10, job + 9, job, 2, 6, 50),
                Span("scoring.materialize", t + 740 * ms, t + 750 * ms, job + 11, job + 10, job, 2, 6, None),
                Span("merge", t + 800 * ms, t + 860 * ms, job + 12, job + 2, job, 2, 5, None),
                Span("write", t + 860 * ms, t + 870 * ms, job + 13, job + 2, job, 2, 5, None)]
    return out, ms


def test_span_readers_on_recorded_spans():
    recorded, ms = _recorded_spans()
    window = (0, 2000 * ms)
    jobs = [harness.Job(0, 0.9, 1, []), harness.Job(1, 0.9, 1, [])]
    # device operations: inside each job's flush, and one in the discovery's pileup
    intervals = [(t + 710 * ms, t + 730 * ms) for t in (0, 1000 * ms)] + [(205 * ms, 215 * ms)]
    run = harness.Run(jobs=jobs, window=window, spans=spans.clip(recorded, window), intervals=intervals)
    read = lambda name: harness.metric_reader(name)(run)
    # self seconds a job, summed over threads: children's time left out of the parent
    assert read("bamshrink.s_per_job") == pytest.approx(0.100)
    assert read("discovery.s_per_job") == pytest.approx(0.100)     # discovery 0.08 + its pileup 0.02
    assert read("index.s_per_job") == pytest.approx(0.030)
    assert read("call.s_per_job") == pytest.approx(0.450)          # call.pool less its flush
    assert read("scoring.span_s_per_job") == pytest.approx(0.050)
    assert read("merge.s_per_job") == pytest.approx(0.070)
    assert read("pool.wait_p95_s") == pytest.approx(0.020)
    # idle 2000 - 50 ms; named by spans other than `job` (pool.wait, unit): 10..880 and 1010..1880 less the
    # device's 50 ms
    assert read("device.idle_named_share") == pytest.approx(100 * (1740 - 50) / 1950)
    # a span cut by the window counts inside it only
    half = harness.Run(jobs=jobs[:1], window=(0, 90 * ms), spans=spans.clip(recorded, (0, 90 * ms)))
    assert harness.metric_reader("bamshrink.s_per_job")(half) == pytest.approx(0.050)
    # the breakdown names each idle gap for the stage the host was in
    named = [("kernel", 0.02)] * 2 + [("pileup", 0.01)]
    out = harness.breakdown(named, intervals, window, spans=run.spans)
    # (the parent thread's `call` holds its pool threads' time too: self time is per thread)
    assert out["idle_gaps"] == [["host:call", pytest.approx(0.98)], ["host:call", pytest.approx(0.495)],
                                ["host:call", pytest.approx(0.27)], ["host:bamshrink", pytest.approx(0.205)]]
    assert harness.breakdown(named, intervals, window)["idle_gaps"][0][0] == "idle between device operations"


def test_span_readers_find_nothing_without_spans():
    run = harness.Run(jobs=[harness.Job(0, 1.0, 1, [])], window=(0, 10**9), intervals=[(0, 10)])
    for name in ("bamshrink.s_per_job", "discovery.s_per_job", "index.s_per_job", "call.s_per_job",
                 "scoring.span_s_per_job", "merge.s_per_job", "device.idle_named_share", "pool.wait_p95_s"):
        assert harness.metric_reader(name)(run) is None
