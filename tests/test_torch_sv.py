"""The port's `genotype_sv` on the CPU device against the JAX package's:
byte-identical VCF bodies (md5 of the uncompressed outputs) on the five SV
kinds of tests/pipeline/test_sv_e2e.py (DEL, INS, DUP, INV, BND), on the
4-sample BAM fixture of tests/pipeline/test_sv_stream.py in memory and in
the streaming caller (in batches of 700 records), with and without
avg_cov_by_readlen, and through both CLIs; and the SV cohort builder of
graphtyper_tpu_torch/tools/bench_sv.py against tools/bench_sv.py's."""

import gzip
import hashlib
import importlib.util
import os
import pathlib
from dataclasses import replace

import numpy as np
import pytest

from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline.genotype import genotype_sv as ref_genotype_sv
from graphtyper_tpu.utils.simulate import _random_seq, _write_fasta
from graphtyper_tpu_torch import cli, config, counters
from graphtyper_tpu_torch.pipeline import native_caller
from graphtyper_tpu_torch.pipeline.genotype import genotype_sv
from tests.pipeline.test_sv_e2e import _sim_reads, _write_sv_vcf
from tests.pipeline.test_sv_stream import _sv_fixture

REPO = pathlib.Path(__file__).resolve().parent.parent
HEADER = "##fileformat=VCFv4.2\n##contig=<ID=chrS>\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"


def _md5(paths):
    h = hashlib.md5()
    for p in sorted(paths):
        with gzip.open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _reset_options():
    """Each package reads its own options; both start from the defaults."""
    for cfg in (config, ref_config):
        cfg.set_options(cfg.DEFAULT_OPTIONS)


def _comp(seg):
    return np.frombuffer(seg.tobytes().translate(bytes.maketrans(b"ACGT", b"TGCA")), dtype=np.uint8)


def _sv_case(kind, tmp_path):
    """tests/pipeline/test_sv_e2e.py's input of one SV kind: (fasta, SV VCF,
    SAM files, region)."""
    chrom = "chrS"
    seed, length = dict(DEL=(4, 8000), INS=(7, 8000), DUP=(9, 9000), INV=(21, 9000), BND=(33, 9000))[kind]
    rng = np.random.default_rng(seed)
    seq = _random_seq(rng, length)
    fasta = str(tmp_path / "ref.fa")
    _write_fasta(fasta, chrom, seq)
    sv_vcf = str(tmp_path / "sv.vcf")
    sams = [str(tmp_path / "carrier.sam")]
    if kind == "DEL":
        at, size = 3000, 150
        _write_sv_vcf(sv_vcf, chrom, at + 1, chr(seq[at]), size, at + 1 + size)
        alt = np.concatenate([seq[: at + 1], seq[at + 1 + size :]])
        _sim_reads(sams[0], chrom, length, [seq, alt], 900, "carrier", 1)
        sams.append(str(tmp_path / "homref.sam"))
        _sim_reads(sams[1], chrom, length, [seq, seq], 900, "homref", 2)
        return fasta, sv_vcf, sams, f"{chrom}:1-{length}"
    if kind == "INS":
        at = 3500
        ins = _random_seq(rng, 120).tobytes().decode()
        rec = f"{chrom}\t{at + 1}\t.\t{chr(seq[at])}\t<INS>\t.\t.\tSVTYPE=INS;SVLEN=120;SVSIZE=120;SEQ={ins}\n"
        haps, pairs, read_seed = [seq, np.concatenate([seq[: at + 1], np.frombuffer(ins.encode(), np.uint8),
                                                        seq[at + 1 :]])], 900, 3
    elif kind == "DUP":
        at, n = 4000, 200
        rec = (f"{chrom}\t{at + 1}\t.\t{chr(seq[at])}\t<DUP>\t.\t.\t"
               f"SVTYPE=DUP;SVLEN={n};SVSIZE={n};END={at + 1 + n}\n")
        dup = np.concatenate([seq[: at + 1 + n], seq[at + 1 : at + 1 + n], seq[at + 1 + n :]])
        haps, pairs, read_seed = [dup, dup], 1000, 5
    elif kind == "INV":
        at, n = 4000, 300
        rec = (f"{chrom}\t{at + 1}\t.\t{chr(seq[at])}\t<INV>\t.\t.\t"
               f"SVTYPE=INV;SVLEN={n};SVSIZE={n};END={at + 1 + n}\n")
        inv = np.concatenate([seq[: at + 1], _comp(seq[at + 1 : at + 1 + n])[::-1], seq[at + 1 + n :]])
        haps, pairs, read_seed = [seq, inv], 1000, 8
    else:  # BND t[chr:pos[ from 2000 to 6001
        at, mate = 2000, 6001
        rb = chr(seq[at])
        rec = f"{chrom}\t{at + 1}\t.\t{rb}\t{rb}[{chrom}:{mate}[\t.\t.\tSVTYPE=BND\n"
        haps, pairs, read_seed = [seq, np.concatenate([seq[: at + 1], seq[mate:]])], 1000, 12
    with open(sv_vcf, "w") as f:
        f.write(HEADER + rec)
    _sim_reads(sams[0], chrom, length, haps, pairs, "carrier", read_seed)
    return fasta, sv_vcf, sams, f"{chrom}:1-{length}"


@pytest.mark.parametrize("kind", ["DEL", "INS", "DUP", "INV", "BND"])
def test_sv_kind_matches_reference(tmp_path, kind):
    fasta, sv_vcf, sams, region = _sv_case(kind, tmp_path)
    _reset_options()
    ref = ref_genotype_sv(fasta, sv_vcf, sams, region, str(tmp_path / "ref"))
    counters.reset()
    port = genotype_sv(fasta, sv_vcf, sams, region, str(tmp_path / "port"), "cpu")
    assert os.path.basename(port) == os.path.basename(ref)
    assert _md5([port]) == _md5([ref])
    with gzip.open(port, "rt") as f:
        assert any(f"SVTYPE={kind}" in line for line in f if not line.startswith("#"))
    seen = counters.totals()
    assert seen.get("scoring_rows", 0) > 0, seen
    assert not any(seen.get(k) for k in ("device_align", "device_align_plain", "seed_probe_plain")), seen


@pytest.fixture(scope="module")
def stream_fixture(tmp_path_factory):
    """test_sv_stream.py's 4-sample BAM fixture and the JAX package's md5
    without and with avg_cov_by_readlen (0.15 a sample)."""
    tmp = tmp_path_factory.mktemp("torch_sv_stream")
    fasta, sv_vcf, bams, chrom, length = _sv_fixture(tmp)
    region = f"{chrom}:1-{length}"
    ref = {}
    for avg in (None, [0.15] * len(bams)):
        _reset_options()
        out = ref_genotype_sv(fasta, sv_vcf, bams, region, str(tmp / f"ref_{avg is not None}"),
                              avg_cov_by_readlen=avg)
        ref[avg is not None] = _md5([out])
    return tmp, fasta, sv_vcf, bams, region, ref


@pytest.mark.parametrize("streaming,with_cov", [("off", False), ("on", False), ("off", True), ("on", True)])
def test_sv_stream_fixture_matches_reference(stream_fixture, monkeypatch, streaming, with_cov):
    tmp, fasta, sv_vcf, bams, region, ref = stream_fixture
    stream = native_caller.run_native_call_pool_stream
    batches = []

    def small_batches(*a, **kw):
        kw["batch_records"] = 700  # many batches: cross-batch bins, pending mates
        batches.append(1)
        return stream(*a, **kw)

    monkeypatch.setattr(native_caller, "run_native_call_pool_stream", small_batches)
    _reset_options()
    config.set_options(replace(config.DEFAULT_OPTIONS, streaming_caller=streaming))
    try:
        out = genotype_sv(fasta, sv_vcf, bams, region, str(tmp / f"port_{streaming}_{with_cov}"), "cpu",
                          avg_cov_by_readlen=[0.15] * len(bams) if with_cov else None)
    finally:
        _reset_options()
    assert bool(batches) == (streaming == "on")
    assert _md5([out]) == ref[with_cov]


def test_sv_cli_matches_reference(stream_fixture):
    """genotype_sv through both CLIs with --avg_cov_by_readlen."""
    import contextlib
    import io

    from graphtyper_tpu import cli as ref_cli

    tmp, fasta, sv_vcf, bams, region, ref = stream_fixture
    avg = tmp / "avg.txt"
    avg.write_text("0.15\n" * len(bams))
    outs = []
    for main, extra, name in ((ref_cli.main, [], "ref_cli"), (cli.main, ["--device", "cpu"], "port_cli")):
        buf = io.StringIO()
        _reset_options()
        try:
            with contextlib.redirect_stdout(buf):
                assert main(["genotype_sv", fasta, sv_vcf, "--region", region, "-O", str(tmp / name),
                             "--avg_cov_by_readlen", str(avg), *extra, *[f"--sam={b}" for b in bams]]) == 0
        finally:
            _reset_options()
        outs.append(buf.getvalue().split()[-1])
    assert os.path.basename(outs[0]) == os.path.basename(outs[1])
    assert _md5(outs[1:]) == _md5(outs[:1]) == ref[True]
    assert os.path.exists(str(tmp / "port_cli" / "graphtyper.sv.vcf.gz"))


def test_bench_sv_cohort_matches_tools_bench_sv(tmp_path):
    """The port's SV cohort builder writes tools/bench_sv.py's cohort (same
    draws; BAM contents compared uncompressed), and the port's bench runs
    genotype_sv on it to the JAX package's VCF."""
    from graphtyper_tpu.io.bgzf import decompress_all
    from graphtyper_tpu_torch.tools import bench_sv

    spec = importlib.util.spec_from_file_location("ref_bench_sv", REPO / "tools" / "bench_sv.py")
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)

    kb, samples, coverage = 40, 2, 4.0
    cohort = bench_sv.build_cohort(str(tmp_path / "port"), kb, samples, coverage)
    # tools/bench_sv.py:115-146 with the same arguments
    L = kb * 1000
    rng = np.random.default_rng(7)
    seq = ref_tool._random_seq(rng, L)
    ref_tool._write_fasta(str(tmp_path / "ref.fa"), "chrSV", seq)
    svs = []
    for k, p in enumerate(range(12000, L - 15000, 25000)):
        size = int(rng.integers(60, 400))
        svs.append((["DEL", "DUP", "INV"][k % 3], p + 1, chr(seq[p]), size, p + 1 + size))
    ref_tool._write_sv_vcf(str(tmp_path / "sv.vcf"), "chrSV", svs)
    n_pairs = int(coverage * L / (2 * 125))
    for s in range(samples):
        carry = (rng.random(len(svs)) < 0.4).astype(np.int8)
        hap_a = ref_tool._apply_svs(seq, svs, carry)
        ref_tool._sim_sample_bam(str(tmp_path / f"s{s}.bam"), "chrSV", L, [hap_a, seq], n_pairs, f"s{s}", 100 + s)
    for a, b in ((tmp_path / "ref.fa", cohort.fasta), (tmp_path / "sv.vcf", cohort.sv_vcf)):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    for s in range(samples):
        assert decompress_all(str(tmp_path / f"s{s}.bam")) == decompress_all(cohort.bams[s])
    assert cohort.n_svs == len(svs) and cohort.region == f"chrSV:1-{L}"

    _reset_options()
    ref = ref_genotype_sv(cohort.fasta, cohort.sv_vcf, cohort.bams, cohort.region, str(tmp_path / "ref_out"),
                          avg_cov_by_readlen=cohort.avg_cov_by_readlen)
    out = genotype_sv(cohort.fasta, cohort.sv_vcf, cohort.bams, cohort.region, str(tmp_path / "port_out"), "cpu",
                      avg_cov_by_readlen=cohort.avg_cov_by_readlen)
    assert _md5([out]) == _md5([ref])


def test_bench_sv_tool_runs_on_cpu(tmp_path, capsys):
    """python -m graphtyper_tpu_torch.tools.bench_sv --device cpu: its last
    line reports the records, the reads and the scoring rows."""
    import json

    from graphtyper_tpu_torch.tools import bench_sv

    _reset_options()
    assert bench_sv.main(["--kb", "40", "--samples", "2", "--coverage", "4", "--device", "cpu",
                          "--keep", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["device"] == "cpu" and got["svs"] == 1 and got["records"] > 0
    assert got["reads"] == 2 * 2 * int(4.0 * 40_000 / 250)
    assert got["counters"].get("scoring_rows", 0) > 0
