"""Spans and the `sv_alleles` counter of the port's `genotype_sv`, on the
CPU, on the 4-sample BAM fixture of tests/pipeline/test_sv_stream.py:

- with the recorder on, one call records `job` and under it `graph.build`,
  `index.build`, `call`, `merge` and `write`; under `call` one `call.pool`
  a pool (each with its own `sv.reformat` and flushes inside it): one of
  every sample at `--threads 1`, one a sample at `--threads 4`;
- `sv_alleles` counts every SV allele the SV graph holds, each
  breakpoint of an insertion or a duplication apart;
- the VCF is the same with the recorder off;
- `call_pools` opens one `call.pool` a pool, as before: `call_pool` opens
  none of its own under it.
"""

import gzip
import hashlib
from dataclasses import replace

import numpy as np
import pytest

from graphtyper_tpu_torch import config, counters
from graphtyper_tpu_torch.graph.build import construct_graph
from graphtyper_tpu_torch.graph.coords import GenomicRegion
from graphtyper_tpu_torch.index.build import index_graph
from graphtyper_tpu_torch.pipeline.caller import call_pools
from graphtyper_tpu_torch.pipeline.genotype import genotype_sv
from graphtyper_tpu_torch.utils.simulate import _random_seq, _write_fasta
from tests.pipeline.test_sv_stream import _sv_fixture

HEADER = "##fileformat=VCFv4.2\n##contig=<ID=chrS>\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"


def _md5(path) -> str:
    with gzip.open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sv_trace")
    fasta, sv_vcf, bams, chrom, length = _sv_fixture(tmp)
    return tmp, fasta, sv_vcf, bams, f"{chrom}:1-{length}"


def _genotype_sv(fixture, name: str, on: bool, threads: int | None = None):
    """(VCF path, spans, counters) of one `genotype_sv` call, at `threads`
    where given."""
    tmp, fasta, sv_vcf, bams, region = fixture
    opts = config.DEFAULT_OPTIONS
    config.set_options(opts if threads is None else replace(opts, threads=threads))
    counters.reset()
    counters.trace(on)
    try:
        out = genotype_sv(fasta, sv_vcf, bams, region, str(tmp / name), "cpu")
        return out, counters.spans(), counters.totals()
    finally:
        counters.trace(False)
        counters.reset()


@pytest.fixture(scope="module")
def traced(fixture):
    return _genotype_sv(fixture, "traced", True)


@pytest.mark.parametrize("threads", [1, 4])
def test_genotype_sv_records_its_stages_under_job(fixture, threads):
    _, spans, totals = _genotype_sv(fixture, f"stages{threads}", True, threads)
    names = [s.name for s in spans]
    stages = ("graph.build", "index.build", "call", "merge", "write")
    for name in ("job",) + stages:
        assert names.count(name) == 1, (name, names)
    by = {s.name: s for s in spans}
    job = by["job"]
    assert job.parent is None and all(s.job == job.id for s in spans)
    for name in stages:
        s = by[name]
        assert s.parent == job.id and (s.pid, s.tid) == (job.pid, job.tid)
        assert job.start_ns <= s.start_ns <= s.end_ns <= job.end_ns
    # in order, one after another
    order = [by[n] for n in stages]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    # one pool of every sample, or one a sample at 4 threads on 4 samples
    n_bams = len(fixture[3])
    pools = [s for s in spans if s.name == "call.pool"]
    assert sorted(s.n for s in pools) == ([n_bams] if threads == 1 else [1] * n_bams)
    assert totals["sv_pools"] == len(pools)
    call = by["call"]
    for pool in pools:
        assert pool.parent == call.id and call.start_ns <= pool.start_ns <= pool.end_ns <= call.end_ns
        # each pool's reformat and flushes sit in it, on its thread
        inside = [s for s in spans if s.parent == pool.id]
        assert [s.name for s in inside].count("sv.reformat") == 1, inside
        assert any(s.name == "scoring.flush" for s in inside), inside
        assert all((s.pid, s.tid) == (pool.pid, pool.tid) for s in inside)
        assert all(s.n > 0 for s in inside if s.name == "sv.reformat")
    assert names.count("sv.reformat") == len(pools)
    assert all(s.parent in {p.id for p in pools} for s in spans if s.name == "scoring.flush")
    if threads == 1:
        assert (pools[0].pid, pools[0].tid) == (job.pid, job.tid)


def test_sv_alleles_counts_each_breakpoint_allele(tmp_path):
    """One of each kind that adds two alleles (an insertion with its
    sequence, a tandem duplication, an inversion) and a deletion, which
    adds one: the counter is the graph's SV list, allele for allele."""
    seq = _random_seq(np.random.default_rng(5), 20_000)
    fasta = str(tmp_path / "ref.fa")
    _write_fasta(fasta, "chrS", seq)
    ins = _random_seq(np.random.default_rng(6), 400).tobytes().decode()
    b = lambda at: chr(seq[at - 1])
    recs = [f"chrS\t3001\tdel1\t{b(3001)}\t<DEL>\t.\t.\tSVTYPE=DEL;SVLEN=-300;SVSIZE=300;END=3301",
            f"chrS\t6001\tins1\t{b(6001)}\t<INS>\t.\t.\tSVTYPE=INS;SVLEN=400;SVSIZE=400;SEQ={ins}",
            f"chrS\t9001\tdup1\t{b(9001)}\t<DUP>\t.\t.\tSVTYPE=DUP;SVLEN=500;SVSIZE=500;END=9501",
            f"chrS\t13001\tinv1\t{b(13001)}\t<INV>\t.\t.\tSVTYPE=INV;SVLEN=600;SVSIZE=600;END=13601"]
    sv_vcf = tmp_path / "sv.vcf"
    sv_vcf.write_text(HEADER + "\n".join(recs) + "\n")
    counters.reset()
    graph = construct_graph(fasta, str(sv_vcf), "chrS:1-20000", is_sv_graph=True, use_index=True)
    models = [sv.model for sv in graph.svs]
    assert models.count("BREAKPOINT1") >= 3 and models.count("BREAKPOINT2") >= 3 and "BREAKPOINT" in models
    assert counters.totals()["sv_alleles"] == len(graph.svs) == 7
    # each is a variant node of the graph, which carries its tag
    assert sum(b"<SV:" in bytes(node.label.dna) for node in graph.var_nodes) == len(graph.svs)
    # a graph without SVs counts none
    counters.reset()
    construct_graph(fasta, "", "chrS:1-20000", is_sv_graph=False)
    assert "sv_alleles" not in counters.totals()


def test_sv_alleles_of_a_genotype_sv_call(traced, fixture):
    _, fasta, sv_vcf, _, region = fixture
    _, _, totals = traced
    padded = GenomicRegion.parse(region)
    padded.pad_end(200000)
    padded.pad(1000)
    graph = construct_graph(fasta, sv_vcf, padded.to_string(), is_sv_graph=True, use_index=True)
    assert totals["sv_alleles"] == len(graph.svs) == 1     # the fixture's deletion


def test_the_vcf_is_the_same_with_the_recorder_off(traced, fixture):
    out, _, _ = traced
    plain, spans, totals = _genotype_sv(fixture, "plain", False)
    assert spans == []
    assert _md5(plain) == _md5(out)
    assert totals["sv_alleles"] == traced[2]["sv_alleles"]


@pytest.mark.parametrize("threads,max_files_open,pools", [(2, 1, 4), (2, 1000, 2), (1, 1000, 1)])
def test_call_pools_opens_one_call_pool_a_pool(fixture, threads, max_files_open, pools):
    _, fasta, sv_vcf, bams, region = fixture
    padded = GenomicRegion.parse(region)
    padded.pad(1000)
    graph = construct_graph(fasta, sv_vcf, padded.to_string(), is_sv_graph=True, use_index=True)
    index = index_graph(graph)
    config.set_options(replace(config.DEFAULT_OPTIONS, threads=threads, max_files_open=max_files_open))
    counters.reset()
    counters.trace(True)
    try:
        with counters.span("call"):
            call_pools(graph, index, bams, "cpu", region=padded, is_writing_calls_vcf=True, is_writing_hap=False)
        spans = counters.spans()
    finally:
        counters.trace(False)
        counters.reset()
        config.set_options(config.DEFAULT_OPTIONS)
    (call,) = [s for s in spans if s.name == "call"]
    got = [s for s in spans if s.name == "call.pool"]
    assert len(got) == pools
    assert all(s.parent == call.id for s in got)
    assert sorted(s.n for s in got) == sorted([len(bams) // pools] * pools)
    assert len([s for s in spans if s.name == "sv.reformat"]) == pools
