"""The port's io/cram_writer.py and io/crai.py against the JAX package's:
the rANS encoders and write_cram give the same bytes on the same input (in
one process, so both packages compress with the same zlib), the port's
read_cram reads back every record written, and write_crai, read_crai and
crai_query give the same entries as the JAX package's on the cases of
tests/io/test_crai.py."""

import numpy as np
import pytest

import graphtyper_tpu.io.bam as ref_bam
import graphtyper_tpu.io.crai as ref_crai
import graphtyper_tpu.io.cram_writer as ref_cw
import graphtyper_tpu_torch.io.bam as port_bam
import graphtyper_tpu_torch.io.crai as port_crai
import graphtyper_tpu_torch.io.cram_writer as port_cw
from graphtyper_tpu_torch.io.cram import rans_decode, read_cram
from graphtyper_tpu_torch.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch.utils.simulate_indep import IndepConfig, simulate_indep


RANS_INPUTS = ["uniform", "quals", "bases", "one_symbol", "short", "empty"]


def _rans_input(kind: str) -> bytes:
    rng = np.random.default_rng(RANS_INPUTS.index(kind))
    if kind == "uniform":
        return rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    if kind == "quals":  # ramped phred+33 runs, the QS block's shape
        return (33 + np.clip(rng.normal(30, 6, 70_000), 2, 41)).astype(np.uint8).tobytes()
    if kind == "bases":
        return rng.choice(np.frombuffer(b"ACGTN", np.uint8), 20_000, p=[0.3, 0.2, 0.2, 0.29, 0.01]).tobytes()
    if kind == "one_symbol":
        return b"I" * 1000
    if kind == "short":
        return b"AC"
    return b""


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("kind", RANS_INPUTS)
def test_rans_encoders_equal(kind, order):
    data = _rans_input(kind)
    enc = getattr(port_cw, f"rans_encode_{order}")(data)
    assert enc == getattr(ref_cw, f"rans_encode_{order}")(data)
    assert enc[0] == order
    assert rans_decode(enc) == (data or b"\x00")


def test_itf8_ltf8_equal():
    values = [0, 1, 127, 128, 16383, 16384, 2**21 - 1, 2**21, 2**28 - 1, 2**28, 2**31 - 1, -1, -2**31]
    for v in values:
        assert port_cw.itf8(v) == ref_cw.itf8(v)
    for v in values + [2**40, 2**56 - 1, 2**62]:
        assert port_cw.ltf8(v) == ref_cw.ltf8(v)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = tmp_path_factory.mktemp("cram_writer")
    cfg = SimConfig(region_length=30_000, coverage=12.0, n_samples=2, seed=61, out_format="bam")
    return d, simulate_cohort(str(d / "sim"), cfg)


@pytest.mark.parametrize("sample", [0, 1])
def test_write_cram_equal_and_read_back(cohort, sample):
    d, sim = cohort
    path = sim.sams[sample]
    header, reads = port_bam.read_alignments(path, parse_tags=True)
    ref_header, ref_reads = ref_bam.read_alignments(path, parse_tags=True)
    got, want = str(d / f"port{sample}.cram"), str(d / f"ref{sample}.cram")
    port_cw.write_cram(got, header, reads)
    ref_cw.write_cram(want, ref_header, ref_reads)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()

    back_header, back = read_cram(got, parse_tags=True)
    assert back_header.ref_names == header.ref_names and back_header.ref_lengths == header.ref_lengths
    assert len(back) == len(reads) > 1000
    for r, w in zip(back, reads):
        assert (r.name, r.flag, r.ref_id, r.pos, r.mapq, r.cigar, r.mate_ref_id, r.mate_pos, r.tlen) == \
            (w.name, w.flag, w.ref_id, w.pos, w.mapq, w.cigar, w.mate_ref_id, w.mate_pos, w.tlen)
        assert bytes(r.seq) == bytes(w.seq)
        assert np.array_equal(np.asarray(r.qual), np.asarray(w.qual))
        assert r.tags.get("RG") == w.tags.get("RG")


# ---- tests/io/test_crai.py's cases, through both packages ------------------

@pytest.fixture(scope="module")
def cram(tmp_path_factory):
    d = tmp_path_factory.mktemp("crai")
    cfg = IndepConfig(region_length=120_000, n_samples=1, coverage=12.0, seed=17)
    sim = simulate_indep(str(d), cfg)
    return sim.sams[0], cfg.chrom


def _fields(entries):
    return [(e.seq_id, e.start, e.span, e.container_offset, e.slice_offset, e.slice_size) for e in entries]


def test_crai_roundtrip_and_query(cram, tmp_path):
    path, chrom = cram
    got_path = port_crai.write_crai(path, str(tmp_path / "port.crai"))
    want_path = ref_crai.write_crai(path, str(tmp_path / "ref.crai"))
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        assert a.read() == b.read()  # gzip with mtime 0: same bytes in one process
    entries = port_crai.read_crai(got_path)
    assert _fields(entries) == _fields(ref_crai.read_crai(want_path))
    # the writer emits 10k-record slices; 120 kb at 12x is ~9.5k reads
    assert len(entries) >= 1
    assert all(e.slice_size > 0 and e.span > 0 for e in entries)
    assert len(port_crai.crai_query(entries, 0, 0, 10**9)) == len([e for e in entries if e.seq_id in (0, -2)])
    assert port_crai.crai_query(entries, 0, 10**8, 2 * 10**8) == []
    for beg, end in [(0, 30_000), (50_000, 70_000), (110_000, 120_000), (10**8, 2 * 10**8)]:
        assert _fields(port_crai.crai_query(entries, 0, beg, end)) == \
            _fields(ref_crai.crai_query(ref_crai.read_crai(want_path), 0, beg, end))


def test_region_read_superset_and_filtered_equality(cram):
    path, chrom = cram
    _, all_reads = read_cram(path)
    for beg, end in [(0, 30_000), (50_000, 70_000), (110_000, 120_000)]:
        _, got = read_cram(path, region=(chrom, beg, end))
        got_names = {(r.name, r.pos) for r in got}
        want = {(r.name, r.pos) for r in all_reads if beg <= r.pos < end}
        assert want <= got_names
        by_key = {(r.name, r.pos, r.flag): r for r in all_reads}
        for r in got:
            full = by_key[(r.name, r.pos, r.flag)]
            assert np.array_equal(r.seq, full.seq)
            assert r.cigar == full.cigar
    _, none = read_cram(path, region=("chrUnknown", 0, 1000))
    assert none == []


def test_cram_bamshrink_region_matches_full(cram, tmp_path):
    """The port's .cram shrink path (region-filtered decode) gives the bytes
    of a full-decode shrink."""
    path, chrom = cram
    from graphtyper_tpu_torch.config import Options
    from graphtyper_tpu_torch.pipeline.bamshrink import _rename_sort_write, _shrink_region, bamshrink

    out_region = str(tmp_path / "region.bam")
    bamshrink(path, chrom, 40_000, 80_000, out_region)
    header, reads = read_cram(path, parse_tags=True)
    kept = []
    _shrink_region(header, reads, chrom, 40_000, 80_000, -1.0, Options(), kept, set())
    out_full = str(tmp_path / "full.bam")
    _rename_sort_write(header, kept, out_full)
    with open(out_region, "rb") as a, open(out_full, "rb") as b:
        assert a.read() == b.read()
