"""The port's `genotype_camou` and `genotype_hla` (and segment calling) on
the CPU device against the JAX package's, on the inputs of
tests/pipeline/test_camou_hla_e2e.py and a cut-down IMGT panel of
tests/pipeline/test_hla_imgt.py: byte-identical VCF bodies (md5 of the
uncompressed outputs). Camou runs with 1, 2 and 3 intervals (ploidy 2, 4,
6), and with the call pool's verdicts (device_align) on."""

import gzip
import hashlib
import os
from dataclasses import replace

import numpy as np
import pytest

from graphtyper_tpu import cli as ref_cli
from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline import genotype_camou as ref_camou
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch import cli, config, counters
from graphtyper_tpu_torch.pipeline import genotype_camou as port_camou
from test_torch_subcommand_data import build_imgt_panel, imgt_truth_pairs, write_pair_sam

# tests/pipeline/test_camou_hla_e2e.py: cohort and BED intervals per ploidy
CAMOU = {
    1: (SimConfig(region_length=6000, coverage=22.0, seed=17, snp_rate=1 / 800.0, indel_rate=0.0),
        [(1000, 5000)]),
    2: (SimConfig(region_length=9000, coverage=22.0, seed=23, snp_rate=1 / 700.0, indel_rate=0.0),
        [(1000, 4000), (5000, 8000)]),
    3: (SimConfig(region_length=12000, coverage=22.0, seed=29, snp_rate=1 / 700.0, indel_rate=0.0),
        [(500, 3500), (4500, 7500), (8500, 11500)]),
}


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


def _camou_outs(out_dir, chrom):
    d = os.path.join(out_dir, chrom)
    return [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".camou.vcf.gz")]


@pytest.fixture(scope="module")
def camou_ref(tmp_path_factory):
    """(interval count, input format) -> (cohort, BED, md5 of the JAX
    package's outputs), made on first use."""
    root = tmp_path_factory.mktemp("torch_camou")
    made = {}

    def get(n, fmt):
        if (n, fmt) not in made:
            cfg, intervals = CAMOU[n]
            sim = simulate_cohort(str(root / f"sim{n}_{fmt}"), replace(cfg, out_format=fmt))
            bed = str(root / f"intervals{n}.bed")
            with open(bed, "w") as f:
                f.writelines(f"{cfg.chrom}\t{lo}\t{hi}\n" for lo, hi in intervals)
            _reset_options()
            ref_camou.genotype_camou(sim.fasta, bed, sim.sams, str(root / f"ref{n}_{fmt}"))
            outs = _camou_outs(str(root / f"ref{n}_{fmt}"), cfg.chrom)
            assert len(outs) == n
            made[n, fmt] = (sim, bed, _md5(outs), root)
        return made[n, fmt]

    return get


# the call pool's verdicts run on the engine's BAM path only, so the
# device_align case reads BAM
@pytest.mark.parametrize("n_intervals,fmt,device_align", [
    (1, "sam", "off"), (2, "sam", "off"), (3, "sam", "off"), (2, "bam", "off"), (2, "bam", "on"),
])
def test_camou_matches_reference(camou_ref, n_intervals, fmt, device_align):
    sim, bed, ref_md5, root = camou_ref(n_intervals, fmt)
    cfg = CAMOU[n_intervals][0]
    out_dir = str(root / f"port{n_intervals}_{fmt}_{device_align}")
    _reset_options()
    config.set_options(replace(config.DEFAULT_OPTIONS, device_align=device_align))
    counters.reset()
    try:
        port_camou.genotype_camou(sim.fasta, bed, sim.sams, out_dir, "cpu")
    finally:
        _reset_options()
    assert _md5(_camou_outs(out_dir, cfg.chrom)) == ref_md5
    seen = counters.totals()
    assert seen.get("scoring_rows", 0) > 0, seen
    assert (seen.get("device_align_plain", 0) > 0) == (device_align == "on"), seen
    assert not any(seen.get(k) for k in ("sw_rot", "sw_row", "device_align", "seed_probe")), seen


def _camou_calls():
    """tests/pipeline/test_camou_hla_e2e.py's update_camou_phred inputs:
    (ploidy, [(ref, alt) coverage per call])."""
    return [(4, [(12, 3), (0, 0), (2, 20)]), (6, [(12, 3)]), (8, [(12, 3), (20, 1)])]


@pytest.mark.parametrize("ploidy,covs", _camou_calls())
def test_update_camou_phred_matches_reference(ploidy, covs):
    from graphtyper_tpu.typer.sample_call import SampleCall as RefCall
    from graphtyper_tpu.typer.variant import Variant as RefVariant
    from graphtyper_tpu_torch.typer.sample_call import SampleCall
    from graphtyper_tpu_torch.typer.variant import Variant

    ref, port = RefVariant(abs_pos=10, seqs=[b"A", b"G"]), Variant(abs_pos=10, seqs=[b"A", b"G"])
    for cov in covs:
        ref.calls.append(RefCall(phred=np.zeros(3, dtype=np.int64), coverage=np.array(cov)))
        port.calls.append(SampleCall(phred=np.zeros(3, dtype=np.int64), coverage=np.array(cov)))
    ref_camou.update_camou_phred_all([ref], ploidy)
    port_camou.update_camou_phred_all([port], ploidy)
    for r, p in zip(ref.calls, port.calls):
        assert p.phred.dtype == r.phred.dtype
        np.testing.assert_array_equal(p.phred, r.phred)


def _run_both_clis(argv, out_ref, out_port):
    """The same subcommand through the JAX package's CLI and the port's (on
    the CPU device); the paths each printed."""
    import contextlib
    import io

    printed = []
    for main, extra, out in ((ref_cli.main, [], out_ref), (cli.main, ["--device", "cpu"], out_port)):
        buf = io.StringIO()
        _reset_options()
        try:
            with contextlib.redirect_stdout(buf):
                assert main([*argv, "-O", out, *extra]) == 0
        finally:
            _reset_options()
        printed.append(buf.getvalue().split())
    return printed


@pytest.fixture(scope="module")
def two_allele_panel(tmp_path_factory):
    """tests/pipeline/test_camou_hla_e2e.py test_genotype_hla: two alleles
    told apart by two exon SNPs, one A1/A2 sample; plus a segment FASTA of
    the two alleles (intron, long exon over both SNPs, intron), as in its
    test_segment_calling."""
    from graphtyper_tpu_torch.utils.simulate import _random_seq, _write_fasta

    tmp = tmp_path_factory.mktemp("torch_hla")
    rng = np.random.default_rng(23)
    length, chrom = 4000, "chrH"
    seq = _random_seq(rng, length)
    fasta = str(tmp / "ref.fa")
    _write_fasta(fasta, chrom, seq)
    p1, p2 = 1500, 1600
    alts = ["ACGT"[("ACGT".index(chr(seq[p])) + 1) % 4] for p in (p1, p2)]
    panel = str(tmp / "hla.vcf")
    with open(panel, "w") as f:
        f.write(f"##fileformat=VCFv4.2\n##contig=<ID={chrom}>\n"
                '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="depth">\n'
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA1\tA2\n")
        for i, (p, alt) in enumerate(zip((p1, p2), alts)):
            f.write(f"{chrom}\t{p + 1}\t.\t{chr(seq[p])}\t{alt}\t.\t.\tGT_ID={i + 1};FEATURE=exon\tAD\t1,0\t0,1\n")
    hap_a1, hap_a2 = seq.copy(), seq.copy()
    hap_a2[p1], hap_a2[p2] = ord(alts[0]), ord(alts[1])
    seg = str(tmp / "gene.fa")
    with open(seg, "w") as f:
        for name, hap in (("A1", hap_a1), ("A2", hap_a2)):
            for k, (lo, hi) in enumerate(((1100, 1300), (1400, 1700), (1800, 2000))):
                f.write(f">{name}.{k}\n" + hap[lo:hi].tobytes().decode() + "\n")
    sam = write_pair_sam(str(tmp / "sample.sam"), "sample1", hap_a1, hap_a2, 23, n_pairs=600,
                         chrom=chrom, length=length)
    return dict(dir=tmp, fasta=fasta, hla_vcf=panel, segment_fasta=seg, sams=[sam],
                region=f"{chrom}:1-{length}")


@pytest.fixture(scope="module")
def cut_imgt_panel(tmp_path_factory):
    """test_hla_imgt.py's panel cut to 4 families of 4 alleles, and four of
    its truth-style samples at 400 read pairs."""
    tmp = tmp_path_factory.mktemp("torch_imgt")
    p = build_imgt_panel(str(tmp), n_families=4, per_family=4)
    names = sorted(p["carried"])
    pairs = [(names[a], names[b]) for a, b in ((0, 5), (3, 3), (6, 13), (9, 10))]
    sams = [write_pair_sam(str(tmp / f"s{k}.sam"), f"s{k}", p["haps"][a], p["haps"][b], 1000 + k, n_pairs=400)
            for k, (a, b) in enumerate(pairs)]
    return dict(dir=tmp, fasta=p["fasta"], hla_vcf=p["hla_vcf"], segment_fasta=p["panel"], sams=sams,
                region="chr6:1-12000")


@pytest.mark.parametrize("panel,segments", [("two_allele_panel", False), ("two_allele_panel", True),
                                            ("cut_imgt_panel", True)])
def test_genotype_hla_matches_reference(request, panel, segments):
    p = request.getfixturevalue(panel)
    argv = ["genotype_hla", p["fasta"], p["hla_vcf"], "--region", p["region"], *[f"--sam={s}" for s in p["sams"]]]
    if segments:
        argv += ["--segment_fasta", p["segment_fasta"]]
    tag = f"{panel}_{segments}"
    counters.reset()
    ref_out, port_out = _run_both_clis(argv, str(p["dir"] / f"ref_{tag}"), str(p["dir"] / f"port_{tag}"))
    assert [os.path.basename(x) for x in port_out] == [os.path.basename(x) for x in ref_out]
    assert _md5(port_out) == _md5(ref_out)
    assert counters.totals().get("scoring_rows", 0) > 0
    seg = [x[: -len(".hla.vcf.gz")] + ".segments.vcf.gz" for x in (ref_out[0], port_out[0])]
    assert all(os.path.exists(x) == segments for x in seg)
    if segments:
        assert _md5(seg[1:]) == _md5(seg[:1])
        with gzip.open(seg[1], "rt") as f:
            assert [line for line in f if not line.startswith("#")]


def test_scorer_state_is_host_numpy(cut_imgt_panel):
    """What segment calling reads after finalize() (segment_calling.py
    :146-173, :185-190): every hap_sample's log_score and each site's gt.num
    are host values of the JAX package's types and equal to its own."""
    from graphtyper_tpu.graph.build import construct_graph as ref_construct
    from graphtyper_tpu.graph.coords import GenomicRegion as RefRegion
    from graphtyper_tpu.index.build import index_graph as ref_index
    from graphtyper_tpu.pipeline.caller import call_pool as ref_call_pool
    from graphtyper_tpu_torch.graph.build import construct_graph
    from graphtyper_tpu_torch.graph.coords import GenomicRegion
    from graphtyper_tpu_torch.index.build import index_graph
    from graphtyper_tpu_torch.pipeline.caller import call_pool

    p = cut_imgt_panel
    _reset_options()
    g = construct_graph(p["fasta"], p["hla_vcf"], p["region"], use_index=True)
    port = call_pool(g, index_graph(g), p["sams"], "cpu", region=GenomicRegion.parse(p["region"]),
                     is_writing_hap=False).scorer
    rg = ref_construct(p["fasta"], p["hla_vcf"], p["region"], use_index=True)
    ref = ref_call_pool(rg, ref_index(rg), p["sams"], region=RefRegion.parse(p["region"]),
                        is_writing_hap=False).scorer
    assert len(port.sites) == len(ref.sites) > 0
    for ps, rs in zip(port.sites, ref.sites):
        assert type(ps.gt.num) is type(rs.gt.num) and ps.gt.num == rs.gt.num
        for ph, rh in zip(ps.hap_samples, rs.hap_samples, strict=True):
            assert isinstance(ph.log_score, np.ndarray) and ph.log_score.dtype == rh.log_score.dtype
            np.testing.assert_array_equal(ph.log_score, rh.log_score)


def test_imgt_panel_is_the_reference_fixture(tmp_path):
    """The numpy-only builder that chip_smoke.py uses writes
    test_hla_imgt.py's panel at its full size, byte for byte, and its truth
    pairs are that file's."""
    from tests.pipeline.test_hla_imgt import _build_imgt_panel

    (tmp_path / "ref").mkdir()
    ref = _build_imgt_panel(tmp_path / "ref")
    port = build_imgt_panel(str(tmp_path / "port"))
    ref_fasta, ref_vcf, ref_panel, _, ref_carried, _ = ref
    for a, b in ((ref_fasta, port["fasta"]), (ref_vcf, port["vcf"]), (ref_panel, port["panel"])):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert port["carried"] == ref_carried
    assert imgt_truth_pairs(sorted(port["carried"]))[-2:] == [("HLA-X*03:01", "HLA-X*03:02"),
                                                              ("HLA-X*07:04", "HLA-X*07:09")]
