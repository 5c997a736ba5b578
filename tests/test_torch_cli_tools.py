"""Each subcommand of the port's CLI besides the genotyping pipelines,
through both CLIs on the same inputs (tests/data and a small simulated
cohort): construct + check, bamshrink, call and discover (the port on
--device cpu), popvcf encode/decode, vcf_break_down, vcf_concatenate,
vcf_merge and index. Outputs compare byte for byte (VCFs uncompressed);
the two parsers offer the same subcommands, and --device only where there
is device work."""

import contextlib
import gzip
import hashlib
import io

import numpy as np
import pytest

from graphtyper_tpu import cli as ref_cli
from graphtyper_tpu import config as ref_config
from graphtyper_tpu.utils.simulate import SimConfig, simulate_cohort
from graphtyper_tpu_torch import cli, config, counters

DEVICE_SUBCOMMANDS = ("genotype", "genotype_sv", "genotype_camou", "genotype_hla", "discover", "call")


def _reset_options():
    for cfg in (config, ref_config):
        cfg.set_options(cfg.DEFAULT_OPTIONS)


def _run(main, argv):
    """(rc, stdout, stderr) of one in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    _reset_options()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        _reset_options()
    return rc, out.getvalue(), err.getvalue()


def _both(argv_of, device=False):
    """Run argv_of(tag) through the JAX CLI (tag "ref") and the port's (tag
    "port", with --device cpu where the subcommand has one)."""
    ref = _run(ref_cli.main, argv_of("ref"))
    port = _run(cli.main, argv_of("port") + (["--device", "cpu"] if device else []))
    assert ref[0] == port[0] == 0, (ref, port)
    return ref, port


def _text(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _md5(path):
    return hashlib.md5(_text(path)).hexdigest()


def test_parsers_offer_the_same_subcommands():
    def choices(parser):
        return parser._subparsers._group_actions[0].choices

    ref, port = choices(ref_cli.build_parser()), choices(cli.build_parser())
    assert set(ref) == set(port) and len(port) == 15
    for name, sub in port.items():
        port_flags = {o for a in sub._actions for o in a.option_strings}
        ref_flags = {o for a in ref[name]._actions for o in a.option_strings}
        assert port_flags - ref_flags == ({"--device"} if name in DEVICE_SUBCOMMANDS else set()), name
        assert ref_flags <= port_flags, name


def test_construct_and_check(tmp_path, data_dir):
    ref, port = _both(lambda t: ["construct", str(tmp_path / f"{t}.npz"), str(data_dir / "index_test.fa"),
                                 "--vcf", str(data_dir / "index_test.vcf.gz"), "--region", "chr2"])
    assert port[1].replace("port.npz", "ref.npz") == ref[1]
    with np.load(tmp_path / "ref.npz", allow_pickle=True) as r, np.load(tmp_path / "port.npz", allow_pickle=True) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            np.testing.assert_array_equal(p[k], r[k])
    ref, port = _both(lambda t: ["check", str(tmp_path / f"{t}.npz")])
    assert "check=OK" in port[1] and port[1].replace("port.npz", "ref.npz") == ref[1]


def test_bamshrink(tmp_path):
    """test_cli_tools.py test_bamshrink_filters_and_renames' SAM."""
    rng = np.random.default_rng(2)
    ref = "".join(rng.choice(list("ACGT"), 300))
    s, n = 50, 100
    lines = ["@HD\tVN:1.6", "@SQ\tSN:c\tLN:300", "@RG\tID:rg\tSM:s",
             f"good\t99\tc\t{s + 1}\t60\t{n}M\t=\t{s + 21}\t{n + 20}\t{ref[s:s + n]}\t{'I' * n}",
             f"good\t147\tc\t{s + 21}\t60\t{n}M\t=\t{s + 1}\t{-(n + 20)}\t{ref[s + 20:s + 20 + n]}\t{'I' * n}",
             f"bad1\t99\tc\t{s + 1}\t1\t{n}M\t=\t{s + 21}\t{n + 20}\t{ref[s:s + n]}\t{'I' * n}",
             f"bad2\t99\tc\t{s + 1}\t60\t50M\t=\t{s + 11}\t60\t{ref[s:s + 50]}\t{'I' * 50}"]
    sam = tmp_path / "in.sam"
    sam.write_text("\n".join(lines) + "\n")
    _both(lambda t: ["bamshrink", str(sam), str(tmp_path / f"{t}.sam"), "--region", "c:1-300"])
    assert _text(str(tmp_path / "port.sam")) == _text(str(tmp_path / "ref.sam"))
    assert sum(1 for line in _text(str(tmp_path / "port.sam")).decode().splitlines() if not line.startswith("@")) == 2


@pytest.fixture(scope="module")
def called(tmp_path_factory):
    """A 2-sample 8 kb BAM cohort (test_cli_call_subcommand's shape), its
    graph from the truth VCF, and `call` through both CLIs on the cohort and
    on each sample alone; the printed VCF paths."""
    tmp = tmp_path_factory.mktemp("torch_cli_tools")
    cfg = SimConfig(region_length=8000, coverage=16.0, n_samples=2, seed=77, out_format="bam")
    sim = simulate_cohort(str(tmp / "sim"), cfg)
    graph = str(tmp / "g.npz")
    assert _run(cli.main, ["construct", graph, sim.fasta, "--vcf", sim.vcf, "--region", f"{cfg.chrom}:1-8000"])[0] == 0
    outs = {}
    for name, sams in (("all", sim.sams), ("s0", sim.sams[:1]), ("s1", sim.sams[1:])):
        counters.reset()
        ref, port = _both(lambda t: ["call", graph, *[f"--sam={s}" for s in sams], f"--output={tmp}/{t}_{name}"],
                          device=True)
        assert counters.totals().get("scoring_rows", 0) > 0
        outs[name] = (ref[1].split()[-1], port[1].split()[-1])
    return tmp, sim, cfg, graph, outs


def test_call(called):
    _, _, _, _, outs = called
    for ref, port in outs.values():
        assert _md5(port) == _md5(ref)
        assert any(line.split("\t")[9].split(":")[0] in ("0/1", "1/1")
                   for line in _text(port).decode().splitlines() if not line.startswith("#"))


def test_discover(called):
    tmp, sim, cfg, _, _ = called
    counters.reset()
    ref, port = _both(lambda t: ["discover", sim.fasta, "--region", f"{cfg.chrom}:1-8000", "-O",
                                 str(tmp / f"disc_{t}"), *[f"--sam={s}" for s in sim.sams]], device=True)
    assert _md5(port[1].split()[-1]) == _md5(ref[1].split()[-1])
    assert counters.totals().get("pileup_rows", 0) > 0


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_popvcf(called, mode):
    tmp, _, _, _, outs = called
    src = outs["all"][0]
    if mode == "decode":
        src = str(tmp / "encoded.vcf.gz")
        _run(ref_cli.main, ["popvcf", "encode", outs["all"][0], src])
    _both(lambda t: ["popvcf", mode, src, str(tmp / f"pop_{mode}_{t}.vcf.gz")])
    assert _text(str(tmp / f"pop_{mode}_port.vcf.gz")) == _text(str(tmp / f"pop_{mode}_ref.vcf.gz"))


def test_vcf_break_down(called):
    tmp, _, cfg, graph, outs = called
    _both(lambda t: ["vcf_break_down", graph, outs["all"][0], "--output", str(tmp / f"bd_{t}.vcf.gz"),
                     "--region", f"{cfg.chrom}:1-8000"])
    assert _md5(str(tmp / "bd_port.vcf.gz")) == _md5(str(tmp / "bd_ref.vcf.gz"))


def test_vcf_concatenate(called):
    tmp, _, _, _, outs = called
    _both(lambda t: ["vcf_concatenate", outs["s0"][0], outs["s1"][0], "--output", str(tmp / f"cat_{t}.vcf.gz")])
    assert _md5(str(tmp / "cat_port.vcf.gz")) == _md5(str(tmp / "cat_ref.vcf.gz"))


def test_vcf_merge(called):
    tmp, _, _, _, outs = called
    _both(lambda t: ["vcf_merge", outs["s0"][0], outs["s1"][0], "--output", str(tmp / f"merge_{t}.vcf.gz")])
    text = _text(str(tmp / "merge_port.vcf.gz"))
    assert text == _text(str(tmp / "merge_ref.vcf.gz"))
    assert text.decode().split("\n#CHROM", 1)[1].split("\n", 1)[0].count("\t") == 10  # two samples


def test_index_is_deprecated():
    ref, port = _both(lambda t: ["index"])
    assert port[2] == ref[2] and "deprecated" in port[2]
