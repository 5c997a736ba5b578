"""The port's `genotype_lr` (host-only, as in the JAX package) against the
JAX package's on the inputs of tests/pipeline/test_cli_tools.py
test_lr_genotyping and test_lr_coverage_filter: byte-identical VCF bodies
through the function and through both CLIs, and equal pileups with the
coverage filter on and off."""

import contextlib
import gzip
import hashlib
import io

import numpy as np
import pytest

from graphtyper_tpu import cli as ref_cli
from graphtyper_tpu import config as ref_config
from graphtyper_tpu.pipeline.genotype_lr import genotype_lr as ref_genotype_lr
from graphtyper_tpu_torch import cli, config
from graphtyper_tpu_torch.pipeline.genotype_lr import genotype_lr, genotype_lr_regions


def _md5(paths):
    h = hashlib.md5()
    for p in sorted(paths):
        with gzip.open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _reset_options():
    for cfg in (config, ref_config):
        cfg.set_options(cfg.DEFAULT_OPTIONS)


@pytest.fixture
def lr_input(tmp_path):
    """test_lr_genotyping: a 400 bp contig, 30 single-end 200 bp reads of
    two haplotypes that differ at position 151."""
    rng = np.random.default_rng(9)
    ref = "".join(rng.choice(list("ACGT"), 400))
    fa = tmp_path / "lr.fa"
    with open(fa, "w") as f:
        f.write(">chrL\n")
        for i in range(0, 400, 70):
            f.write(ref[i : i + 70] + "\n")
    alt_base = "A" if ref[150] != "A" else "G"
    hap2 = ref[:150] + alt_base + ref[151:]
    lines = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:chrL\tLN:400", "@RG\tID:rg\tSM:lr1"]
    recs = []
    for i in range(30):
        hap = ref if i % 2 == 0 else hap2
        s = int(rng.integers(0, 200))
        recs.append((s, f"lr{i}\t0\tchrL\t{s + 1}\t50\t200M\t*\t0\t0\t{hap[s : s + 200]}\t{'F' * 200}"))
    recs.sort()
    sam = tmp_path / "lr.sam"
    sam.write_text("\n".join(lines + [r[1] for r in recs]) + "\n")
    return str(fa), str(sam), tmp_path


def test_genotype_lr_matches_reference(lr_input):
    fa, sam, tmp = lr_input
    _reset_options()
    ref = ref_genotype_lr(fa, [sam], "chrL", str(tmp / "ref"))
    port = genotype_lr(fa, [sam], "chrL", str(tmp / "port"))
    assert ref.rsplit("/", 2)[1:] == port.rsplit("/", 2)[1:]
    assert _md5([port]) == _md5([ref])
    with gzip.open(port, "rt") as f:
        body = [line.split("\t") for line in f if not line.startswith("#")]
    assert len(body) == 1 and body[0][1] == "151" and body[0][9].split(":")[0] == "0/1"
    assert genotype_lr_regions(fa, [sam], ["chrL:1-200", "chrL:201-400"], str(tmp / "regions")) == [
        str(tmp / "regions" / "chrL" / "000000001-000000200.vcf.gz"),
        str(tmp / "regions" / "chrL" / "000000201-000000400.vcf.gz"),
    ]


def test_genotype_lr_cli_matches_reference(lr_input):
    """genotype_lr through both CLIs; it takes no --device in either."""
    fa, sam, tmp = lr_input
    outs = []
    for main, name in ((ref_cli.main, "ref"), (cli.main, "port")):
        buf = io.StringIO()
        _reset_options()
        try:
            with contextlib.redirect_stdout(buf):
                assert main(["genotype_lr", fa, "--region", "chrL", "-O", str(tmp / name), f"--sam={sam}"]) == 0
        finally:
            _reset_options()
        outs.append(buf.getvalue().split()[-1])
    assert _md5(outs[1:]) == _md5(outs[:1])
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["genotype_lr", fa, "--device", "cpu", sam])


@pytest.mark.parametrize("coverage_filter", [5, 0])
def test_lr_pileup_coverage_filter_matches_reference(coverage_filter):
    """test_lr_coverage_filter's reads: five at 0 saturate 0..199, then one
    at 100 (skipped under the filter) and one at 199."""
    from graphtyper_tpu.config import Options as RefOptions
    from graphtyper_tpu.io.bam import AlignedRead as RefRead
    from graphtyper_tpu.typer.discovery_lr import lr_pileup as ref_pileup
    from graphtyper_tpu_torch.config import Options
    from graphtyper_tpu_torch.io.bam import AlignedRead
    from graphtyper_tpu_torch.typer.discovery_lr import lr_pileup

    def reads(cls):
        return [cls(name=f"r{pos}", flag=0, ref_id=0, pos=pos, mapq=60, cigar=[(0, 200)],
                    mate_ref_id=-1, mate_pos=-1, tlen=0, seq=b"A" * 200,
                    qual=np.full(200, 40, dtype=np.uint8)) for pos in [0] * 5 + [100, 199]]

    want = ref_pileup(reads(RefRead), 0, 500, RefOptions(lr_coverage_filter=coverage_filter))
    got = lr_pileup(reads(AlignedRead), 0, 500, Options(lr_coverage_filter=coverage_filter))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0][150].sum() == (5 if coverage_filter else 6)
