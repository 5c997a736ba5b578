"""The port's subcommands that take SAM/BAM paths take them as positional
arguments, after the options, before them or among them, and give the
same list as `--sam`. Held under this interpreter's argparse and under the
positional matching of older Python 3.12 patch releases, where a trailing
nargs="*" positional is matched empty at the subcommand's own positionals
once options follow (the JAX package's parser, which has one, fails there)."""

import argparse
import re

import pytest

from graphtyper_tpu import cli as ref_cli
from graphtyper_tpu_torch import cli

# subcommand: its own positionals (the documented form of graphtyper_tpu/cli.py)
SUBCOMMANDS = {
    "genotype": ["ref.fa"],
    "genotype_sv": ["ref.fa", "sv.vcf.gz"],
    "genotype_lr": ["ref.fa"],
    "genotype_camou": ["ref.fa", "intervals.bed"],
    "genotype_hla": ["ref.fa", "hla.vcf.gz"],
    "discover": ["ref.fa"],
}
OPTIONS = ["--region", "chr1:1-5000", "-O", "out", "--threads", "3"]
SAMS = ["a.bam", "b.bam", "c.bam"]


def _match_partial_older(self, actions, arg_strings_pattern):
    """argparse.ArgumentParser._match_arguments_partial without the trim of
    empty trailing matches before an option, as older releases have it."""
    result = []
    for i in range(len(actions), 0, -1):
        pattern = "".join(self._get_nargs_pattern(action) for action in actions[:i])
        match = re.match(pattern, arg_strings_pattern)
        if match is not None:
            result.extend(len(string) for string in match.groups())
            break
    return result


@pytest.fixture(params=["installed", "older"])
def matching(request, monkeypatch):
    if request.param == "older":
        monkeypatch.setattr(argparse.ArgumentParser, "_match_arguments_partial", _match_partial_older)
    return request.param


def _sams(argv):
    return cli._read_sams_arg(cli.parse_args(argv))


@pytest.mark.parametrize("placement", ["after", "before", "among"])
@pytest.mark.parametrize("sub", sorted(SUBCOMMANDS))
def test_positional_sams_equal_sam_flags(matching, sub, placement):
    own = SUBCOMMANDS[sub]
    argv = {
        "after": [sub, *own, *OPTIONS, *SAMS],
        "before": [sub, *own, *SAMS, *OPTIONS],
        "among": [sub, own[0], *OPTIONS[:2], *own[1:], SAMS[0], *OPTIONS[2:], *SAMS[1:]],
    }[placement]
    flags = [sub, *own, *OPTIONS, *(a for s in SAMS for a in ("--sam", s))]
    assert _sams(argv) == _sams(flags) == SAMS
    args = cli.parse_args(argv)
    assert args.region == "chr1:1-5000" and args.output == "out" and args.threads == 3
    assert args.ref == "ref.fa"


def test_sam_flags_and_file_of_files_still_work(tmp_path):
    listing = tmp_path / "sams.txt"
    listing.write_text("c.bam\nd.bam\n")
    assert _sams(["genotype", "ref.fa", "--sam", "a.bam", "--sams", str(listing), "b.bam"]) == [
        "a.bam", "c.bam", "d.bam", "b.bam"]


@pytest.mark.parametrize("argv", [
    ["genotype", "ref.fa", "--bogus", "a.bam"],  # an unknown option
    ["call", "graph.npz", "a.bam"],  # call takes --sam only
    ["popvcf", "encode", "in.vcf", "out.vcf", "extra"],  # no SAM paths at all
])
def test_leftovers_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(argv)
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_older_matching_refuses_the_reference_parsers_form(monkeypatch):
    """Why the port parses the leftovers itself: under the older matching
    the JAX package's nargs="*" positional leaves trailing paths
    unrecognized, and the port's parse takes them."""
    monkeypatch.setattr(argparse.ArgumentParser, "_match_arguments_partial", _match_partial_older)
    argv = ["genotype", "ref.fa", *OPTIONS, *SAMS]
    with pytest.raises(SystemExit):
        ref_cli.build_parser().parse_args(argv)
    assert _sams(argv) == SAMS
