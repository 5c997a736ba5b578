"""The port's typer/haplotype_extractor.py and typer/variant_map.py against
the JAX package's: the 14 cases of tests/typer/test_haplotype_extractor.py
run through both packages, and on a simulated graph with mutated reads the
candidates, the pooled and filtered VariantMap and its save/load round trip
equal field for field. A pickle holds its package's class paths, so the
packages' pickles are compared by the fields each loads, never by bytes."""

import dataclasses
import inspect
import os
import pathlib
import re
import types

import numpy as np
import pytest

import graphtyper_tpu.constants as ref_constants
import graphtyper_tpu.graph.build as ref_build
import graphtyper_tpu.typer.haplotype_extractor as ref_hx
import graphtyper_tpu.typer.variant_map as ref_vm
import graphtyper_tpu_torch.constants as port_constants
import graphtyper_tpu_torch.graph.build as port_build
import graphtyper_tpu_torch.typer.haplotype_extractor as port_hx
import graphtyper_tpu_torch.typer.variant_map as port_vm
from graphtyper_tpu_torch.io.bam import read_alignments
from graphtyper_tpu_torch.utils.simulate import SimConfig, simulate_cohort

TESTS = pathlib.Path(__file__).resolve().parent
SRC = (TESTS / "typer" / "test_haplotype_extractor.py").read_text()
PACKAGES = {
    "graphtyper_tpu": (ref_constants, ref_build, ref_hx, ref_vm),
    "graphtyper_tpu_torch": (port_constants, port_build, port_hx, port_vm),
}


def _case_module(pkg: str) -> types.ModuleType:
    """tests/typer/test_haplotype_extractor.py with its imports pointed at `pkg`."""
    src = re.sub(r"\bgraphtyper_tpu\.", f"{pkg}.", SRC)
    mod = types.ModuleType(f"haplotype_cases_{pkg}")
    exec(compile(src, f"<test_haplotype_extractor.py on {pkg}>", "exec"), mod.__dict__)
    return mod


CASE_MODULES = {pkg: _case_module(pkg) for pkg in PACKAGES}
CASES = sorted(n for n in vars(CASE_MODULES["graphtyper_tpu"]) if n.startswith("test_"))


def test_all_cases_collected():
    assert len(CASES) == 14
    port = CASE_MODULES["graphtyper_tpu_torch"]
    assert port.VariantMap is port_vm.VariantMap and port.construct_graph is port_build.construct_graph
    assert port.get_gapped_strings is port_hx.get_gapped_strings


@pytest.mark.parametrize("case", CASES)
def test_case_on_both_packages(case, data_dir, tmp_path):
    for pkg, mod in CASE_MODULES.items():
        fn = getattr(mod, case)
        kwargs = {}
        for name in inspect.signature(fn).parameters:
            if name == "data_dir":
                kwargs[name] = data_dir
            elif name == "tmp_path":
                kwargs[name] = tmp_path / pkg
                kwargs[name].mkdir()
        fn(**kwargs)


def _cand_fields(c):
    return (c.abs_pos, c.original_pos, list(c.seqs), c.flags)


def _pool_fields(vm):
    return sorted(
        (_cand_fields(c), [dataclasses.asdict(s) for s in sups]) for c, sups in vm.pool_varmap.items()
    )


TRANSITION = {ord("A"): b"G", ord("G"): b"A", ord("C"): b"T", ord("T"): b"C"}


def _read_flags(flag: int) -> int:
    out = 0
    if flag & 0x2:
        out |= ref_constants.IS_PROPER_PAIR
    if flag & 0x10:
        out |= ref_constants.IS_REVERSED
    if flag & 0x40:
        out |= ref_constants.IS_FIRST_IN_PAIR
    return out


@pytest.fixture(scope="module")
def mutated_reads(tmp_path_factory):
    """A simulated 2-sample cohort and recurrent events at fixed positions
    (transition SNPs, deletions and insertions of 1-4 bp, each carried by
    70 % of the reads over it) with one-read transversion noise. Returns
    the cohort, the rows of the extractor (sample, ref window, mutated
    read, quals, read flags: 40 reads a sample) and, per read, the
    candidates of its events as (sample, [(abs_pos, original_pos, seqs,
    flags)]) for the VariantMap."""
    d = tmp_path_factory.mktemp("hapx")
    cfg = SimConfig(region_length=12_000, coverage=6.0, n_samples=2, seed=23, out_format="bam")
    sim = simulate_cohort(str(d), cfg)
    ref = bytes(port_build.construct_graph(sim.fasta, None, cfg.chrom).reference)
    rng = np.random.default_rng(5)
    kinds = ("snp", "snp", "del", "ins")
    events = sorted((int(p), kinds[i % 4], int(rng.integers(1, 5)))
                    for i, p in enumerate(rng.choice(np.arange(200, cfg.region_length - 200, 37), 90,
                                                     replace=False)))
    ext_rows, read_cands = [], []
    for sample, path in enumerate(sim.sams):
        _, reads = read_alignments(path)
        n_ext = 0
        for r in reads:
            L = len(r.seq)
            if r.cigar != [(0, L)] or r.pos < 60:
                continue
            hits = [e for e in events if r.pos + 20 <= e[0] < r.pos + L - 20 and rng.random() < 0.7]
            if rng.random() < 0.1:
                hits.append((r.pos + int(rng.integers(20, L - 20)), "noise", 1))
            if not hits:
                continue
            flags = _read_flags(r.flag)
            seq = bytearray(bytes(r.seq))
            cands = []
            for pos, kind, n in sorted(hits, reverse=True):
                at, base = pos - r.pos, ref[pos : pos + 1]
                if kind == "snp":
                    alt = TRANSITION.get(base[0], b"A")
                elif kind == "noise":
                    alt = b"T" if base in (b"A", b"G") else b"A"
                if kind in ("snp", "noise"):
                    seq[at : at + 1] = alt
                    low = ref_constants.IS_LOW_BASE_QUAL if rng.random() < 0.1 else 0
                    cands.append((pos + 1, r.pos, [base, alt], flags | low))
                elif kind == "del":
                    del seq[at + 1 : at + 1 + n]
                    cands.append((pos + 1, r.pos, [ref[pos : pos + 1 + n], base], flags))
                else:
                    ins = b"ACGT"[n - 1 :] + b"T" * (n - 1)
                    seq[at + 1 : at + 1] = ins
                    cands.append((pos + 1, r.pos, [base, base + ins], flags))
            read_cands.append((sample, cands))
            if n_ext < 40:
                n_ext += 1
                qual = bytes(int(q) + 33 for q in np.asarray(r.qual))
                ext_rows.append((sample, (r.pos - 10, r.pos + L + 10), bytes(seq), qual, flags))
    return sim, cfg, ext_rows, read_cands


def _run_package(pkg, sim, cfg, ext_rows, read_cands, tmp):
    constants, build, hx, vm_mod = PACKAGES[pkg]
    g = build.construct_graph(sim.fasta, None, cfg.chrom)
    reference = bytes(g.reference)
    found_rows = []
    for _sample, (lo, hi), seq, qual, _flags in ext_rows:
        found_rows.append([_cand_fields(c) for c in
                           hx.find_variants_in_alignment(g, lo + 1, reference[lo:hi], seq, qual)])
    vm = vm_mod.VariantMap(n_samples=cfg.n_samples, minimum_variant_support=3)
    vm.set_samples([f"s{i}" for i in range(cfg.n_samples)])
    for sample, cands in read_cands:
        vm.add_variants(g, [vm_mod.VariantCandidate(p, o, list(seqs), f) for p, o, seqs, f in cands], sample)
    per_sample = [sorted((_cand_fields(c), dataclasses.asdict(s)) for c, s in m.items()) for m in vm.varmaps]
    vm.create_varmap_for_all(None)
    pooled = _pool_fields(vm)
    vm.filter_varmap_for_all(g)
    filtered = _pool_fields(vm)
    variants = [_cand_fields(c) for c in vm.get_variants()]
    path = os.path.join(tmp, f"{pkg}.pkl")
    vm.save(path)
    loaded = vm_mod.VariantMap.load(path)
    assert all(type(c) is vm_mod.VariantCandidate for c in loaded.pool_varmap)
    return dict(found=found_rows, per_sample=per_sample, pooled=pooled, filtered=filtered, variants=variants,
                loaded=(loaded.samples, _pool_fields(loaded), [_cand_fields(c) for c in loaded.get_variants()],
                        loaded.minimum_variant_support, loaded.minimum_variant_support_ratio))


def test_variant_map_on_simulated_graph(mutated_reads, tmp_path):
    sim, cfg, ext_rows, read_cands = mutated_reads
    want = _run_package("graphtyper_tpu", sim, cfg, ext_rows, read_cands, str(tmp_path))
    got = _run_package("graphtyper_tpu_torch", sim, cfg, ext_rows, read_cands, str(tmp_path))
    # the extractor finds candidates; every sample holds enough of them that
    # the adaptive support cutoff is tried; the cutoff drops the noise
    assert sum(len(f) for f in want["found"]) >= 40
    assert all(len(m) > 50 for m in want["per_sample"])
    assert 0 < len(want["filtered"]) <= len(want["pooled"]) < min(map(len, want["per_sample"]))
    for key in want:
        assert got[key] == want[key], key
    # the round trip keeps every pooled field
    assert got["loaded"][1] == got["filtered"] and got["loaded"][2] == got["variants"]
