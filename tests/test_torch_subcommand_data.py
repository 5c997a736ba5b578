"""Inputs of the port's HLA and camou subcommands, made with numpy from seeds,
shared by the tests and chip_smoke.py (which imports this file, so it
imports only numpy and the port: neither jax, nor the JAX package, nor
pytest), and checks that the IMGT-shaped panel has the shape it claims.

`build_imgt_panel` is tests/pipeline/test_hla_imgt.py's panel (a
class-I-shaped gene of 8 exons on a 12 kb `chr6`, 12 families x 10
alleles, 24 exon and 8 intron sites, numpy seed 60602), plus the panel VCF
that `genotype_hla` reads: one column per allele (AD 0,1 where the allele
carries the site's alt), GT_ID and FEATURE=exon|intron in INFO.
`imgt_truth_pairs` gives the 12 truth pairs of that file's
test_correct_allele_pair_rate, `write_pair_sam` one diploid sample of
read pairs as SAM text."""

import os

import numpy as np

from graphtyper_tpu_torch.utils.simulate import _random_seq, _write_fasta

L = 12_000
CHROM = "chr6"
GENE_LO, GENE_HI = 2_000, 9_800
N_EXONS = 8
EXON_LEN = (90, 270, 276, 276, 117, 66, 72, 60)


def imgt_segments():
    """[(lo, hi, is_exon)] alternating intron/exon across the gene."""
    intron_len = (GENE_HI - GENE_LO - sum(EXON_LEN)) // (N_EXONS + 1)
    segs = []
    pos = GENE_LO
    for e in range(N_EXONS):
        segs.append((pos, pos + intron_len, False))
        pos += intron_len
        segs.append((pos, pos + EXON_LEN[e], True))
        pos += EXON_LEN[e]
    segs.append((pos, GENE_HI, False))
    return segs


def build_imgt_panel(out_dir: str, n_families: int = 12, per_family: int = 10) -> dict:
    """The panel of tests/pipeline/test_hla_imgt.py:59-143 (with its own
    sizes it is that file's panel, draw for draw) under `out_dir`: ref.fa,
    sites.vcf (the graph's sites), hla.vcf (the panel VCF of genotype_hla)
    and hla_x.fa (the segment FASTA: 17 sequences an allele)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(60602)
    seq = _random_seq(rng, L)
    fasta = os.path.join(out_dir, "ref.fa")
    _write_fasta(fasta, CHROM, seq)
    segs = imgt_segments()
    exon_spans = [(lo, hi) for lo, hi, is_e in segs if is_e]
    intron_spans = [(lo, hi) for lo, hi, is_e in segs if not is_e]

    def pick_sites(spans, count, margin=8):
        sites, tries = [], 0
        while len(sites) < count and tries < 10_000:
            tries += 1
            lo, hi = spans[int(rng.integers(0, len(spans)))]
            p = int(rng.integers(lo + margin, hi - margin))
            if all(abs(p - q) > 15 for q in sites):
                sites.append(p)
        return sorted(sites)

    # polymorphism concentrated in exons 2-3: 16 of 24 exon sites there
    exon_sites = sorted(pick_sites(exon_spans[1:3], 16) + pick_sites(exon_spans[0:1] + exon_spans[3:], 8))
    intron_sites = pick_sites(intron_spans, 8)
    sites = sorted(exon_sites + intron_sites)

    def alt_of(p):
        return "ACGT"[("ACGT".index(chr(seq[p])) + 1) % 4]

    vcf = os.path.join(out_dir, "sites.vcf")
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=chr6>\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for p in sites:
            f.write(f"{CHROM}\t{p + 1}\t.\t{chr(seq[p])}\t{alt_of(p)}\t.\t.\t.\n")

    # hierarchical families: a root of 3 of the 16 exon-2/3 sites; subtype 1
    # differs from the root at an intron site only, the others add 1-2 of
    # the other exon sites and sometimes an intron site
    core, extra = exon_sites[:16], exon_sites[16:]
    carried: dict[str, set[int]] = {}
    seen: set[frozenset] = set()
    for fam in range(n_families):
        root = set(rng.choice(core, size=3, replace=False).tolist())
        for sub in range(per_family):
            name = f"HLA-X*{fam + 1:02d}:{sub + 1:02d}"
            base = set(root)
            if sub == 1:
                base.add(intron_sites[fam % len(intron_sites)])
            elif sub >= 2:
                base.update(rng.choice(extra, size=1 + (sub % 2), replace=False).tolist())
                if sub % 3 == 0:
                    base.add(intron_sites[(fam + sub) % len(intron_sites)])
            # uniquify colliding signatures by toggling intron membership
            cs, t = set(base), 1
            while frozenset(cs) in seen:
                cs = set(base)
                for bit in range(len(intron_sites)):
                    if t >> bit & 1:
                        cs.symmetric_difference_update({intron_sites[bit]})
                t += 1
            seen.add(frozenset(cs))
            carried[name] = cs
    haps = {}
    for name, cs in carried.items():
        h = seq.copy()
        for p in cs:
            h[p] = ord(alt_of(p))
        haps[name] = h

    panel = os.path.join(out_dir, "hla_x.fa")
    with open(panel, "w") as f:
        for name, h in haps.items():
            for k, (lo, hi, _is_e) in enumerate(segs):
                f.write(f">{name}.{k}\n" + h[lo:hi].tobytes().decode() + "\n")

    # the panel VCF of genotype_hla: sample columns are the alleles
    hla_vcf = os.path.join(out_dir, "hla.vcf")
    names = list(carried)
    exonic = set(exon_sites)
    with open(hla_vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=chr6>\n"
                '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="depth">\n'
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(names) + "\n")
        for i, p in enumerate(sites):
            cols = "\t".join("0,1" if p in carried[n] else "1,0" for n in names)
            feature = "exon" if p in exonic else "intron"
            f.write(f"{CHROM}\t{p + 1}\t.\t{chr(seq[p])}\t{alt_of(p)}\t.\t.\t"
                    f"GT_ID={i + 1};FEATURE={feature}\tAD\t{cols}\n")
    return dict(dir=out_dir, fasta=fasta, vcf=vcf, hla_vcf=hla_vcf, panel=panel, haps=haps,
                carried=carried, sites=sites, exon_sites=exon_sites, intron_sites=intron_sites)


def imgt_truth_pairs(names: list[str]) -> list[tuple[str, str]]:
    """The truth pairs of test_hla_imgt.py's test_correct_allele_pair_rate
    (numpy seed 7171) over the sorted allele names: 8 hets, 2 homs, a root
    with its intron-only subtype, two subtypes of one family."""
    rng = np.random.default_rng(7171)
    truth = []
    for _ in range(8):
        a, b = rng.choice(len(names), size=2, replace=False)
        truth.append((names[int(a)], names[int(b)]))
    for _ in range(2):
        a = int(rng.integers(0, len(names)))
        truth.append((names[a], names[a]))
    return truth + [("HLA-X*03:01", "HLA-X*03:02"), ("HLA-X*07:04", "HLA-X*07:09")]


def write_pair_sam(path: str, name: str, hap_a, hap_b, seed: int, n_pairs: int = 1100,
                   chrom: str = CHROM, length: int = L) -> str:
    """test_hla_imgt.py's _write_sample: n_pairs 125 bp pairs, fragment 320,
    alternating between the two haplotypes."""
    rng = np.random.default_rng(seed)
    records = []
    read_len, frag = 125, 320
    for i in range(n_pairs):
        hap = (hap_a, hap_b)[i % 2]
        start = int(rng.integers(0, length - frag))
        r1 = hap[start : start + read_len].tobytes().decode()
        r2 = hap[start + frag - read_len : start + frag].tobytes().decode()
        q = "I" * read_len
        records.append((start, f"{name}_r{i}\t99\t{chrom}\t{start + 1}\t60\t{read_len}M\t=\t"
                               f"{start + frag - read_len + 1}\t{frag}\t{r1}\t{q}"))
        records.append((start + frag - read_len, f"{name}_r{i}\t147\t{chrom}\t"
                                                 f"{start + frag - read_len + 1}\t60\t{read_len}M\t=\t"
                                                 f"{start + 1}\t{-frag}\t{r2}\t{q}"))
    records.sort(key=lambda t: t[0])
    with open(path, "w") as f:
        f.write(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{chrom}\tLN:{length}\n@RG\tID:rg\tSM:{name}\n")
        for _, line in records:
            f.write(line + "\n")
    return path


def test_imgt_panel_shape(tmp_path):
    """120 alleles x 17 segments, every pair distinguishable somewhere, and a
    panel VCF with one AD column per allele that marks exactly its sites."""
    from graphtyper_tpu_torch.typer.segment_calling import read_haplotypes_from_fasta

    p = build_imgt_panel(str(tmp_path))
    alleles = read_haplotypes_from_fasta(p["panel"])
    assert len(alleles) == 120
    assert all(len(v) == 2 * N_EXONS + 1 for v in alleles.values())
    assert len({frozenset(c) for c in p["carried"].values()}) == 120
    assert (len(p["exon_sites"]), len(p["intron_sites"])) == (24, 8)
    with open(p["hla_vcf"]) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if not line.startswith("##")]
    names = rows[0][9:]
    assert names == list(p["carried"])
    for row in rows[1:]:
        pos0 = int(row[1]) - 1
        assert [c == "0,1" for c in row[9:]] == [pos0 in p["carried"][n] for n in names]


def test_imgt_truth_pairs_are_panel_alleles(tmp_path):
    p = build_imgt_panel(str(tmp_path), n_families=8, per_family=10)
    names = sorted(p["carried"])
    truth = imgt_truth_pairs(names)
    assert len(truth) == 12 and all(a in p["carried"] and b in p["carried"] for a, b in truth)
