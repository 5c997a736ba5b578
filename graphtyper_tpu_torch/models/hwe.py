"""Exact Hardy-Weinberg excess-heterozygosity test (Wigginton 2005).

Reference: src/utilities/snp_hwe.cpp (adapted from the published snp_hwe.c).
"""

from __future__ import annotations


def p_hwe_excess_het(obs_hets: int, obs_hom1: int, obs_hom2: int) -> float:
    if obs_hom1 < 0 or obs_hom2 < 0 or obs_hets < 0:
        raise ValueError("negative genotype count")
    if obs_hets == 0 and (obs_hom1 == 0 or obs_hom2 == 0):
        return 1.0

    obs_homc = max(obs_hom1, obs_hom2)
    obs_homr = min(obs_hom1, obs_hom2)
    rare_copies = 2 * obs_homr + obs_hets
    genotypes = obs_hets + obs_homc + obs_homr

    het_probs = [0.0] * (rare_copies + 1)
    mid = int(rare_copies * (2 * genotypes - rare_copies) / (2 * genotypes))
    if (rare_copies & 1) ^ (mid & 1):
        mid += 1

    curr_hets = mid
    curr_homr = (rare_copies - mid) // 2
    curr_homc = genotypes - curr_hets - curr_homr
    het_probs[mid] = 1.0
    total = het_probs[mid]
    while curr_hets > 1:
        het_probs[curr_hets - 2] = (
            het_probs[curr_hets] * curr_hets * (curr_hets - 1.0) / (4.0 * (curr_homr + 1.0) * (curr_homc + 1.0))
        )
        total += het_probs[curr_hets - 2]
        curr_homr += 1
        curr_homc += 1
        curr_hets -= 2

    curr_hets = mid
    curr_homr = (rare_copies - mid) // 2
    curr_homc = genotypes - curr_hets - curr_homr
    while curr_hets <= rare_copies - 2:
        het_probs[curr_hets + 2] = (
            het_probs[curr_hets] * 4.0 * curr_homr * curr_homc / ((curr_hets + 2.0) * (curr_hets + 1.0))
        )
        total += het_probs[curr_hets + 2]
        curr_homr -= 1
        curr_homc -= 1
        curr_hets += 2

    het_probs = [p / total for p in het_probs]
    p_hi = sum(het_probs[obs_hets : rare_copies + 1])
    return min(p_hi, 1.0)
