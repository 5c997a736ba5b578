"""Logistic quality models: AAScore and LOGF.

Coefficients mirror the reference's trained models
(include/graphtyper/typer/logistic_constants.hpp) — these are published
model constants, required for output parity.
"""

from __future__ import annotations

import math

_LOGF_INTERCEPT = -29.28908
_LOGF_ABHOM = 23.12909
_LOGF_CR_BY_SEQDEPTH = -10.22658
_LOGF_MQ = 0.01024
_LOGF_PASS_RATIO = 0.85320
_LOGF_GT_YIELD = 4.91178
_LOGF_QD = 0.23215

_LOGF_ABHET = [-6.03446, -6.03446, -1.35948, -0.84956, -0.28956, 0.0, -1.05013, -1.35024, -1.34475, -3.74512, -3.74512]
_LOGF_SBALT = [-0.32486, -0.32486, -0.25342, -0.32696, 0.02442, 0.0, -0.33522, -0.41332, -0.74043, -1.60844, -1.60844]


def get_logf(
    abhom: float,
    cr_by_seqdepth: float,
    mq: float,
    pass_ratio: float,
    gt_yield: float,
    qd: float,
    ab_het_bin: int,
    sbalt_bin: int,
) -> float:
    pwr = (
        _LOGF_INTERCEPT
        + abhom * _LOGF_ABHOM
        + cr_by_seqdepth * _LOGF_CR_BY_SEQDEPTH
        + mq * _LOGF_MQ
        + pass_ratio * _LOGF_PASS_RATIO
        + gt_yield * _LOGF_GT_YIELD
        + qd * _LOGF_QD
        + _LOGF_ABHET[ab_het_bin]
        + _LOGF_SBALT[sbalt_bin]
    )
    try:
        _exp = max(0.0, math.exp(-pwr))
    except OverflowError:
        _exp = float("inf")
    return 1.0 / (1.0 + _exp)


_AA_INTERCEPT = -6.347426707
_AA_SB = -0.25233400
_AA_MM = -0.04129973
_AA_SD = 0.014572295
_AA_QD = 0.065221319
_AA_CR = -0.01934834
_AA_MQ = 0.055973424
_AA_ABHOM = [0.0, 1.304140117, 1.681221065, 2.214801195, 3.930106559]


def get_aa_score(abhom: float, sb: float, mm: float, sd: int, qd: float, cr: float, mq: int) -> float:
    if abhom <= 0.85:
        abhom_bin = 0
    elif abhom <= 0.94:
        abhom_bin = 1
    elif abhom <= 0.98:
        abhom_bin = 2
    elif abhom <= 0.99:
        abhom_bin = 3
    else:
        abhom_bin = 4
    mq = min(mq, 60)
    pwr = (
        _AA_INTERCEPT
        + _AA_ABHOM[abhom_bin]
        + sb * _AA_SB
        + mm * _AA_MM
        + sd * _AA_SD
        + qd * _AA_QD
        + cr * _AA_CR
        + mq * _AA_MQ
    )
    try:
        _exp = math.exp(-pwr)
    except OverflowError:
        _exp = float("inf")
    return 1.0 / (1.0 + _exp)
