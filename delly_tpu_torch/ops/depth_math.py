"""Shared read-depth window math: ONE implementation used by both the
host CNV driver (models/coral.py window output) and the sharded
multi-chip depth step (parallel/depth_step.py), so the mesh path can
never drift from production semantics.

Formulas are the reference's: coral.h:296-414 (purity/ploidy-adjusted
CN and logR per window) and bolog.h:88-133 (Gaussian CN
log10-likelihoods with SMALLEST_GL clamping). Functions take the array
module (numpy or torch) so the identical expression graph runs on host
or device.
"""

from __future__ import annotations

import math

SMALLEST_GL = -1000.0
_LOG10E = 0.4342944819032518
# double-precision exp() underflows to 0.0 below this argument; the
# scalar path (ops.likelihood.compute_cnls, mirroring bolog.h:94-96
# log10(pdf) in double) therefore snaps any such tail to SMALLEST_GL.
_EXP_UNDERFLOW = -745.1332191019412


def window_cn_ratio(xp, covsum, expcov, expected_cn, purity, ctrl_ploidy,
                    chr_ploidy):
    """Per-window copy number and depth ratio (coral.h:296-414):
    cn = (expected_cn * cov/exp - ctrl_ploidy*(1-purity)) / purity and
    ratio = (cov+1)/(exp+1); windows without expected coverage report
    the chromosome ploidy. Only +, -, * and /, so the mesh route
    (parallel/depth_step.py) runs it on the card."""
    ok = expcov > 0
    safe = xp.where(ok, expcov, 1.0)
    cn = xp.where(
        ok,
        (expected_cn * covsum / safe - ctrl_ploidy * (1.0 - purity))
        / purity,
        chr_ploidy)
    return cn, (covsum + 1.0) / (safe + 1.0)


def window_logr(xp, expcov, ratio):
    """logR = log2 of window_cn_ratio's ratio; 0 for windows without
    expected coverage."""
    return xp.where(expcov > 0, xp.log2(ratio), 0.0)


def window_depth(xp, covsum, expcov, expected_cn, purity, ctrl_ploidy,
                 chr_ploidy):
    """Per-window copy number + log2 ratio (coral.h:296-414):
    window_cn_ratio's cn and window_logr of its ratio."""
    cn, ratio = window_cn_ratio(xp, covsum, expcov, expected_cn, purity,
                                ctrl_ploidy, chr_ploidy)
    return cn, window_logr(xp, expcov, ratio)


def cn_log10_likelihoods(xp, mean, sd, max_cn: int = 10):
    """(W, max_cn) Gaussian CN log10-likelihoods, clamped at
    SMALLEST_GL (bolog.h:88-133 / ops.likelihood.compute_cnls).

    Tail semantics match the scalar/host path exactly: bolog.h takes
    log10 of a double pdf, so once exp(-z^2/2) underflows the value
    snaps straight to SMALLEST_GL — log-likelihoods between the
    underflow point (~-323) and SMALLEST_GL (-1000) are unreachable.
    The analytic log-form here reproduces that by gating on the exp
    argument rather than clamping the analytic value alone.
    """
    genos = xp.arange(max_cn, dtype=mean.dtype)
    z = (genos[None, :] - mean[:, None]) / sd[:, None]
    exp_arg = -0.5 * z * z
    log10pdf = exp_arg * _LOG10E \
        - xp.log10(sd[:, None]) - 0.5 * math.log10(2.0 * math.pi)
    return xp.where(exp_arg < _EXP_UNDERFLOW, SMALLEST_GL,
                    xp.maximum(log10pdf, SMALLEST_GL))
