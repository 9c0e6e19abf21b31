"""Population genetics estimators over genotype likelihoods.

Reference: src/popgen.h — EM allele frequency under HWE, EM genotype
frequencies, inbreeding coefficient FIC, imputation R², dosage R²
between sites, and an HWE likelihood-ratio χ² test.

The reference accumulates every per-sample loop sequentially in
float64; vectorized pairwise summation (numpy) differs in the last ulp
on cohorts ≥8 samples and the drift compounds through the EM
iterations, so exact parity requires the same accumulation order
(pinned by tests/test_stats_oracle.py against popgen.h compiled
live).  The hot path is one native call per site
(native.popgen_site_stats); the pure-Python fallbacks below replicate
the identical op order.
"""

from __future__ import annotations

import math


def _as_rows(gl_vector) -> list:
    return [(float(t[0]), float(t[1]), float(t[2])) for t in gl_vector]


def site_stats(gl_vector, epsilon: float = 1e-20, maxiter: int = 1000):
    """All five popgen.h statistics for one site in one pass.
    Returns (hwe_af (2-tuple), mle_gt_freq (3-tuple), fic, rsq,
    hwe_pvalue)."""
    from delly_tpu_torch import native
    out = native.popgen_site_stats(
        [x for t in gl_vector for x in t], epsilon, maxiter)
    if out is not None:
        return ((float(out[0]), float(out[1])),
                (float(out[2]), float(out[3]), float(out[4])),
                float(out[5]), float(out[6]), float(out[7]))
    af = est_biallelic_af(gl_vector, epsilon, maxiter)
    gtf = est_biallelic_gt_freq(gl_vector, epsilon, maxiter)
    return (af, gtf, est_biallelic_fic(gl_vector, af),
            est_biallelic_rsq(gl_vector, af),
            est_biallelic_hwe_lrt(gl_vector, af, gtf))


def est_biallelic_af(gl_vector, epsilon: float = 1e-20,
                     maxiter: int = 1000):
    """EM allele frequency under HWE (popgen.h:12-51).
    Returns (af_ref, af_alt)."""
    g = _as_rows(gl_vector)
    if not g:
        return 0.5, 0.5
    ap0, ap1 = 0.5, 0.5
    af0, af1 = 0.0, 0.0
    err = 1.0
    count = 0
    while err > epsilon and count < maxiter:
        p0, p1, p2 = ap0 * ap0, 2 * ap0 * ap1, ap1 * ap1
        af0 = 0.0
        af1 = 0.0
        used = 0.0
        for r in g:
            t0, t1, t2 = p0 * r[0], p1 * r[1], p2 * r[2]
            p = t0 + t1 + t2
            if p <= 0:
                continue
            t0 /= p
            t1 /= p
            t2 /= p
            af0 += t0 + 0.5 * t1
            af1 += t2 + 0.5 * t1
            used += 1
        if used > 0:
            af0 /= used
            af1 /= used
        err = (ap0 - af0) * (ap0 - af0) + (ap1 - af1) * (ap1 - af1)
        ap0, ap1 = af0, af1
        count += 1
    return af0, af1


def est_biallelic_gt_freq(gl_vector, epsilon: float = 1e-20,
                          maxiter: int = 1000):
    """EM genotype frequencies (popgen.h:54-91)."""
    g = _as_rows(gl_vector)
    if not g:
        return (0.0, 0.0, 0.0)
    q0 = q1 = q2 = 1.0 / 3.0
    m0 = m1 = m2 = 0.0
    err = 1.0
    count = 0
    while err > epsilon and count < maxiter:
        m0 = m1 = m2 = 0.0
        used = 0.0
        for r in g:
            t0, t1, t2 = q0 * r[0], q1 * r[1], q2 * r[2]
            p = t0 + t1 + t2
            if p <= 0:
                continue
            m0 += t0 / p
            m1 += t1 / p
            m2 += t2 / p
            used += 1
        if used > 0:
            m0 /= used
            m1 /= used
            m2 /= used
        err = ((q0 - m0) * (q0 - m0) + (q1 - m1) * (q1 - m1)
               + (q2 - m2) * (q2 - m2))
        q0, q1, q2 = m0, m1, m2
        count += 1
    return (m0, m1, m2)


def _hwe_gt(hwe_af):
    return (hwe_af[0] * hwe_af[0], 2 * hwe_af[0] * hwe_af[1],
            hwe_af[1] * hwe_af[1])


def est_biallelic_fic(gl_vector, hwe_af) -> float:
    """Inbreeding coefficient (popgen.h:94-111)."""
    g = _as_rows(gl_vector)
    if not g:
        return 0.0
    h0, h1, h2 = _hwe_gt(hwe_af)
    sum_gl_het = 0.0
    denominator = 0.0
    for r in g:
        p = r[0] * h0 + r[1] * h1 + r[2] * h2
        if p <= 0:
            continue
        sum_gl_het += (r[1] * h1) / p
        denominator += h1
    if denominator > 0:
        return 1.0 - sum_gl_het / denominator
    return 0.0


def est_biallelic_rsq(gl_vector, hwe_af) -> float:
    """Imputation R² (popgen.h:114-147)."""
    g = _as_rows(gl_vector)
    if not g:
        return 0.0
    h0, h1, h2 = _hwe_gt(hwe_af)
    sum_d = 0.0
    sum_d2 = 0.0
    used = 0.0
    for r in g:
        t0, t1, t2 = r[0] * h0, r[1] * h1, r[2] * h2
        p = t0 + t1 + t2
        if p <= 0:
            continue
        t0 /= p
        t1 /= p
        t2 /= p
        sum_d += t1 + 2 * t0
        sum_d2 += (t1 + 2 * t0) * (t1 + 2 * t0)
        used += 1
    if used > 1 and h1 > 0:
        mean_d = sum_d / used
        var = sum_d2 - used * mean_d * mean_d
        if var < 0:
            var = 0.0
        var /= (used - 1)
        return var / h1
    return 0.0


def dosage_r2(a, b, min_shared: int) -> float:
    """Squared Pearson correlation over shared-called dosages
    (popgen.h:149-177)."""
    from delly_tpu_torch import native
    r = native.dosage_r2_seq(a, b, min_shared)
    if r is not None:
        return r
    n = sa = sb = saa = sbb = sab = 0.0
    for x, y in zip(a, b):
        if x < 0 or y < 0:
            continue
        x = float(x)
        y = float(y)
        n += 1
        sa += x
        sb += y
        saa += x * x
        sbb += y * y
        sab += x * y
    if n < min_shared:
        return -1.0
    cov = sab - sa * sb / n
    va = saa - sa * sa / n
    vb = sbb - sb * sb / n
    if va <= 0 or vb <= 0:
        return -1.0
    r = cov / math.sqrt(va * vb)
    return r * r


def chi2_sf_1df(x: float) -> float:
    """Survival function of χ²(1): erfc(sqrt(x/2))."""
    return math.erfc(math.sqrt(max(x, 0.0) / 2.0))


def est_biallelic_hwe_lrt(gl_vector, hwe_af, mle_gt_freq) -> float:
    """HWE LRT χ²(1) p-value (popgen.h:180-201)."""
    g = _as_rows(gl_vector)
    if not g:
        return 1.0
    h0, h1, h2 = _hwe_gt(hwe_af)
    m0, m1, m2 = (float(mle_gt_freq[0]), float(mle_gt_freq[1]),
                  float(mle_gt_freq[2]))
    null = 0.0
    alt = 0.0
    for r in g:
        pnull = r[0] * h0 + r[1] * h1 + r[2] * h2
        palt = r[0] * m0 + r[1] * m1 + r[2] * m2
        if pnull <= 0 or palt <= 0:
            continue
        null += math.log(pnull)
        alt += math.log(palt)
    lrts = -2 * (null - alt)
    if lrts < 0:
        lrts = 0.0
    return chi2_sf_1df(lrts)
