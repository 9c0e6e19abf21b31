"""K2 and K2-tb (lockstep profile Gotoh) of the PyTorch port against the
JAX package.

The port's gotoh_batch, on CPU tensors (the plain forward DP and the
plain traceback walk), must give the scores and merged rows of
delly_tpu.ops.gotoh_pallas.gotoh_batch in interpret mode and of the host
oracle ops.gotoh.gotoh (which the JAX package's tests hold the Pallas
kernel to), over the corpus of tests/test_gotoh_pallas.py:
the four end-gap configurations, multi-row profile merges, mixed K
buckets and the host fallbacks. Tolerance: exact equality (integer
scores, byte rows).
"""

import random

import numpy as np
import pytest
import torch

from delly_tpu.ops.gotoh import DnaScore, gotoh
from delly_tpu.ops.gotoh_pallas import gotoh_batch as jax_gotoh_batch
from delly_tpu_torch.ops import gotoh_cuda, gotoh_wide_cuda
from delly_tpu_torch.ops.gotoh import DnaScore as TDnaScore
from delly_tpu_torch.parallel import dispatch
from test_torch_cuda import deep_jobs
from torch_card import torch_cpu  # noqa: F401

ACS = [(False, False), (True, False), (False, True), (True, True)]


def _rand_seq(rng, lo, hi, alpha="ACGT"):
    return "".join(rng.choice(alpha) for _ in range(rng.randint(lo, hi)))


def _mutate(rng, s):
    out = []
    for ch in s:
        r = rng.random()
        if r < 0.05:
            continue
        out.append(rng.choice("ACGT") if r < 0.10 else ch)
        if rng.random() < 0.03:
            out.append(rng.choice("ACGT"))
    return "".join(out)


def _profiles(rng):
    base = _rand_seq(rng, 150, 250)
    reads = [_mutate(rng, base) for _ in range(6)]
    m1 = gotoh(reads[0], reads[1], ac=(True, True))[1]
    m2 = gotoh(reads[2], reads[3], ac=(True, True))[1]
    m3 = gotoh(m1, m2, ac=(True, True))[1]
    return [(m1, m2), (m3, reads[4]), (m3, m1), (reads[4], reads[5])]


def _assert_jobs_match(jobs, ac, sc=None, pallas=False):
    got = gotoh_cuda.gotoh_batch(
        jobs, ac=ac, sc=None if sc is None else TDnaScore(
            sc.match, sc.mismatch, sc.go, sc.ge))
    want = (jax_gotoh_batch(jobs, ac=ac, sc=sc, interpret=True) if pallas
            else [gotoh(a1, a2, ac=ac, sc=sc) for a1, a2 in jobs])
    assert len(got) == len(jobs)
    for (a1, a2), (ds, dm), (ws, wm) in zip(jobs, got, want):
        hs, hm = gotoh(a1, a2, ac=ac, sc=sc)
        assert ds == ws == hs
        np.testing.assert_array_equal(dm, wm)
        np.testing.assert_array_equal(dm, hm)


@pytest.mark.parametrize("ac", ACS)
def test_pairwise_all_configs(torch_cpu, ac):
    rng = random.Random(hash(ac) & 0xFFFF)
    jobs = [(_rand_seq(rng, 1, 120), _rand_seq(rng, 1, 140))
            for _ in range(10)]
    _assert_jobs_match(jobs, ac)


def test_matches_pallas_interpret(torch_cpu):
    """The interpret-mode Pallas kernel, at the MSA's configuration
    (its compile dominates, so one configuration here; the JAX
    package's own tests hold it to the host oracle on the rest)."""
    rng = random.Random(23)
    jobs = [(_rand_seq(rng, 1, 120), _rand_seq(rng, 1, 120))
            for _ in range(9)]
    _assert_jobs_match(jobs, (True, True), pallas=True)


@pytest.mark.parametrize("ac", ACS)
def test_profile_merges_all_configs(torch_cpu, ac):
    _assert_jobs_match(_profiles(random.Random(7)), ac)


def test_small_fuzz(torch_cpu):
    rng = random.Random(11)
    for _ in range(30):
        ac = (rng.random() < 0.5, rng.random() < 0.5)
        jobs = [(_rand_seq(rng, 1, 12, "ACGTN"),
                 _rand_seq(rng, 1, 12, "ACGTN"))]
        _assert_jobs_match(jobs, ac)


def test_mixed_buckets_and_scoring(torch_cpu):
    rng = random.Random(5)
    jobs = [(_rand_seq(rng, 50, 100), _rand_seq(rng, 50, 100)),
            (_rand_seq(rng, 300, 400), _rand_seq(rng, 300, 400)),
            (_rand_seq(rng, 520, 600), _rand_seq(rng, 130, 200))]
    _assert_jobs_match(jobs, (True, True))
    _assert_jobs_match(jobs[:1], (False, False), sc=DnaScore(2, -3, -6, -2))


def test_fallback_paths(torch_cpu):
    """Exotic alphabet and oversized jobs take the host DP inside the
    same call, in order, and count as host routes. Oversized is wider
    than the widest kernel, K4 (MAX_WIDE columns): merges of up to that
    width run on K2 or K4."""
    rng = random.Random(17)
    jobs = [(_rand_seq(rng, 10, 30), _rand_seq(rng, 10, 30)),
            ("ACXGT", "ACGT"),
            ("A" * (gotoh_wide_cuda.MAX_WIDE + 1), "AC")]
    dispatch.reset()
    got = gotoh_cuda.gotoh_batch(jobs, ac=(True, True))
    assert dispatch.snapshot()["host_routes"] == 2
    for (a1, a2), (ds, dm) in zip(jobs, got):
        hs, hm = gotoh(a1, a2, ac=(True, True))
        assert ds == hs
        np.testing.assert_array_equal(dm, hm)


def test_wrapper_checks():
    prof = torch.zeros((1, 100, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        gotoh_cuda.gotoh_forward(prof, prof, prof, prof, prof, True, True,
                                 -10, -1)
    packed = gotoh_cuda.pack_bucket([(np.frombuffer(b"ACGT", np.uint8)[None],
                                      np.frombuffer(b"AGT", np.uint8)[None])],
                                    128, TDnaScore())
    args = [torch.from_numpy(x) for x in packed]
    with pytest.raises(TypeError):
        gotoh_cuda.gotoh_forward(args[0].long(), *args[1:], True, True,
                                 -10, -1)


# The CUDA kernel's profile score (csrc/gotoh.cu profile_score) divides
# without the integer divide: an f32 estimate of trunc(|num| / den) that
# is exact or one below, then one remainder step. Below, a numpy twin of
# that integer step against trunc(num / den).
DEN_MAX = ((1 << 24) - 1) // 125   # d1 * d2 under _eligible's gate


def _score_twin(num, den, est):
    """profile_score's correction, est = trunc(|num| / den) or one below."""
    a = np.abs(num)
    q = est + (a - est * den >= den)
    return np.where(num < 0, -q, q)


def _exact(num, den):
    return np.sign(num) * (np.abs(num) // den)


def _estimates(num, den):
    """The exact quotient and one below it, and the truncations of the
    extreme f32 estimates the kernel can form: the reciprocal within one
    ulp (2^-23) either way, the product rounded toward zero (up to 2^-23
    smaller), |num| and den exact in f32 (below 2^24)."""
    a = np.abs(num)
    assert a.max() < 1 << 24 and den.max() < 1 << 24
    q = a // den
    hi = np.trunc(a / den * (1 + 2.0 ** -23)).astype(np.int64)
    lo = np.trunc(a / den * (1 - 2.0 ** -23) ** 2).astype(np.int64)
    assert (hi <= q).all() and (lo >= q - 1).all()
    return [q - 1, q, lo, hi]


@pytest.mark.parametrize("part", range(4))
def test_profile_score_division_exact(part):
    """Every den the gate admits for the default scores (d1 * d2 up to
    DEN_MAX = 134,217, about 2^17), in four parts; nums at the extremes
    |num| <= 5 * den (|match|, |mismatch| <= 5 and the A,C,G,T,N counts
    sum to at most the depth), around every multiple of den, and
    random."""
    den = np.arange(1 + part, DEN_MAX + 1, 4, dtype=np.int64)
    rng = np.random.default_rng(part)
    cols = [np.zeros_like(den)]
    for k in range(6):
        for d in (-1, 0, 1):
            cols += [k * den + d, -(k * den + d)]
    cols += [rng.integers(-5 * den, 5 * den + 1) for _ in range(4)]
    num = np.clip(np.stack(cols, 1), -5 * den[:, None], 5 * den[:, None])
    dd = np.broadcast_to(den[:, None], num.shape)
    want = _exact(num, dd)
    for est in _estimates(num, dd):
        np.testing.assert_array_equal(_score_twin(num, dd, est), want)


def test_profile_score_division_packed_deep():
    """The num and den of every cell of packed deep merges (300 x 400
    and 400 x 300 rows): the twin equals the plain version's division."""
    sc = TDnaScore()
    for rows1, rows2 in ((300, 400), (400, 300)):
        jobs = deep_jobs(rows1, 6, rows1, rows2, 60, 120)
        assert all(gotoh_cuda._eligible(a1, a2) for a1, a2 in jobs)
        prof, wc2, d2, _ml, _nl = gotoh_cuda.pack_bucket(jobs, 128, sc)
        prof, wc2, d2 = (x.astype(np.int64) for x in (prof, wc2, d2))
        num = np.einsum("gra,gac->grc", prof[:, :, :5], wc2)
        den = np.maximum(prof[:, :, 5:6] * d2[:, None, :], 1)
        assert den.max() > 100_000 and num.min() < 0 < num.max()
        q = torch.div(torch.from_numpy(np.abs(num)), torch.from_numpy(den),
                      rounding_mode="floor").numpy()
        want = np.where(num < 0, -q, q)
        for est in _estimates(num, den):
            np.testing.assert_array_equal(_score_twin(num, den, est), want)


@pytest.mark.parametrize("K", [128, 256, 512, 1024, 2048, 4096])
def test_tb_geometry(K):
    """K2-tb's shared-memory windows as the launch takes them: rows per
    window a power of two, so window w holds rows w * rows ... and every
    row of the tile falls in exactly one; windows of whole rows in
    16-byte multiples (cp.async.bulk sizes); the shared memory (windows
    and the walk's 2K codes) fits; at K = 128 the tile is one window of
    at most 16 KB, above it two windows of TB_WINDOW_BYTES."""
    rows, stages, smem = gotoh_cuda.tb_geometry(K)
    assert smem == stages * rows * K + 2 * K <= gotoh_cuda.SMEM_MAX
    assert rows * K % 16 == 0 and rows & (rows - 1) == 0 and K % rows == 0
    assert 1 <= stages <= K // rows
    if K == 128:
        assert (rows, stages) == (K, 1) and rows * K <= 16_384
    else:
        assert stages == 2 and rows * K == gotoh_cuda.TB_WINDOW_BYTES
