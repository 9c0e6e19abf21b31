"""K3 and K3-tb (corridor Gotoh) of the PyTorch port against the JAX
package.

The port's gotoh_banded_batch, on CPU tensors (the plain forward DP and
the plain traceback walk), must give the scores and merged rows of the
host oracle delly_tpu.ops.gotoh_banded.gotoh_banded_host and of
delly_tpu.ops.gotoh_banded.gotoh_banded_batch in interpret mode, over
the corpus of tests/test_gotoh_banded.py: the four end-gap
configurations, swapped jobs (n > m), mutation rates of 0, 5 and 20%,
and bands that cover the whole matrix (then the result is the full
Gotoh's). The plain walk also follows the JAX package's host walk
_walk_bits step for step, and the gates send the jobs the kernels do
not serve to a host DP. Tolerance: exact equality (integer scores, byte
rows, trace codes).
"""

import numpy as np
import pytest
import torch

from delly_tpu.ops.gotoh import DnaScore, gotoh
from delly_tpu.ops.gotoh_banded import (
    _walk_bits, corridor_offsets, gotoh_banded_batch as jax_banded_batch,
    gotoh_banded_host,
)
from delly_tpu_torch.ops import gotoh_banded_cuda as gb
from delly_tpu_torch.ops.gotoh import DnaScore as TDnaScore
from delly_tpu_torch.parallel import dispatch
from torch_card import torch_cpu  # noqa: F401

ACS = [(False, False), (True, False), (False, True), (True, True)]
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutate(rng, s, rate):
    out = []
    for c in s.tolist():
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(int(rng.choice(ALPHA)))
        elif r < rate:
            out.append(c)
            out.append(int(rng.choice(ALPHA)))
        else:
            out.append(c)
    return np.array(out, dtype=np.uint8)


def _jobs(seed, lo, hi, rates=(0.0, 0.05, 0.2)):
    """Pairs of a random sequence and a mutated copy; every other pair
    is given shorter-first, so the batch transposes it."""
    rng = np.random.default_rng(seed)
    jobs = []
    for rep, rate in enumerate(rates):
        s1 = rng.choice(ALPHA, int(rng.integers(lo, hi)))
        s2 = _mutate(rng, s1, rate)
        if len(s2) == 0:
            s2 = s1[:7].copy()
        jobs.append((s2[None], s1[None]) if rep % 2 else (s1[None], s2[None]))
    return jobs


def _host(a1, a2, ac, band):
    """gotoh_banded_host with the batch's transpose rule."""
    if a2.shape[1] > a1.shape[1]:
        best, merged = gotoh_banded_host(a2, a1, ac=(ac[1], ac[0]),
                                         band=band)
        return best, np.concatenate([merged[1:], merged[:1]], axis=0)
    return gotoh_banded_host(a1, a2, ac=ac, band=band)


def _assert_batch(jobs, ac, band):
    dispatch.reset()
    got = gb.gotoh_banded_batch(jobs, ac=ac, band=band)
    assert dispatch.snapshot()["host_routes"] == 0
    for (a1, a2), (gs, gm) in zip(jobs, got):
        ws, wm = _host(a1, a2, ac, band)
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("ac", ACS)
@pytest.mark.parametrize("band", [512, 1024])
def test_batch_matches_host_oracle(torch_cpu, ac, band):
    _assert_batch(_jobs(sum(ac) * 7 + band, 300, 1400), ac, band)


@pytest.mark.parametrize("ac", ACS)
def test_band_covering_matrix_equals_full(torch_cpu, ac):
    rng = np.random.default_rng(sum(ac) + 3)
    jobs = []
    for _ in range(3):
        m = int(rng.integers(150, 240))
        s1 = rng.choice(ALPHA, m)
        s2 = _mutate(rng, s1, 0.15)[:m]
        jobs.append((s1[None], s2[None]))
    band = 512                 # >= 2 * (n + 2) for every job
    got = gb.gotoh_banded_batch(jobs, ac=ac, band=band)
    for (a1, a2), (gs, gm) in zip(jobs, got):
        ws, wm = gotoh(a1, a2, ac=ac)
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)


def test_narrow_band_on_similar_long_pairs(torch_cpu):
    _assert_batch(_jobs(17, 2000, 3000, rates=(0.05, 0.05, 0.01)),
                  (True, True), 512)


def test_short_second_sequence(torch_cpu):
    """n = 1 and n far below m: the corridor sits on column 0."""
    rng = np.random.default_rng(29)
    s1 = rng.choice(ALPHA, 700)
    jobs = [(s1[None], s1[None, 300:301]), (s1[None, 10:11], s1[None]),
            (s1[None], s1[None, 5:60])]
    for ac in ACS:
        _assert_batch(jobs, ac, 512)


def test_matches_pallas_interpret(torch_cpu):
    """The interpret-mode Pallas kernel and its XLA walk, at the MSA's
    configuration (its compile dominates; the JAX package's own tests
    hold it to the host oracle in the other configurations)."""
    jobs = _jobs(41, 220, 460)
    want = jax_banded_batch(jobs, ac=(True, True), interpret=True)
    got = gb.gotoh_banded_batch(jobs, ac=(True, True))
    for (ws, wm), (gs, gm) in zip(want, got):
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("ac", ACS)
def test_plain_walk_follows_host_walk(torch_cpu, ac):
    """The plain walk over the plain forward's tile takes the steps of
    _walk_bits (gotoh_banded.py:138-174) over the same tile, and the
    plain best is the oracle's score."""
    jobs = [(a1, a2) for a1, a2 in _jobs(sum(ac) + 61, 300, 900)
            if a2.shape[1] <= a1.shape[1]]
    M, B = 1024, 512
    s1, s2, ml, nl = (torch.from_numpy(x) for x in gb.pack_jobs(jobs, M))
    best, bits = gb.banded_forward_plain(s1, s2, ml, nl, B, ac[0], ac[1],
                                         5, -4, -10, -1)
    codes, lens = gb.banded_traceback_plain(bits, ml, nl)
    for g, (a1, a2) in enumerate(jobs):
        m, n = a1.shape[1], a2.shape[1]
        tile = np.zeros((m + 1, B), dtype=np.uint8)
        tile[1:] = bits[g, :m].numpy()
        want = _walk_bits(tile, corridor_offsets(m, n, B), m, n)
        got = codes[g, :int(lens[g])].numpy()[::-1]
        np.testing.assert_array_equal(got, want)
        assert int(best[g]) == gotoh_banded_host(a1, a2, ac=ac, band=B)[0]


def test_corridor_table_matches_offsets():
    ml = torch.tensor([5000, 300, 9001], dtype=torch.int32)
    nl = torch.tensor([4200, 1, 8999], dtype=torch.int32)
    for B in gb.BANDS:
        table = gb.corridor_table(ml, nl, 16384, B)
        for g in range(3):
            m, n = int(ml[g]), int(nl[g])
            np.testing.assert_array_equal(table[g, :m + 1].numpy(),
                                          corridor_offsets(m, n, B))


@pytest.mark.parametrize("B", gb.BANDS)
def test_stepped_offsets_match_table(B):
    """The quotient/remainder stepping of K3 (ascending) and K3-tb
    (descending) gives corridor_table's off(r): every n <= m for all
    m <= 512, and seeded random (m, n) up to 32,768."""
    for lo in range(1, 513, 32):
        mn = [(m, n) for m in range(lo, lo + 32) for n in range(1, m + 1)]
        ml, nl = (np.array(x) for x in zip(*mn))
        M = int(ml.max())
        want = gb.corridor_table(torch.from_numpy(ml), torch.from_numpy(nl),
                                 M, B).numpy()
        np.testing.assert_array_equal(gb.corridor_table_stepped(ml, nl, M, B),
                                      want)
        down = gb.corridor_table_stepped(ml, nl, M, B, descending=True)
        rows = np.arange(M + 1)[None, :] <= ml[:, None]
        np.testing.assert_array_equal(np.where(rows, down, 0),
                                      np.where(rows, want, 0))
    rng = np.random.default_rng(B)
    ml = rng.integers(1, 32769, size=48)
    nl = np.array([int(rng.integers(1, m + 1)) for m in ml])
    ml[:2], nl[:2] = 32768, (32768, 1)
    want = gb.corridor_table(torch.from_numpy(ml), torch.from_numpy(nl),
                             32768, B).numpy()
    np.testing.assert_array_equal(gb.corridor_table_stepped(ml, nl, 32768, B),
                                  want)
    down = gb.corridor_table_stepped(ml, nl, 32768, B, descending=True)
    rows = np.arange(32769)[None, :] <= ml[:, None]
    np.testing.assert_array_equal(np.where(rows, down, 0),
                                  np.where(rows, want, 0))


def test_batch_mixes_bands(torch_cpu):
    """One call with a band per job: jobs of three bands, swapped ones
    among them, each equal to the host corridor at its own band."""
    jobs = _jobs(93, 300, 900) + _jobs(95, 300, 900)
    bands = [512, 1024, 2048, 1024, 512, 2048]
    dispatch.reset()
    got = gb.gotoh_banded_batch(jobs, ac=(True, True), band=bands)
    assert dispatch.snapshot()["host_routes"] == 0
    assert any(a2.shape[1] > a1.shape[1] for a1, a2 in jobs)
    for (a1, a2), band, (gs, gm) in zip(jobs, bands, got):
        ws, wm = _host(a1, a2, (True, True), band)
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)


def test_gates_take_host_routes(torch_cpu):
    """Multi-row and empty jobs take the full Gotoh; jobs above max_m
    and exotic letters the host corridor; each counts as a host route,
    in order with the kernel jobs of the same call."""
    rng = np.random.default_rng(5)
    s1 = rng.choice(ALPHA, 400)
    s2 = _mutate(rng, s1, 0.05)
    two_rows = gotoh(s1[None], s2[None], ac=(True, True))[1]
    exotic = s2.copy()
    exotic[7] = ord("X")
    jobs = [(s1[None], s2[None]), (two_rows, s2[None]),
            (s1[None], np.zeros((1, 0), np.uint8)),
            (s1[None], exotic[None]),
            (np.concatenate([s1, s1])[None], s2[None])]
    dispatch.reset()
    got = gb.gotoh_banded_batch(jobs, ac=(True, True), band=512, max_m=700)
    assert dispatch.snapshot()["host_routes"] == 4
    want = [_host(*jobs[0], (True, True), 512),
            gotoh(two_rows, s2[None], ac=(True, True)),
            gotoh(s1[None], np.zeros((1, 0), np.uint8), ac=(True, True)),
            _host(*jobs[3], (True, True), 512),
            _host(*jobs[4], (True, True), 512)]
    for (gs, gm), (ws, wm) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)


def test_scoring_is_a_parameter(torch_cpu):
    jobs = _jobs(73, 300, 700)
    sc = DnaScore(2, -3, -6, -2)
    got = gb.gotoh_banded_batch(jobs, ac=(False, True), band=512,
                                sc=TDnaScore(2, -3, -6, -2))
    for (a1, a2), (gs, gm) in zip(jobs, got):
        if a2.shape[1] > a1.shape[1]:
            ws, wm = gotoh_banded_host(a2, a1, ac=(True, False), sc=sc)
            wm = np.concatenate([wm[1:], wm[:1]], axis=0)
        else:
            ws, wm = gotoh_banded_host(a1, a2, ac=(False, True), sc=sc)
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)


def test_batch_split_by_tile_budget(torch_cpu, monkeypatch):
    """A bucket whose direction tiles exceed TILE_BYTES runs as several
    launches, with the same results."""
    monkeypatch.setattr(gb, "TILE_BYTES", 1)
    _assert_batch(_jobs(83, 300, 600), (True, True), 512)


def test_wrapper_checks():
    s = torch.zeros((1, 512), dtype=torch.uint8)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        gb.banded_forward(s, s, n, n + 1, 512, True, True, 5, -4, -10, -1)
    with pytest.raises(ValueError):
        gb.banded_forward(s, s, n + 600, n, 512, True, True, 5, -4, -10, -1)
    with pytest.raises(ValueError):
        gb.banded_traceback(torch.zeros((1, 512, 512), dtype=torch.uint8),
                            n - 1, n - 1)
    with pytest.raises(ValueError):
        gb.banded_forward(s, s, n, n, 256, True, True, 5, -4, -10, -1)
    with pytest.raises(ValueError):
        gb.banded_forward(s[:, :300], s[:, :300], n, n, 512, True, True, 5,
                          -4, -10, -1)
    with pytest.raises(TypeError):
        gb.banded_forward(s.int(), s, n, n, 512, True, True, 5, -4, -10, -1)
    with pytest.raises(ValueError):
        gb.banded_traceback(torch.zeros((1, 512, 300), dtype=torch.uint8),
                            n, n)


def test_host_lengths_checked_in_place():
    """With `host_lengths` (the numpy lengths the caller uploaded, as
    gotoh_banded_batch passes them) the wrappers check those and read
    nothing back from the tensors: bad host lengths raise beside good
    tensors, and host lengths of another shape raise."""
    s = torch.zeros((1, 512), dtype=torch.uint8)
    n = torch.ones(1, dtype=torch.int32)
    bits = torch.zeros((1, 512, 512), dtype=torch.uint8)
    one = np.ones(1, dtype=np.int32)
    with pytest.raises(ValueError):
        gb.banded_forward(s, s, n, n, 512, True, True, 5, -4, -10, -1,
                          host_lengths=(one, one + 1))
    with pytest.raises(ValueError):
        gb.banded_traceback(bits, n, n, host_lengths=(one - 1, one - 1))
    with pytest.raises(ValueError):
        gb.banded_traceback(bits, n, n, host_lengths=(np.ones(2, np.int32),
                                                      np.ones(2, np.int32)))
    want = gb.banded_forward(s, s, n, n, 512, True, True, 5, -4, -10, -1)
    got = gb.banded_forward(s, s, n, n, 512, True, True, 5, -4, -10, -1,
                            host_lengths=(one, one))
    assert all(torch.equal(a, b) for a, b in zip(want, got))
