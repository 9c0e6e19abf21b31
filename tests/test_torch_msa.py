"""Split-read MSA of the PyTorch port against the JAX package.

lcs_pairs (torch row loop with cummax, on CPU tensors here) and the
lockstep msa_batch / msa (merges through the Gotoh kernel wrappers'
plain versions) must equal delly_tpu.ops.msa. Tolerance: exact
equality (integer LCS lengths, consensus strings).
"""

import random

import numpy as np
import pytest

import delly_tpu.ops.msa as jmsa
import delly_tpu_torch.ops.msa as tmsa
from delly_tpu_torch.parallel import dispatch
from torch_card import torch_cpu  # noqa: F401


def _rand_seq(rng, lo, hi):
    return "".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi)))


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


def _items(seed, n_items):
    rng = random.Random(seed)
    items = []
    for _ in range(n_items):
        base = _rand_seq(rng, 80, 200)
        items.append([_mutate(rng, base) for _ in range(rng.randint(2, 7))])
    return items


def test_lcs_pairs(torch_cpu):
    rng = random.Random(1)
    pairs = [(_rand_seq(rng, 0, 150), _rand_seq(rng, 1, 170))
             for _ in range(40)]
    pairs.append(("", "ACGT"))
    np.testing.assert_array_equal(tmsa.lcs_pairs(pairs),
                                  jmsa.lcs_pairs(pairs))
    assert len(tmsa.lcs_pairs([])) == 0


def test_msa_batch(torch_cpu):
    items = [(s, jmsa.distance_matrix(s)) for s in _items(5, 6)]
    want = jmsa.msa_batch([(s, d.copy()) for s, d in items], 2)
    dispatch.reset()
    got = tmsa.msa_batch([(s, d.copy()) for s, d in items], 2)
    assert got == want
    assert dispatch.snapshot()["host_routes"] == 0
    np.testing.assert_array_equal(tmsa.distance_matrix(items[0][0]),
                                  items[0][1])


def test_msa_single(torch_cpu):
    for seqs in _items(9, 3):
        assert tmsa.msa(seqs, 2) == jmsa.msa(seqs, 2)


def _long_round(seed, distant):
    """A merge round of two long sequence pairs and a short one; with
    `distant`, the second long pair carries a 2,100-base insertion, so
    its corridor would be wider than 4,096."""
    rng = random.Random(seed)
    as_row = lambda s: np.frombuffer(s.encode(), np.uint8)[None].copy()  # noqa: E731
    pairs = []
    for k in range(2):
        base = _rand_seq(rng, 900, 1000)
        other = _mutate(rng, base)
        if distant and k == 1:
            other = other[:100] + _rand_seq(rng, 2100, 2100) + other[100:]
        pairs.append((as_row(base), as_row(other)))
    pairs.append((as_row("ACGTACGT"), as_row("ACGAACGT")))
    return pairs


@pytest.mark.parametrize("distant, routes", [(False, 0), (True, 1)])
def test_long_pairs_take_host_corridor(torch_cpu, monkeypatch, distant,
                                       routes):
    """Sequence pairs above the corridor threshold (lowered to test size)
    take the corridor kernels' path with no host route, and merge as
    the JAX package's host corridor branch does. A distant pair, whose
    corridor would be wider than 4,096, takes the exact full DP on the
    host instead: one host route, the same result."""
    monkeypatch.setattr(tmsa, "_BANDED_MIN_DIM", 300)
    monkeypatch.setattr(jmsa, "_BANDED_MIN_DIM", 300)
    pairs = _long_round(4, distant)
    assert (tmsa._corridor_band(*pairs[1]) is None) == distant
    dispatch.reset()
    got = tmsa._gotoh_dispatch_batch(pairs, (True, True), tmsa.DnaScore())
    assert dispatch.snapshot()["host_routes"] == routes
    want = [jmsa._gotoh_dispatch(x, y, (True, True), jmsa.DnaScore())
            for x, y in pairs]
    for (gs, gm), (ws, wm) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)


def test_long_round_mixes_bands(torch_cpu, monkeypatch):
    """One merge round whose long pairs need three corridor widths, one
    given shorter-first (swapped) and one too distant for any corridor:
    the port's single batched call equals the JAX package's per-pair
    _banded_or_full pair for pair, with one host route (the distant
    pair)."""
    monkeypatch.setattr(tmsa, "_BANDED_MIN_DIM", 300)
    rng = random.Random(12)
    as_row = lambda s: np.frombuffer(s.encode(), np.uint8)[None].copy()  # noqa: E731
    pairs = []
    for lo, rounds in ((900, 0), (1800, 1), (2600, 2), (1900, 1)):
        base = _rand_seq(rng, lo, lo + 50)
        other = base
        for _ in range(rounds + 1):
            other = _mutate(rng, other)
        pairs.append((as_row(base), as_row(other)))
    pairs[3] = pairs[3][::-1]                        # shorter first
    base = _rand_seq(rng, 900, 950)
    pairs.append((as_row(base), as_row(base[:100] + _rand_seq(rng, 2100, 2100)
                                        + base[100:])))
    bands = [tmsa._corridor_band(*p) for p in pairs]
    assert bands[-1] is None and len(set(bands[:-1])) == 3
    assert pairs[3][1].shape[1] > pairs[3][0].shape[1]
    dispatch.reset()
    got = tmsa._banded_or_full(pairs, (True, True), tmsa.DnaScore())
    assert dispatch.snapshot()["host_routes"] == 1
    for (x, y), (gs, gm) in zip(pairs, got):
        ws, wm = jmsa._banded_or_full(x, y, (True, True), jmsa.DnaScore())
        assert gs == ws
        np.testing.assert_array_equal(gm, wm)
