"""The port's copy of ops/dna.py against the JAX package's on seeded
sequences: the same uint8 codes, padding and lengths."""

import numpy as np
import pytest

import delly_tpu.ops.dna as jdna
import delly_tpu_torch.ops.dna as tdna


def _seqs(seed, n, hi):
    rng = np.random.default_rng(seed)
    letters = "ACGTNacgtn"
    return ["".join(letters[i] for i in rng.integers(0, len(letters), k))
            for k in rng.integers(0, hi, n)]


def test_encode_matches_jax():
    for s in _seqs(1, 50, 300) + ["", "N"]:
        got, want = tdna.encode(s), jdna.encode(s)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert tdna.PAD == jdna.PAD


@pytest.mark.parametrize("maxlen", [None, 0, 64, 150, 500])
def test_encode_batch_matches_jax(maxlen):
    for seqs in (_seqs(2, 40, 300), [], ["", ""], ["ACGT"]):
        (ga, gl), (wa, wl) = (tdna.encode_batch(seqs, maxlen),
                              jdna.encode_batch(seqs, maxlen))
        assert ga.dtype == wa.dtype and gl.dtype == wl.dtype
        assert ga.shape == wa.shape
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gl, wl)
