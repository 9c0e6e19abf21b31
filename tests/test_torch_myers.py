"""K1 (Myers edit distance) of the PyTorch port against the JAX package.

The port's plain version (ops/myers.py, reached on CPU tensors) and its
batch entry points must give exactly the distances of
delly_tpu.ops.myers.batched_edit_distance_myers, of the host oracle
edist.edit_distance, and, at small shapes, of the Pallas kernel in
interpret mode. Tolerance: exact equality (integer distances).
"""

import numpy as np
import pytest
import torch

from delly_tpu.ops import edist as jedist
from delly_tpu.ops.myers import batched_edit_distance_myers as jax_myers
from delly_tpu.ops.myers_pallas import batched_edit_distance_pallas
from delly_tpu_torch.ops import edist, myers_cuda
from delly_tpu_torch.ops.myers import (alphabet_lut, alphabet_size,
                                       myers_plain)
from delly_tpu_torch.parallel import dispatch
from torch_card import torch_cpu  # noqa: F401

ALPHABET = np.frombuffer(b"ACGTNRYKMSWBDHVX", dtype=np.uint8)
EXTRA = np.frombuffer(b"Z", dtype=np.uint8)


def _case(seed, b, m, n, nalpha, empty=False):
    """Random pairs over exactly `nalpha` letters (padding bytes are
    letters too, so the alphabet is what the test asks for), with
    ragged lengths."""
    rng = np.random.default_rng(seed)
    letters = np.concatenate([ALPHABET, EXTRA])[:nalpha]
    q = letters[rng.integers(0, nalpha, size=(b, m))]
    t = letters[rng.integers(0, nalpha, size=(b, n))]
    q[0, :nalpha] = letters    # every letter present
    ql = rng.integers(0 if empty else 1, m + 1, size=b).astype(np.int32)
    tl = rng.integers(0, n + 1, size=b).astype(np.int32)
    if empty:
        ql[:3] = 0
    return q, ql, t, tl


def _oracle(q, ql, t, tl, mode):
    return np.array([jedist.edit_distance(q[i, :ql[i]], t[i, :tl[i]],
                                          mode)[0]
                     for i in range(len(q))])


@pytest.mark.parametrize("nalpha", [4, 5, 16, 17])
@pytest.mark.parametrize("m,n", [(16, 20), (33, 50), (64, 96), (100, 70)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_batched_distance_matches_jax(torch_cpu, mode, m, n, nalpha):
    q, ql, t, tl = _case(m * 1000 + n * 10 + mode + nalpha, 24, max(m, 17),
                         n, nalpha)
    got = edist.batched_edit_distance(q, ql, t, tl, mode)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jax_myers(q, ql, t, tl,
                                                            mode)))
    np.testing.assert_array_equal(got, _oracle(q, ql, t, tl, mode))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_empty_queries(torch_cpu, mode):
    q, ql, t, tl = _case(7 + mode, 12, 40, 30, 4, empty=True)
    lut = torch.from_numpy(alphabet_lut(q, t))
    got = myers_plain(torch.from_numpy(q), torch.from_numpy(ql),
                      torch.from_numpy(t), torch.from_numpy(tl), lut, mode)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_myers(q, ql, t, tl, mode)))
    pairs = [(q[i, :ql[i]].tobytes(), t[i, :tl[i]].tobytes())
             for i in range(len(q))]
    np.testing.assert_array_equal(
        edist.batched_pairs_distance(pairs, mode),
        jedist.batched_pairs_distance(pairs, mode))


@pytest.mark.parametrize("m,n", [(300, 150), (1100, 400)])
def test_many_words(torch_cpu, m, n):
    """Long queries: many 32-row words on the plain version's wavefront."""
    q, ql, t, tl = _case(m + n, 6, m, n, 4)
    for mode in (0, 1, 2):
        np.testing.assert_array_equal(
            edist.batched_edit_distance(q, ql, t, tl, mode),
            _oracle(q, ql, t, tl, mode))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_matches_pallas_interpret(torch_cpu, mode):
    q, ql, t, tl = _case(40 + mode, 16, 40, 64, 4)
    want = np.asarray(batched_edit_distance_pallas(q, ql, t, tl, mode,
                                                   interpret=True))
    np.testing.assert_array_equal(
        myers_cuda.batched_edit_distance_myers(q, ql, t, tl, mode), want)


def test_routes(torch_cpu):
    """CPU tensors take the plain version and launch nothing; more than
    16 letters take the row-scan."""
    q, ql, t, tl = _case(3, 8, 20, 20, 17)
    assert alphabet_lut(q, t) is None
    assert myers_cuda.batched_edit_distance_myers(q, ql, t, tl, 0) is None
    dispatch.reset()
    q, ql, t, tl = _case(3, 8, 20, 20, 4)
    myers_cuda.batched_edit_distance_myers(q, ql, t, tl, 0)
    assert dispatch.snapshot()["myers"] == 0
    with pytest.raises(TypeError):
        myers_cuda.myers(torch.from_numpy(q).int(), torch.from_numpy(ql),
                         torch.from_numpy(t), torch.from_numpy(tl),
                         torch.from_numpy(alphabet_lut(q, t)), 0)


@pytest.mark.parametrize("nalpha", [1, 5, 16])
def test_nalpha_from_alphabet_size(torch_cpu, nalpha):
    """The kernel builds Peq planes for `nalpha` letters: alphabet_size
    gives the batch's count, and the CPU path refuses one below it (the
    card would read empty planes for the letters left out)."""
    q, ql, t, tl = _case(nalpha, 8, 40, 50, nalpha)
    lut = alphabet_lut(q, t)
    assert alphabet_size(lut) == nalpha
    assert alphabet_size(torch.from_numpy(lut)) == nalpha
    args = [torch.from_numpy(x) for x in (q, ql, t, tl, lut)]
    np.testing.assert_array_equal(
        myers_cuda.myers(*args, 0, nalpha).numpy(),
        _oracle(q, ql, t, tl, 0))
    with pytest.raises(ValueError, match="nalpha"):
        myers_cuda.myers(*args, 0, nalpha - 1)


def _query_buckets():
    """Every padded query width batched_pairs_distance makes
    (ops/edist.py bucket_q): 32...512 by 32, then 1,024...8,192 (W =
    256, one launch) and 16,384 and 32,768 (lr's consensus distances of
    long DUPs and INSs, run in strips of W = 256)."""
    return list(range(32, 513, 32)) + [1024, 2048, 4096, 8192, 16384, 32768]


@pytest.mark.parametrize("m", _query_buckets())
def test_launch_geometry(m):
    """K1's host geometry at every query bucket and alphabet size: the
    lanes cover all W words of a launch (at most MAX_WORDS; wider
    queries take strips of MAX_WORDS words, one lane group a pair), a
    lane group is a power of two of at most 32 lanes that divides the
    block, queries of up to 64 rows take one thread per pair, and the
    shared memory the kernel needs (the ring twice over in strips, for
    the carries) fits in what one block may use on the H100."""
    w = myers_cuda.words_bucket(m)
    for nalpha in range(1, 17):
        geo = myers_cuda.launch_geometry(w, nalpha)
        lanes, words = geo["lanes"], geo["words"]
        assert words == min(w, myers_cuda.MAX_WORDS)
        assert lanes * geo["words_per_lane"] == words
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert geo["layout"] == ("thread" if m <= 64 else "lanes")
        assert geo["threads"] % 32 == 0 and geo["threads"] <= 128
        assert geo["pairs"] * lanes == geo["threads"]
        planes = 4 * (nalpha + 1) * words * geo["pairs"]
        ring = geo["buffers"] * geo["pairs"] * myers_cuda.ROW_BYTES
        rings = 2 if w > words else 1
        assert geo["smem"] == planes + rings * ring <= myers_cuda.SMEM_MAX
        if lanes == 1:   # the query rows are staged in the target ring
            assert geo["pairs"] * 4 * (((m + 3) // 4) | 1) <= ring


@pytest.mark.parametrize("nalpha", [1, 16])
@pytest.mark.parametrize("m", [64, 65, 128, 129])
def test_layout_boundaries_match_jax(torch_cpu, m, nalpha):
    """The plain version at the layout boundaries of the kernel (64/65
    rows: thread -> lanes; 128/129: 4 -> 8 words) with one and sixteen
    letters, against the JAX package, the host oracle and the Pallas
    kernel in interpret mode; queries of exactly m rows included."""
    q, ql, t, tl = _case(m * 7 + nalpha, 12, m, 96, nalpha)
    ql[:4] = [m, m - 1, 1, m]
    for mode in (0, 1, 2):
        got = myers_cuda.batched_edit_distance_myers(q, ql, t, tl, mode)
        np.testing.assert_array_equal(
            got, np.asarray(jax_myers(q, ql, t, tl, mode)))
        np.testing.assert_array_equal(got, _oracle(q, ql, t, tl, mode))
    np.testing.assert_array_equal(
        myers_cuda.batched_edit_distance_myers(q, ql, t, tl, 1),
        np.asarray(batched_edit_distance_pallas(q, ql, t, tl, 1,
                                                interpret=True)))


def _long_case(seed, b, m, n):
    """DNA pairs of long queries: ragged query lengths from 4,097 to m
    (m and 4,097 included, and one of a single row), targets of up to n
    columns (one empty), half of them a mutated piece of their query."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = letters[rng.integers(0, 4, size=(b, m))]
    t = letters[rng.integers(0, 4, size=(b, n))]
    ql = rng.integers(min(m, 4097), m + 1, size=b).astype(np.int32)
    ql[:3] = [m, min(m, 4097), 1]
    tl = rng.integers(n // 2, n + 1, size=b).astype(np.int32)
    tl[-1] = 0
    for i in range(0, b, 2):
        k = int(min(ql[i], tl[i]))
        off = int(rng.integers(0, ql[i] - k + 1))
        seg = q[i, off:off + k].copy()
        hit = rng.random(k) < 0.08
        seg[hit] = letters[rng.integers(0, 4, size=int(hit.sum()))]
        t[i, :k] = seg
    return q, ql, t, tl


@pytest.mark.parametrize("m,n,mode", [(8192, 2048, 0), (4096, 4096, 0),
                                      (8192, 2048, 1), (8192, 2048, 2),
                                      (16384, 2048, 0), (16384, 1024, 2)])
def test_long_queries_match_jax_host(torch_cpu, m, n, mode):
    """Long queries, the widths lr gives K1 (consensus distances
    bucketed to 8,192 x 2,048 and 4,096 x 4,096, and 16,384 rows for
    long DUPs and INSs, which K1 runs in two strips), on the plain
    version through the batch entry point: the distances of the JAX
    package's host edit_distance, and no batch on the row-scan."""
    q, ql, t, tl = _long_case(m + n + mode, 6, m, n)
    dispatch.reset()
    got = edist.batched_edit_distance(q, ql, t, tl, mode)
    assert dispatch.snapshot()["rowscan"] == 0
    np.testing.assert_array_equal(got, _oracle(q, ql, t, tl, mode))
