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
        ring = geo["pairs"] * geo["ring_bytes"]
        assert geo["ring_bytes"] == (2 * myers_cuda.ROW_BYTES if lanes == 1
                                     else myers_cuda.RING_BYTES)
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


def _lanes_model(q, ql, t, tl, lut, nalpha, mode, W, r0=0, cin=None):
    """A numpy model of csrc/myers.cu's lanes layout: its blocks of
    pairs, the letter rings and the order in which chunks are staged and
    coded, and each lane's step: lane l's word k (word w = l * WL + k) at
    column s - w, the next step's planes and the letter after loaded a
    step ahead, the carry between a lane's words in registers and between
    lanes by a shuffle used the step after it is made, the score's word
    picked by a mask. Every letter code a
    step reads must be a coded one (at most nalpha: a raw byte would
    address past the planes). Returns (distances of the pairs whose
    strip holds their score, else -1; the carries out of the strip's top
    word, -2 where unwritten)."""
    u32 = np.uint32
    B, M = q.shape
    N = t.shape[1]
    GL = min(W, 32)
    WL = W // GL
    P = (128 if W <= 16 else 32) // GL
    chunk, ring_n = 64, 512
    nb = -(-B // P)
    pad = nb * P - B
    live = np.arange(nb * P) < B
    qlen = np.concatenate([ql, np.zeros(pad, np.int64)]).astype(np.int64)
    tlen = np.concatenate([tl, np.zeros(pad, np.int64)]).astype(np.int64)
    qrel = qlen - r0
    holds = np.where(qlen <= 0, r0 == 0, (qrel >= 1) & (qrel <= 32 * W))
    tlp = np.where((qrel > 0) | (r0 == 0), np.clip(np.minimum(tlen, N), 0,
                                                   None), 0)
    tmax = tlp.reshape(nb, P).max(axis=1)
    nsteps = np.where(tmax > 0, (tmax + W + 6) // 8 * 8, 0)
    tchunks = -(-tmax // chunk)
    lut = np.asarray(lut, dtype=np.int64)
    # Peq planes (nalpha + 1, pairs, W): bits at or above the strip's rows
    # of the query clear, the last plane empty
    peq = np.zeros((nalpha + 1, nb * P, W), dtype=u32)
    for i in range(B):
        qn = max(0, min(min(int(qlen[i]), M) - r0, 32 * W))
        c = lut[q[i, r0:r0 + qn]]
        for r in np.flatnonzero(c < nalpha):
            peq[c[r], i, r // 32] |= u32(1 << (r % 32))
    tt = np.zeros((nb * P, N), dtype=np.int64)
    tt[:B] = t
    cc = np.zeros((nb * P, N), dtype=np.int64)
    if cin is not None:
        cc[:B] = cin
    ring = np.full((nb * P, ring_n), nalpha, dtype=np.int64)
    cring = np.zeros((nb * P, ring_n), dtype=np.int64)
    blk_of = np.repeat(np.arange(nb), P)

    def stage(kc):
        j0 = kc * chunk
        cols = np.arange(j0, min(j0 + chunk, N))
        rows = np.flatnonzero(live & (kc < tchunks[blk_of]))
        if len(cols) and len(rows):
            ring[np.ix_(rows, cols % ring_n)] = tt[np.ix_(rows, cols)]
            cring[np.ix_(rows, cols % ring_n)] = cc[np.ix_(rows, cols)]

    def code(kc):
        rows = np.flatnonzero(kc < tchunks[blk_of])
        at = (kc * chunk) % ring_n + np.arange(chunk)
        ring[np.ix_(rows, at)] = np.minimum(lut[ring[np.ix_(rows, at)]],
                                            nalpha)

    lanes = np.arange(GL)
    lag = (lanes * WL)[None, :]                         # (1, GL)
    pairs = np.arange(nb * P)[:, None]
    word = (lanes * WL)[None, :, None] + np.arange(WL)  # (1, GL, WL)
    hw = (qrel - 1) >> 5
    hb = ((qrel - 1) & 31).astype(u32)
    owner = np.where(~holds, -1, np.where(qlen > 0, hw // WL, 0))
    send = (tlp + hw)[:, None]
    pick = np.where((qlen > 0)[:, None, None]
                    & (lanes[None, :, None] == owner[:, None, None])
                    & (word == hw[:, None, None]),
                    u32(1) << hb[:, None, None], u32(0)).astype(u32)
    shape = (nb * P, GL, WL)
    pv = np.full(shape, 0xFFFFFFFF, dtype=u32)
    mv, ph, mh, eq = (np.zeros(shape, dtype=u32) for _ in range(4))
    ad = np.full(shape, nalpha, dtype=np.int64)         # a plane per word
    score = np.repeat(qlen[:, None], GL, axis=1)
    res = score.copy()
    vin0 = u32(0 if mode == 2 else 0x80000000)
    cout = np.full((nb * P, N), -2, dtype=np.int64)

    def bits(h):
        return np.where(h > 0, u32(0x80000000),
                        np.where(h < 0, u32(1), u32(0))).astype(u32)

    def read(col):
        c = ring[pairs, col % ring_n]
        assert (c <= nalpha).all(), "a step read an uncoded letter"
        return c

    stage(0)
    stage(1)
    code(0)
    ad[..., 0] = read(-lag)
    eq[..., 0] = peq[ad[..., 0], pairs, word[..., 0]]
    cn = read(1 - lag)
    vin = np.where(lanes == 0, bits(cring[:, :1]) if cin is not None
                   else vin0, u32(0)).astype(u32)
    for kc in range(int(-(-nsteps.max() // chunk)) if B else 0):
        stage(kc + 2)
        code(kc + 1)
        for s in range(kc * chunk, min((kc + 1) * chunk, nsteps.max())):
            on = (s < nsteps[blk_of])[:, None]
            adn = np.concatenate([cn[..., None], ad[..., :-1]], axis=2)
            eqn = peq[adn, pairs[..., None], word]
            cn = read(s + 2 - lag)
            v0 = (bits(cring[:, (s + 1) % ring_n])[:, None]
                  if cin is not None else vin0)
            with np.errstate(over="ignore"):
                for k in range(WL - 1, -1, -1):
                    cp = ph[..., k - 1] if k else vin
                    hn = mh[..., k - 1] >> u32(31) if k else vin & u32(1)
                    e, p0, m0 = eq[..., k], pv[..., k], mv[..., k]
                    xv = e | m0
                    eq2 = e | hn
                    xh = (((eq2 & p0) + p0) ^ p0) | eq2
                    h = m0 | ~(xh | p0)
                    m = p0 & xh
                    hs = (h << u32(1)) | (cp >> u32(31))
                    ms = (m << u32(1)) | hn
                    pv[..., k] = np.where(on, ms | ~(xv | hs), p0)
                    mv[..., k] = np.where(on, hs & xv, m0)
                    ph[..., k] = np.where(on, h, ph[..., k])
                    mh[..., k] = np.where(on, m, mh[..., k])
            vout = (ph[..., -1] & u32(0x80000000)) | (mh[..., -1] >> u32(31))
            up = np.concatenate([vout[:, :1], vout[:, :-1]], axis=1)
            vin = np.where(on, np.where(lanes == 0, v0, up), vin).astype(
                u32)
            j = s - (W - 1)
            top = (on[:, 0] & (j >= 0) & (j < tlp))
            if top.any():
                cout[top, j] = ((ph[top, -1, -1] >> u32(31)).astype(np.int64)
                                - (mh[top, -1, -1] >> u32(31)))
            sp = np.bitwise_or.reduce(ph & pick, axis=2)
            sm = np.bitwise_or.reduce(mh & pick, axis=2)
            d = ((sp >> hb[:, None]).astype(np.int64)
                 - (sm >> hb[:, None]).astype(np.int64))
            score = score + np.where(on & (s < send), d, 0)
            res = np.where(on, np.minimum(res, score), res)
            ad = np.where(on[..., None], adn, ad)
            eq = np.where(on[..., None], eqn, eq)
    i = np.arange(nb * P)
    sc = score[i, np.maximum(owner, 0)]
    rs = res[i, np.maximum(owner, 0)]
    if mode == 0:
        rs = np.where(tlen == 0, qlen, np.where((tlen >= 1) & (tlen <= N),
                                                sc, 1 << 20))
    out = np.where(qlen <= 0, tlen if mode == 0 else 0, rs)
    out = np.where(holds & live, out, -1)
    return out[:B], cout[:B]


def _model_strips(q, ql, t, tl, lut, mode):
    """The model run as the wrapper launches it: one strip of W = 256 (or
    the query's words) after another, from the bottom, each strip's top
    carries into the next. Returns (distances, launches)."""
    nalpha = alphabet_size(lut)
    geo = myers_cuda.launch_geometry(myers_cuda.words_bucket(q.shape[1]),
                                     nalpha)
    w = geo["words"]
    strips = -(-q.shape[1] // (32 * w))
    out = np.full(len(q), -1, dtype=np.int64)
    cin = None
    for k in range(strips):
        got, cout = _lanes_model(q, ql, t, tl, lut, nalpha, mode, w,
                                 32 * w * k, cin)
        assert ((out < 0) | (got < 0)).all()   # one strip holds a score
        out = np.where(got >= 0, got, out)
        cin = cout
    return out, strips


@pytest.mark.parametrize("m,n,nalpha", [
    (65, 150, 4), (100, 64, 1), (200, 130, 16), (512, 96, 5),
    (1000, 70, 4), (2048, 200, 4), (4096, 90, 2), (8192, 70, 4),
    (16384, 40, 4)])
def test_lanes_model_matches_plain(m, n, nalpha):
    """The lanes layout's schedule (_lanes_model) gives the plain
    version's distances at every lanes width, W = 4 (65 rows) to 256
    (8,192) and two strips (16,384): queries of exactly m rows, 32k and
    32k + 1 rows, one row and none beside ragged ones, targets of 0, 1
    and n columns, in a number of pairs that is no multiple of a
    block's, all three modes."""
    q, ql, t, tl = _case(m * 3 + n + nalpha, 37, m, n, nalpha, empty=True)
    ql[3:9] = [m, 1, min(m, 96), min(m, 97), m - 1, 32 * (m // 64) + 1]
    tl[3:12] = [0, 1, n, n, 0, 1, n, n - 1, n]
    lut = alphabet_lut(q, t)
    for mode in (0, 1, 2):
        want = myers_plain(*(torch.from_numpy(x) for x in (q, ql, t, tl,
                                                           lut)), mode)
        got, strips = _model_strips(q, ql, t, tl, lut, mode)
        assert strips == -(-m // 8192)
        np.testing.assert_array_equal(got, want.numpy())


def test_lanes_ring_size_matches_kernel():
    """RING_BYTES, which launch_geometry sizes the shared memory by, is
    the kernel's ring: kRing chunks of kChunk columns a pair and the
    words past its end (a copy of its first bytes, and pad)."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(myers_cuda.__file__), "..",
                            "csrc", "myers.cu")).read()
    ring = int(re.search(r"constexpr int kRing = (\d+);", src).group(1))
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))
    extra = int(re.search(r"constexpr int kRingWords = kRingBytes / 4 \+ "
                          r"(\d+);", src).group(1))
    assert re.search(r"constexpr int kRingBytes = kRing \* kChunk;", src)
    assert myers_cuda.RING_BYTES == 4 * (ring * chunk // 4 + extra)


def test_kernel_names_map_to_k1():
    """Every __global__ function of csrc/myers.cu, named as the device
    trace prints it, is K1 to svbench (svbench/trace.py kernel_key): a
    renamed kernel fails here and not as roofline.k1 missing on the
    card."""
    import os
    import re

    from svbench.trace import kernel_key
    src = open(os.path.join(os.path.dirname(myers_cuda.__file__), "..",
                            "csrc", "myers.cu")).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert {"myers_thread_kernel", "myers_lanes_kernel"} <= set(names)
    for name in names:
        for w in (2, 64):
            trace = (f"void (anonymous namespace)::{name}<{w}>("
                     f"(anonymous namespace)::Args)")
            assert kernel_key(trace) == "k1", trace
