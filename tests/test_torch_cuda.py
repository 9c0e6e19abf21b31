"""The PyTorch port's kernels against their plain versions on the card.

Every test needs an NVIDIA GPU and nvcc and skips elsewhere. This file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs come from numpy.random.default_rng; tolerance: exact equality
(integer distances and scores, byte tiles and codes).
"""

import random

import numpy as np
import pytest
import torch

from delly_tpu_torch.ops import gotoh_banded_cuda, gotoh_cuda, gotoh_wide_cuda
from delly_tpu_torch.ops.gotoh import DnaScore, gotoh, to_align
from delly_tpu_torch.ops.myers import (alphabet_lut, alphabet_size,
                                       myers_plain)
from delly_tpu_torch.ops.lcs_cuda import lcs, letter_lut
from delly_tpu_torch.ops.msa import lcs_plain
from delly_tpu_torch.ops.myers_cuda import myers
from delly_tpu_torch.parallel import dispatch
from torch_card import card, depth_windows  # noqa: F401

ACS = [(False, False), (True, False), (False, True), (True, True)]


def _myers_case(seed, b, m, n, nalpha):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)[:nalpha]
    q = letters[rng.integers(0, nalpha, size=(b, m))]
    t = letters[rng.integers(0, nalpha, size=(b, n))]
    ql = rng.integers(0, m + 1, size=b).astype(np.int32)
    tl = rng.integers(0, n + 1, size=b).astype(np.int32)
    return [torch.from_numpy(x) for x in (q, ql, t, tl, alphabet_lut(q, t))]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,nalpha", [(64, 128, 4), (40, 100, 5),
                                        (512, 256, 4), (2048, 300, 4),
                                        (4096, 64, 4)])
def test_myers_kernel_matches_plain(card, m, n, nalpha):
    args = _myers_case(m + n + nalpha, 300, m, n, nalpha)
    for mode in (0, 1, 2):
        want = myers_plain(*args, mode)
        dispatch.reset()
        got = myers(*(x.to(card) for x in args), mode)
        torch.cuda.synchronize()
        assert dispatch.snapshot()["myers"] == 1
        assert torch.equal(got.cpu(), want)


K1_QLENS = [0, 1, 31, 32, 33, 64, 65, 128, 129, 2048, 4096, 4097, 8192,
            8193, 16384]


@pytest.mark.cuda
@pytest.mark.parametrize("nalpha", [1, 5, 16])
@pytest.mark.parametrize("qlen", K1_QLENS)
def test_myers_layouts_match_plain(card, qlen, nalpha):
    """Both layouts of csrc/myers.cu (a thread per pair up to 64 rows, a
    lane group above) at their edges, and queries of more than 8,192
    rows in strips: queries of exactly qlen rows beside ragged shorter
    ones (1, 4,097, 8,192 and 8,193 rows among them where they fit), in
    131 pairs (no multiple of a block's pairs), targets of 0, 1 and N
    columns, half of them a mutated piece of their query, row-major
    with N = 150 (staged byte by byte) and 256 (4-byte copies); queries
    above 4,096 rows take N = 2,048 (lr's consensus distances: targets
    shorter than the queries) in place of 256, and 8,192 rows also
    N = 8,400; all three modes, one K1 launch per strip of 8,192 rows."""
    rng = np.random.default_rng(qlen * 17 + nalpha)
    letters = np.frombuffer(b"ACGTNRYKMSWBDHVX", dtype=np.uint8)[:nalpha]
    b, m = 131, max(qlen, 1)
    edges = [e for e in (1, 4097, 8192, 8193) if e < qlen]
    widths = (150, 256) if qlen <= 4096 else (150, 2048)
    for n in widths + ((8400,) if qlen == 8192 else ()):
        q = letters[rng.integers(0, nalpha, size=(b, m))]
        t = letters[rng.integers(0, nalpha, size=(b, n))]
        t[0, :nalpha] = letters
        ql = np.full(b, qlen, dtype=np.int32)
        ql[1::7] = rng.integers(0, qlen + 1, size=len(ql[1::7]))
        ql[2:2 + len(edges)] = edges
        tl = np.resize(np.array([0, 1, n], dtype=np.int32), b)
        tl[3::5] = rng.integers(0, n + 1, size=len(tl[3::5]))
        for i in range(8, b, 2):
            k = int(min(ql[i], tl[i]))
            off = int(rng.integers(0, ql[i] - k + 1))
            seg = q[i, off:off + k].copy()
            hit = rng.random(k) < 0.08
            seg[hit] = letters[rng.integers(0, nalpha, size=int(hit.sum()))]
            t[i, :k] = seg
        lut = alphabet_lut(q, t)
        assert alphabet_size(lut) == nalpha
        args = [torch.from_numpy(x) for x in (q, ql, t, tl, lut)]
        for mode in (0, 1, 2):
            want = myers_plain(*args, mode)
            dispatch.reset()
            got = myers(*(x.to(card) for x in args), mode,
                        alphabet_size(lut))
            torch.cuda.synchronize()
            assert dispatch.snapshot()["myers"] == -(-m // 8192)
            assert torch.equal(got.cpu(), want), (n, mode)


def _lanes_case(seed, b, m, n, nalpha, qlo=None, qhi=None):
    """`b` pairs over `nalpha` letters at m x n, half of the targets a
    mutated piece of their query; query lengths in [qlo, qhi] (else 1 to
    m) with the edges of the lanes layout among them: a query ending on
    a lane's last word and on a word's last bit (32k, 32k + 1), m rows,
    one row; targets of 0, 1 and n columns among ragged ones."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTNRYKMSWBDHVX", dtype=np.uint8)[:nalpha]
    q = letters[rng.integers(0, nalpha, size=(b, m))]
    t = letters[rng.integers(0, nalpha, size=(b, n))]
    t[0, :nalpha] = letters
    ql = rng.integers(qlo or 1, (qhi or m) + 1, size=b).astype(np.int32)
    tl = rng.integers(0, n + 1, size=b).astype(np.int32)
    if qlo is None:
        wl = max(1, -(-m // 32) // 32)          # words a lane
        ql[1:7] = [m, 1, 32 * wl * 3, 32 * wl * 3 + 1, 32 * (m // 64),
                   32 * (m // 64) + 1]
        tl[1:5] = [0, 1, n, 0]
        tl[7:9] = [1, n]
    else:
        tl = rng.integers(qlo, (qhi or n) + 1, size=b).astype(np.int32)
    for i in range(0, b, 2):
        k = int(min(ql[i], tl[i]))
        off = int(rng.integers(0, ql[i] - k + 1))
        seg = q[i, off:off + k].copy()
        hit = rng.random(k) < 0.08
        seg[hit] = letters[rng.integers(0, nalpha, size=int(hit.sum()))]
        t[i, :k] = seg
    lut = alphabet_lut(q, t)
    assert alphabet_size(lut) == nalpha
    return [torch.from_numpy(x) for x in (q, ql, t, tl, lut)]


# (pairs, m, n, nalpha, query and target lengths, modes)
LANES_CASES = {
    # ont.cons: one DEL's msaEdlib call, 105 NW pairs of 1,669-2,000 bases
    "ont_cons": (105, 2048, 2048, 4, (1669, 2000), (0,)),
    # a 16,384-row query in two strips: carries out of one, into the next
    "strips": (24, 16384, 700, 4, None, (0, 1, 2)),
}
for _w in (4, 16, 64, 256):
    for _na in (1, 4, 16):
        # fewer pairs than the card's 132 SMs take blocks
        LANES_CASES[f"W{_w}_nalpha{_na}"] = (40, 32 * _w, 300, _na, None,
                                             (0, 1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LANES_CASES))
def test_myers_lanes_match_plain(card, case):
    """The lanes layout (W >= 4) bit-equal to the plain version at the
    shapes it serves with few pairs a launch: ont.cons's call, fewer
    pairs than SMs at W = 4, 16, 64 and 256 with 1, 4 and 16 letters
    (queries ending on a lane's last word and on a word's last bit,
    targets of 0 and 1 columns), and a query in two strips; one K1
    launch per strip of 8,192 rows."""
    b, m, n, nalpha, lens, modes = LANES_CASES[case]
    lo, hi = lens or (None, None)
    args = _lanes_case(len(case) * 1009 + m + n, b, m, n, nalpha, lo, hi)
    for mode in modes:
        want = myers_plain(*args, mode)
        dispatch.reset()
        got = myers(*(x.to(card) for x in args), mode, nalpha)
        torch.cuda.synchronize()
        assert dispatch.snapshot()["myers"] == -(-m // 8192)
        assert torch.equal(got.cpu(), want), (case, mode)


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


def _gotoh_case(seed, n_jobs, lo, hi, rows, K=None):
    rng = random.Random(seed)
    jobs = []
    for _ in range(n_jobs):
        base = _rand_seq(rng, lo, hi)
        a1 = to_align(_mutate(rng, base))
        if rows > 1:
            a1 = gotoh(a1, _mutate(rng, base), ac=(True, True))[1]
        jobs.append((a1, to_align(_mutate(rng, base))))
    return _pack(jobs, K)


def _pack(jobs, K=None):
    K = K or gotoh_cuda._bucket_k(max(max(x.shape[1], y.shape[1])
                                      for x, y in jobs))
    return [torch.from_numpy(x)
            for x in gotoh_cuda.pack_bucket(jobs, K, DnaScore())]


def deep_jobs(seed, n_jobs, rows1, rows2, lo, hi):
    """Gotoh jobs of alignment blocks with rows1 and rows2 rows
    (substitutions and gaps around one base sequence of lo...hi
    columns): profile depths near the kernel's gate, so that d1 * d2
    reaches its largest values and the profile score takes both signs."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT-", dtype=np.uint8)
    jobs = []
    for _ in range(n_jobs):
        n = int(rng.integers(lo, hi + 1))
        base = letters[rng.integers(0, 4, n)]
        pair = []
        for rows, cut in ((rows1, 0), (rows2, int(rng.integers(0, 20)))):
            a = np.repeat(base[None, :n - cut], rows, axis=0)
            hit = rng.random(a.shape) < 0.15
            a[hit] = letters[rng.integers(0, 5, int(hit.sum()))]
            pair.append(a)
        jobs.append(tuple(pair))
    return jobs


def _assert_gotoh(card, prof, wc2, d2, ml, nl, ac):
    """K2 and K2-tb on the card against the plain versions on the
    contract's cells: best, the bits of rows < mlen and columns < nlen,
    lens and the codes; one launch each."""
    want_best, want_bits = gotoh_cuda.gotoh_forward_plain(
        prof, wc2, d2, ml, nl, ac[0], ac[1], -10, -1)
    want_codes, want_lens = gotoh_cuda.gotoh_traceback_plain(want_bits, ml,
                                                             nl)
    dev = [x.to(card) for x in (prof, wc2, d2, ml, nl)]
    dispatch.reset()
    best, bits = gotoh_cuda.gotoh_forward(*dev, ac[0], ac[1], -10, -1)
    codes, lens = gotoh_cuda.gotoh_traceback(bits, dev[3], dev[4])
    torch.cuda.synchronize()
    assert dispatch.snapshot()["gotoh"] == 1
    assert torch.equal(best.cpu(), want_best)
    assert torch.equal(lens.cpu(), want_lens)
    for g in range(len(ml)):
        m, n, k = int(ml[g]), int(nl[g]), int(lens[g])
        assert torch.equal(bits[g, :m, :n].cpu(), want_bits[g, :m, :n])
        assert torch.equal(codes[g, :k].cpu(), want_codes[g, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("ac", ACS)
@pytest.mark.parametrize("K,n_jobs,rows", [(128, 64, 1), (256, 40, 2),
                                           (512, 16, 2), (1024, 6, 1),
                                           (2048, 3, 1), (4096, 2, 1)])
def test_gotoh_kernels_match_plain(card, ac, K, n_jobs, rows):
    """Every K bucket, each with its own layout in csrc/gotoh.cu."""
    _assert_gotoh(card, *_gotoh_case(n_jobs + K, n_jobs, K // 2 + 8,
                                     K * 3 // 4, rows, K), ac)


def _length_one():
    s = to_align(_rand_seq(random.Random(4), 300, 400))
    return _pack([(s, to_align("A")), (to_align("C"), s),
                   (to_align("G"), to_align("G")),
                   (to_align("T"), s[:, :3].copy())], 512)


EDGE_CASES = {
    "one merge": lambda: _gotoh_case(1, 1, 70, 110, 2, 128),
    "odd batch": lambda: _gotoh_case(2, 37, 130, 200, 1, 256),
    # merges of 1...110 columns side by side
    "mixed mlen": lambda: _gotoh_case(3, 45, 1, 110, 1, 128),
    "length one": _length_one,   # mlen = 1 and nlen = 1 in a wide bucket
    "deep 300x400": lambda: _pack(deep_jobs(5, 12, 300, 400, 90, 240)),
    "deep 400x300 K=1024": lambda: _pack(deep_jobs(6, 3, 400, 300, 600,
                                                   1000)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ac", ACS)
@pytest.mark.parametrize("kind", list(EDGE_CASES))
def test_gotoh_kernel_edges_match_plain(card, ac, kind):
    """One merge, an odd batch, mixed lengths side by side, mlen or
    nlen 1, and deep profiles near the gate (300 x 400 rows: 300 * 400 *
    125 < 2^24)."""
    _assert_gotoh(card, *EDGE_CASES[kind](), ac)


def _tb_edge_jobs(K, seed):
    """mlen and nlen each 1, 2 and K (walks that run along row 0 or
    column 0 from the start, and the whole tile), and a long merge."""
    rng = random.Random(seed)
    sizes = (1, 2, K)
    jobs = [(to_align(_rand_seq(rng, a, a)), to_align(_rand_seq(rng, c, c)))
            for a in sizes for c in sizes]
    base = _rand_seq(rng, K - K // 8, K - K // 8)
    jobs.append((to_align(_mutate(rng, base)), to_align(_mutate(rng, base))))
    return _pack(jobs, K)


@pytest.mark.cuda
@pytest.mark.parametrize("ac", ACS)
@pytest.mark.parametrize("K", [128, 256, 512, 1024, 2048, 4096])
def test_gotoh_tb_edges_match_plain(card, ac, K):
    """K2-tb at every bucket (one window at K = 128, two above) with
    mlen, nlen in {1, 2, K}."""
    _assert_gotoh(card, *_tb_edge_jobs(K, K + 7), ac)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n_jobs", [(128, 2000), (256, 450)])
def test_gotoh_tb_more_merges_than_a_wave(card, K, n_jobs):
    """More walks than the SMs hold at once (about 13 per SM at K = 128,
    3 at K = 256)."""
    _assert_gotoh(card, *_gotoh_case(K + n_jobs, n_jobs, K // 2,
                                     K * 3 // 4, 1, K), (True, True))


def _wide_case(seed, W, sizes, rows=2):
    """K4's packed launch of merges of (m, n) `sizes` (m DP rows against
    n columns, the tile (max m, max n to a multiple of 16), m or n past
    4,096 up to W): a profile of `rows` rows of a mutated base against a
    mutated copy, or against random letters where n is 1."""
    rng = random.Random(seed)
    jobs = []
    for m, n in sizes:
        base = _rand_seq(rng, max(m, n), max(m, n))
        a1 = [_mutate(rng, base)[:m].ljust(m, "A") for _ in range(rows)]
        a1 = np.array([np.frombuffer(x.encode(), np.uint8) for x in a1])
        a2 = to_align(_mutate(rng, base)[:n].ljust(n, "C"))
        jobs.append((a1, a2))
    assert max(max(a.shape[1], b.shape[1]) for a, b in jobs) <= W
    M, N = gotoh_wide_cuda.tile_shape([a.shape[1] for a, _ in jobs],
                                      [b.shape[1] for _, b in jobs])
    return [torch.from_numpy(x) for x in
            gotoh_cuda.pack_bucket(jobs, M, DnaScore(), N)]


def _assert_wide(card, prof, wc2, d2, ml, nl, ac):
    """K4 and K4-tb on the card against the plain versions, run on the
    card too (the host would take minutes at 16,384), on the contract's
    cells: best, the bits of rows < mlen and columns < nlen, lens and
    the codes; one launch each."""
    dev = [x.to(card) for x in (prof, wc2, d2, ml, nl)]
    want_best, want_bits = gotoh_cuda.gotoh_forward_plain(
        *dev, ac[0], ac[1], -10, -1)
    want_codes, want_lens = gotoh_cuda.gotoh_traceback_plain(
        want_bits, dev[3], dev[4])
    dispatch.reset()
    best, bits = gotoh_wide_cuda.gotoh_wide_forward(*dev, ac[0], ac[1], -10,
                                                    -1)
    codes, lens = gotoh_wide_cuda.gotoh_wide_traceback(bits, dev[3], dev[4])
    torch.cuda.synchronize()
    counts = dispatch.snapshot()
    assert counts["gotoh_wide"] == counts["gotoh_wide_tb"] == 1
    assert torch.equal(best, want_best)
    assert torch.equal(lens, want_lens)
    for g in range(len(ml)):
        m, n, k = int(ml[g]), int(nl[g]), int(lens[g])
        assert torch.equal(bits[g, :m, :n], want_bits[g, :m, :n])
        assert torch.equal(codes[g, :k], want_codes[g, :k])


WIDE_CASES = {
    # jagged lengths: the tile sized by the longest m and n
    "8192": (8192, [(8192, 7900), (6000, 8100), (4200, 300)]),
    "16384": (16384, [(16384, 16000), (12300, 12100), (700, 16384)]),
    # walks along row 0 or column 0 and thin tiles
    "edges": (16384, [(12000, 1), (1, 12000), (5000, 16), (16, 5000)]),
    # K4's strips (strip_geometry): one merge, the most strips a merge
    "one 16384": (16384, [(16384, 16384)]),
    # 3 and 14 merges of ~12,200 (14 within the 2 GiB budget)
    "3 x 12200": (16384, [(12200, 12150), (12100, 12208), (11950, 12000)]),
    "14 x 12200": (16384, [(12200 - 20 * i, 12180 - 13 * i)
                           for i in range(14)]),
    # more thin merges than the card has SMs: one strip a merge, walked
    # as chunks
    "140 thin": (16384, [(60 + i, 16384 - 7 * i) for i in range(140)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ac", ACS)
@pytest.mark.parametrize("kind", list(WIDE_CASES))
def test_gotoh_wide_kernels_match_plain(card, ac, kind):
    """K4/K4-tb at both wide buckets, jagged lengths, and mlen or nlen of
    1 with thin tiles; K4's strips at the most strips a merge (one merge
    of 16,384 x 16,384), at 3 and 14 merges (fewer strips), and at one
    strip a merge (140 thin merges, more than the SMs)."""
    W, sizes = WIDE_CASES[kind]
    _assert_wide(card, *_wide_case(len(sizes) + W, W, sizes), ac)


@pytest.mark.cuda
@pytest.mark.parametrize("ac", ACS)
def test_gotoh_wide_strip_edges_match_plain(card, ac):
    """nlen on the edges of K4's chunks, as strip_geometry cuts five
    merges of up to 12,200 columns on this card: on a chunk's last
    column, on the next one's first, and on later chunks' edges."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    P, W, C = gotoh_wide_cuda.strip_geometry(5, 12208, sms)
    wc = W // C
    assert P > 1
    sizes = [(3000, 12200), (3000, wc), (3000, wc + 1), (2500, 2 * wc),
             (2000, 3 * wc + 1)]
    _assert_wide(card, *_wide_case(wc, 16384, sizes), ac)


@pytest.mark.cuda
def test_gotoh_wide_batch_chunked_on_card(card, monkeypatch):
    """gotoh_batch on the card with K4's tile budget lowered so that six
    wide merges take three launches: each equal to the host oracle, no
    host route."""
    from delly_tpu_torch.utils import torchenv

    rng = random.Random(8)
    jobs = []
    for _ in range(6):
        base = _rand_seq(rng, 4500, 5000)
        jobs.append((to_align(_mutate(rng, base)),
                     to_align(_mutate(rng, base))))
    M, N = gotoh_wide_cuda.tile_shape([a.shape[1] for a, _ in jobs],
                                      [b.shape[1] for _, b in jobs])
    monkeypatch.setenv(torchenv.ENV, "cuda")
    monkeypatch.setattr(gotoh_wide_cuda, "TILE_BUDGET", 2 * M * N)
    torchenv.reset()
    dispatch.reset()
    try:
        got = gotoh_cuda.gotoh_batch(jobs, ac=(True, True))
    finally:
        torchenv.reset()
    counts = dispatch.snapshot()
    assert counts["gotoh_wide"] == counts["gotoh_wide_tb"] == 3
    assert counts["host_routes"] == 0
    for (a1, a2), (s, mg) in zip(jobs, got):
        hs, hm = gotoh(a1, a2, ac=(True, True))
        assert s == hs
        np.testing.assert_array_equal(mg, hm)


def _subst(rng, s, rate=0.05):
    """s with a share `rate` of its letters replaced (no indels)."""
    return "".join(rng.choice("ACGT") if rng.random() < rate else ch
                   for ch in s)


def _gap_case(seed, W):
    """K4's packed launch of merges whose walks run gaps longer than two
    of K4-tb's tiles, in a tile of W columns: copies of a base of W - 15
    to W - 1 letters with a cut of W // 8 in either one (a horizontal
    and a vertical gap), a third of the base against the whole and the
    whole against a piece (end gaps, walks that end on row 0 or column
    0), one letter against the base and the base against one letter."""
    rng = random.Random(seed)
    n = W - rng.randint(1, 15)
    base = _rand_seq(rng, n, n)
    cut, lo = W // 8, rng.randint(n // 4, n // 2)
    pairs = [(base, base[:lo] + base[lo + cut:]),
             (base[:lo] + base[lo + cut:], base),
             (base[n // 3:2 * n // 3], base), (base, base[n // 5:n // 2]),
             (base[n // 2:n // 2 + 1], base), (base, base[7:8])]
    jobs = [(to_align(_subst(rng, x)), to_align(_subst(rng, y)))
            for x, y in pairs]
    M, N = gotoh_wide_cuda.tile_shape([a.shape[1] for a, _ in jobs],
                                      [b.shape[1] for _, b in jobs])
    return [torch.from_numpy(x) for x in
            gotoh_cuda.pack_bucket(jobs, M, DnaScore(), N)]


def _assert_wide_tb(card, bits, ml, nl):
    """K4-tb on the card against the plain walk on the same bits (run on
    the card too): lengths and each walk's codes; one launch."""
    want_codes, want_lens = gotoh_cuda.gotoh_traceback_plain(bits, ml, nl)
    dispatch.reset()
    codes, lens = gotoh_wide_cuda.gotoh_wide_traceback(bits, ml, nl)
    torch.cuda.synchronize()
    assert dispatch.snapshot()["gotoh_wide_tb"] == 1
    assert codes.shape == want_codes.shape
    assert torch.equal(lens, want_lens)
    for g in range(len(ml)):
        k = int(lens[g])
        assert torch.equal(codes[g, :k], want_codes[g, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("ac", ACS)
@pytest.mark.parametrize("W", [4112, 16384])
def test_gotoh_wide_tb_gap_walks_match_plain(card, ac, W):
    """K4-tb on K4's bits of merges whose walks leave the tiles that the
    walk's diagonal predicts (gaps of W // 8, end gaps, mlen or nlen of
    1), in tiles of 4,112 and 16,384 columns, against the plain walk."""
    prof, wc2, d2, ml, nl = (x.to(card) for x in _gap_case(W + len(ac), W))
    assert wc2.shape[2] == W
    _best, bits = gotoh_wide_cuda.gotoh_wide_forward(
        prof, wc2, d2, ml, nl, ac[0], ac[1], -10, -1)
    _assert_wide_tb(card, bits, ml, nl)


def _random_bits(card, seed, G, M, N, opened):
    """Direction bits drawn at random on the card (a seeded generator),
    each merge's gaps opened at cells with probability opened[g %
    len(opened)] (gaps of about its inverse), S==H and S==V each at 30%;
    lengths from 1 to M and N, the first merge's M and N."""
    gen = torch.Generator(device=card).manual_seed(seed)
    bits = torch.empty((G, M, N), dtype=torch.uint8, device=card)
    for g in range(G):
        p = opened[g % len(opened)]
        b = torch.zeros((M, N), dtype=torch.uint8, device=card)
        for k, share in enumerate((0.3, 0.3, p, p)):
            hit = torch.rand((M, N), device=card, generator=gen) < share
            b |= hit.to(torch.uint8) << k
        bits[g] = b
    rng = np.random.default_rng(seed)
    ml = rng.integers(1, M + 1, G).astype(np.int32)
    nl = rng.integers(1, N + 1, G).astype(np.int32)
    ml[0], nl[0] = M, N
    return bits, torch.from_numpy(ml).to(card), torch.from_numpy(nl).to(card)


TB_RANDOM = {
    # one walk over a whole 16,384 x 16,384 tile, gaps of ~300 cells
    "G 1": (1, 16384, 16384, (0.003,)),
    # more walks than SMs, in tiles of 4,112 columns
    "G 300": (300, 160, 4112, (0.2, 0.02, 0.003)),
    # gaps that open rarely: runs of ~1,000 cells across many tiles
    "long gaps": (6, 3000, 4112, (0.001,)),
    # thin tiles: fewer rows or columns than a tile
    "thin": (40, 37, 16384, (0.05,)),
    "narrow": (40, 5000, 48, (0.05,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(TB_RANDOM))
def test_gotoh_wide_tb_random_bits_match_plain(card, kind):
    """K4-tb on random direction bits (every byte a walk may meet, gaps
    of every length) against the plain walk: one walk of a whole
    16,384-column tile, more walks than the card has SMs, gaps across
    many tiles, and tiles thinner or narrower than one 64 x 64 tile."""
    G, M, N, opened = TB_RANDOM[kind]
    _assert_wide_tb(card, *_random_bits(card, len(kind) + G, G, M, N,
                                        opened))


def _banded_case(seed, n_jobs, lo, hi):
    """Long pairs of a random sequence and a mutated copy (n <= m)."""
    rng = random.Random(seed)
    jobs = []
    for _ in range(n_jobs):
        base = _rand_seq(rng, lo, hi)
        other = _mutate(rng, base)
        a1, a2 = sorted((to_align(base), to_align(other)),
                        key=lambda a: -a.shape[1])
        jobs.append((a1, a2))
    M = gotoh_banded_cuda._bucket_m(max(a.shape[1] for a, _ in jobs))
    return [torch.from_numpy(x) for x in gotoh_banded_cuda.pack_jobs(jobs, M)]


@pytest.mark.cuda
@pytest.mark.parametrize("ac", ACS)
@pytest.mark.parametrize("band", gotoh_banded_cuda.BANDS)
@pytest.mark.parametrize("n_jobs,lo,hi", [(8, 200, 256), (2, 3000, 4000)])
def test_gotoh_banded_kernels_match_plain(card, ac, band, n_jobs, lo, hi):
    s1, s2, ml, nl = _banded_case(band + lo, n_jobs, lo, hi)
    args = (band, ac[0], ac[1], 5, -4, -10, -1)
    want_best, want_bits = gotoh_banded_cuda.banded_forward_plain(
        s1, s2, ml, nl, *args)
    want_codes, want_lens = gotoh_banded_cuda.banded_traceback_plain(
        want_bits, ml, nl)
    dev = [x.to(card) for x in (s1, s2, ml, nl)]
    dispatch.reset()
    best, bits = gotoh_banded_cuda.banded_forward(*dev, *args)
    codes, lens = gotoh_banded_cuda.banded_traceback(bits, dev[2], dev[3])
    torch.cuda.synchronize()
    assert dispatch.snapshot()["gotoh_banded"] == 1
    assert dispatch.snapshot()["gotoh_banded_tb"] == 1
    assert torch.equal(best.cpu(), want_best)
    assert torch.equal(lens.cpu(), want_lens)
    for g in range(len(ml)):
        m, k = int(ml[g]), int(lens[g])
        assert torch.equal(bits[g, :m].cpu(), want_bits[g, :m])
        assert torch.equal(codes[g, :k].cpu(), want_codes[g, :k])


def _assert_banded(card, s1, s2, ml, nl, args):
    """K3 and K3-tb on the card bit-equal to the plain versions: best,
    the bits of rows 1..m, lens and the codes."""
    want_best, want_bits = gotoh_banded_cuda.banded_forward_plain(
        s1, s2, ml, nl, *args)
    want_codes, want_lens = gotoh_banded_cuda.banded_traceback_plain(
        want_bits, ml, nl)
    dev = [x.to(card) for x in (s1, s2, ml, nl)]
    best, bits = gotoh_banded_cuda.banded_forward(*dev, *args)
    codes, lens = gotoh_banded_cuda.banded_traceback(bits, dev[2], dev[3])
    torch.cuda.synchronize()
    assert torch.equal(best.cpu(), want_best)
    assert torch.equal(lens.cpu(), want_lens)
    for g in range(len(ml)):
        m, k = int(ml[g]), int(lens[g])
        assert torch.equal(bits[g, :m].cpu(), want_bits[g, :m])
        assert torch.equal(codes[g, :k].cpu(), want_codes[g, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("band", [512, 2048])
def test_gotoh_banded_more_jobs_than_sms(card, band):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    _assert_banded(card, *_banded_case(band, sms + 21, 150, 256),
                   (band, True, True, 5, -4, -10, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("band", gotoh_banded_cuda.BANDS)
def test_gotoh_banded_n_one(card, band):
    """n = 1 against m of 1, a few hundred and a few thousand."""
    rng = random.Random(band)
    jobs = [(to_align(_rand_seq(rng, m, m)), to_align("ACGT"[m % 4]))
            for m in (1, 300, 4100)]
    packed = gotoh_banded_cuda.pack_jobs(jobs, 8192)
    for ac in ACS:
        _assert_banded(card, *(torch.from_numpy(x) for x in packed),
                       (band, *ac, 5, -4, -10, -1))


@pytest.mark.cuda
def test_gotoh_banded_m32768(card):
    """m = 32,768 at band 4,096, and n = 1 at the same M."""
    rng = random.Random(32768)
    base = _rand_seq(rng, 32768, 32768)
    jobs = [(to_align(base), to_align(_mutate(rng, base)[:32768])),
            (to_align(base), to_align("G"))]
    packed = gotoh_banded_cuda.pack_jobs(jobs, 32768)
    _assert_banded(card, *(torch.from_numpy(x) for x in packed),
                   (4096, True, True, 5, -4, -10, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2048, 4096])
def test_gotoh_banded_long_gaps(card, band):
    """Walks with vertical gaps of 600 rows and horizontal gaps of 400
    columns, across many of K3-tb's shared-memory windows."""
    rng = random.Random(band + 1)
    jobs = []
    for cut, ins in ((1000, 1600), (2200, 700)):
        base = _rand_seq(rng, 3000, 3000)
        other = (base[:cut] + base[cut + 600:ins] + _rand_seq(rng, 400, 400)
                 + base[ins:]) if ins > cut else (
            base[:ins] + _rand_seq(rng, 400, 400) + base[ins:cut]
            + base[cut + 600:])
        jobs.append((to_align(base), to_align(other)))
    packed = gotoh_banded_cuda.pack_jobs(jobs, 4096)
    for ac in ACS:
        _assert_banded(card, *(torch.from_numpy(x) for x in packed),
                       (band, *ac, 5, -4, -10, -1))


@pytest.mark.cuda
def test_gotoh_banded_batch_mixes_bands_on_card(card, monkeypatch):
    """One gotoh_banded_batch call with a band per job (three bands, a
    swapped job): one K3 and one K3-tb launch per band, each job equal
    to the host corridor at its band."""
    from delly_tpu_torch.ops.gotoh_banded import gotoh_banded_host
    from delly_tpu_torch.utils import torchenv

    rng = random.Random(17)
    jobs, bands = [], []
    for k, band in enumerate((512, 1024, 2048, 1024, 512)):
        base = _rand_seq(rng, 1500, 2500)
        other = _mutate(rng, base)
        jobs.append((other, base) if k == 3 else (base, other))
        bands.append(band)
    monkeypatch.setenv(torchenv.ENV, "cuda")
    torchenv.reset()
    try:
        dispatch.reset()
        got = gotoh_banded_cuda.gotoh_banded_batch(jobs, ac=(True, True),
                                                   band=bands)
    finally:
        torchenv.reset()
    counts = dispatch.snapshot()
    buckets = {(band, gotoh_banded_cuda._bucket_m(max(len(x), len(y))))
               for (x, y), band in zip(jobs, bands)}
    assert counts["host_routes"] == 0
    assert counts["gotoh_banded"] == counts["gotoh_banded_tb"] == len(
        buckets)
    for (x, y), band, (s, mg) in zip(jobs, bands, got):
        a1, a2 = to_align(x), to_align(y)
        if a2.shape[1] > a1.shape[1]:
            hs, hm = gotoh_banded_host(a2, a1, ac=(True, True), band=band)
            hm = np.concatenate([hm[1:], hm[:1]], axis=0)
        else:
            hs, hm = gotoh_banded_host(a1, a2, ac=(True, True), band=band)
        assert s == hs
        np.testing.assert_array_equal(mg, hm)


@pytest.mark.cuda
def test_gotoh_banded_batch_on_card_matches_host(card, monkeypatch):
    """gotoh_banded_batch on the card, swapped jobs and n = 1 included,
    equals the host corridor per job."""
    from delly_tpu_torch.ops.gotoh_banded import gotoh_banded_host
    from delly_tpu_torch.utils import torchenv

    rng = random.Random(9)
    base = _rand_seq(rng, 1500, 2000)
    other = _mutate(rng, base)
    jobs = [(base, other), (other, base), (base, "A"), ("C", base)]
    monkeypatch.setenv(torchenv.ENV, "cuda")
    torchenv.reset()
    try:
        dispatch.reset()
        got = gotoh_banded_cuda.gotoh_banded_batch(jobs, ac=(True, True),
                                                   band=1024)
    finally:
        torchenv.reset()
    assert dispatch.snapshot()["host_routes"] == 0
    for (x, y), (s, mg) in zip(jobs, got):
        a1, a2 = to_align(x), to_align(y)
        if a2.shape[1] > a1.shape[1]:
            hs, hm = gotoh_banded_host(a2, a1, ac=(True, True), band=1024)
            hm = np.concatenate([hm[1:], hm[:1]], axis=0)
        else:
            hs, hm = gotoh_banded_host(a1, a2, ac=(True, True), band=1024)
        assert s == hs
        np.testing.assert_array_equal(mg, hm)


@pytest.mark.cuda
def test_gotoh_batch_on_card_matches_host(card, monkeypatch):
    """gotoh_batch on the card equals the host oracle per job."""
    from delly_tpu_torch.utils import torchenv

    monkeypatch.setenv(torchenv.ENV, "cuda")
    torchenv.reset()
    rng = random.Random(3)
    jobs = [(_rand_seq(rng, 1, 300), _rand_seq(rng, 1, 300))
            for _ in range(20)]
    try:
        got = gotoh_cuda.gotoh_batch(jobs, ac=(True, True))
    finally:
        torchenv.reset()
    for (a1, a2), (s, mg) in zip(jobs, got):
        hs, hm = gotoh(a1, a2, ac=(True, True))
        assert s == hs
        np.testing.assert_array_equal(mg, hm)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["edist", "gotoh_msa", "gotoh_banded",
                                    "gotoh_wide", "cnv_depth"])
def test_mesh_over_every_card_matches_one_device(card, monkeypatch, engine):
    """Each kernel's job batch split over a mesh of every visible card
    (parallel/dispatch.py) equals the run without a mesh, and every card
    ran a chunk. A mesh of one card runs the split on that card."""
    from delly_tpu_torch.ops.depth_math import window_depth
    from delly_tpu_torch.ops.edist import batched_edit_distance
    from delly_tpu_torch.parallel.depth_step import depth_windows_on_mesh
    from delly_tpu_torch.parallel.mesh import make_mesh
    from delly_tpu_torch.utils import torchenv

    monkeypatch.setenv(torchenv.ENV, "cuda")
    torchenv.reset()
    mesh = make_mesh()
    ndev = int(mesh.devices.size)
    rng = np.random.default_rng(29)
    prng = random.Random(29)
    n = 7 * ndev + 2
    if engine == "edist":
        q, ql, t, tl, _lut = (x.numpy() for x in
                              _myers_case(29, n, 200, 300, 4))
        run = lambda: batched_edit_distance(q, ql, t, tl, 1)  # noqa: E731
    elif engine == "gotoh_msa":
        jobs = [(_rand_seq(prng, 1, 300), _rand_seq(prng, 1, 300))
                for _ in range(n)]
        run = lambda: gotoh_cuda.gotoh_batch(jobs, ac=(True, False))  # noqa
    elif engine == "gotoh_banded":
        jobs = [(_rand_seq(prng, 1, 3000), _rand_seq(prng, 1, 2800))
                for _ in range(n)]
        run = lambda: gotoh_banded_cuda.gotoh_banded_batch(  # noqa: E731
            jobs, ac=(True, True), band=1024)
    elif engine == "gotoh_wide":
        jobs = [(_rand_seq(prng, 1, 600), _rand_seq(prng, 4097, 5000))
                for _ in range(n)]
        run = lambda: gotoh_cuda.gotoh_batch(jobs, ac=(True, True))  # noqa
    else:
        covsum = np.floor(rng.gamma(20.0, 8.0, size=50_000 + n))
        expcov = rng.gamma(20.0, 8.0, size=covsum.size)
        ok = rng.random(covsum.size) > 0.1
        want = window_depth(np, covsum, np.where(ok, expcov, 0.0),
                            2.0, 0.9, 2.0, 2.0)
    try:
        dispatch.reset()
        if engine == "cnv_depth":
            cn, logr, tot = depth_windows_on_mesh(mesh, covsum, expcov, ok,
                                                  2.0, 0.9, 2.0, 2.0)
            got = (cn, logr)
            assert tot == (int(ok.sum()), float(covsum[ok].sum()))
        else:
            want = run()
            with dispatch.use_mesh(mesh):
                got = run()
        hits = dispatch.device_snapshot()
    finally:
        torchenv.reset()
    assert sorted(hits) == list(range(ndev))
    assert all(hits[p].get(engine, 0) > 0 for p in range(ndev))
    if engine == "edist":
        np.testing.assert_array_equal(got, want)
    elif engine == "cnv_depth":
        # the coverage file prints these with %g (native.cov_rows)
        for g, w in zip(got, want):
            assert [f"{x:g}" for x in g] == [f"{x:g}" for x in w]
    else:
        for (s1, m1), (s2, m2) in zip(want, got):
            assert s1 == s2
            np.testing.assert_array_equal(m1, m2)


def _lcs_batch(seed, lengths, letters=b"ACGT"):
    """A padded (a, alens, b, blens) batch of the given (m, n) lengths:
    every other b a mutated copy of its a (5% substitutions), the rest
    unrelated; padding bytes 0."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(letters, dtype=np.uint8)
    nb = len(lengths)
    mcap = max(1, max(m for m, _ in lengths))
    ncap = max(1, max(n for _, n in lengths))
    a = np.zeros((nb, mcap), dtype=np.uint8)
    b = np.zeros((nb, ncap), dtype=np.uint8)
    for i, (m, n) in enumerate(lengths):
        base = alpha[rng.integers(0, len(alpha), max(m, n))]
        a[i, :m] = base[:m]
        if i % 2 == 0:
            y = base[:n].copy()
            hit = rng.random(n) < 0.05
            y[hit] = alpha[rng.integers(0, len(alpha), int(hit.sum()))]
        else:
            y = alpha[rng.integers(0, len(alpha), n)]
        b[i, :n] = y
    al = np.array([m for m, _ in lengths], dtype=np.int32)
    bl = np.array([n for _, n in lengths], dtype=np.int32)
    return a, al, b, bl


LCS_EDGES = (0, 1, 63, 64, 65, 127, 128, 129)
LCS_CASES = {
    # every pair of lengths at a word's edges, empty strings included
    "edges": ([(m, n) for m in LCS_EDGES for n in LCS_EDGES], b"ACGT"),
    "N letters": ([(150, 150)] * 40 + [(129, 65), (65, 129)], b"ACGTN"),
    # deepgeno's split reads
    "deepgeno ~150 b": ([(140 + i % 21, 150 - i % 17) for i in range(2000)],
                        b"ACGT"),
    # b of 32, 64 and 128 words beside short pairs
    "2 kb": ([(300, 2048)] * 20 + [(300, 2000)] * 5, b"ACGT"),
    "4 kb": ([(300, 4096)] * 20 + [(64, 100)] * 5, b"ACGT"),
    "8 kb": ([(300, 8192)] * 20 + [(0, 8000)] * 5, b"ACGT"),
    # long-split: ~12 kb split reads beside short ones in one batch
    "long-split mix": ([(12_000 + 37 * i, 12_300 - 29 * i) for i in range(8)]
                       + [(150, 140), (140, 151)] * 4, b"ACGTN"),
    # b of more than 16,384 bases beside shorter pairs
    "16 kb and more": ([(400, 20_000), (400, 16_384), (400, 16_385),
                        (300, 17_000), (200, 100)] * 4, b"ACGT"),
    "40 kb": ([(300, 40_000), (300, 33_000), (250, 5000)] * 3, b"ACGT"),
    # 200 letters, each with its match masks
    "many letters": ([(300, 12_000)] * 6 + [(200, 190)] * 4,
                     bytes(range(20, 220))),
    # long-split's 96-pair mix: without the schedule a warp would hold
    # ~12 kb pairs beside ~150 b ones
    "long-split 96 mix": ([(11_800 + 13 * i, 12_300 - 11 * i)
                           for i in range(48)]
                          + [(150 - i % 9, 140 + i % 13) for i in range(48)],
                          b"ACGTN"),
    # b at each layout's edge: G x K x 64 bases and one more or less
    "layout edges": ([(90 + w % 50, 64 * w + d) for w in
                      (1, 2, 3, 4, 8, 16, 32, 64, 128, 192, 256)
                      for d in (-1, 0, 1)], b"ACGT"),
    # 200 letters at 12 kb in a batch of one layout: the masks of a warp
    # (200 x 6 words x 32 lanes) past shared memory
    "200 letters at 12 kb": ([(400, 12_000 - 7 * i) for i in range(8)],
                             bytes(range(20, 220))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LCS_CASES))
def test_lcs_kernel_matches_plain(card, case):
    """X1 (csrc/lcs.cu) against lcs_plain on the card, exact, from
    empty strings and word edges to b of 40,000 bases and 200 letters;
    one launch per call."""
    lengths, letters = LCS_CASES[case]
    a, al, b, bl = _lcs_batch(len(case), lengths, letters)
    lut, nalpha = letter_lut(b, bl)
    args = [torch.from_numpy(x).to(card) for x in (a, al, b, bl, lut)]
    want = lcs_plain(*args[:4])
    dispatch.reset()
    got = lcs(*args, nalpha)
    torch.cuda.synchronize()
    assert dispatch.snapshot()["lcs"] == 1
    assert got.dtype == torch.int32
    assert torch.equal(got.long().cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LCS_CASES))
def test_lcs_kernel_scheduled_matches_plain(card, case):
    """X1 with the host's lengths, so the launch groups the pairs by
    layout and length (lcs_cuda.schedule) and writes the lengths back in
    the caller's order; the batch once as given (the order uploaded) and
    once sorted (none), each equal to lcs_plain and one launch."""
    from delly_tpu_torch.ops.lcs_cuda import schedule

    lengths, letters = LCS_CASES[case]
    a, al, b, bl = _lcs_batch(len(case) + 7, lengths, letters)
    order, _segs = schedule(al, bl)
    lut, nalpha = letter_lut(b, bl)
    for perm in (np.arange(len(al)), order):
        host = [x[perm] for x in (a, al, b, bl)]
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(card)
                for x in (*host, lut)]
        want = lcs_plain(*args[:4])
        dispatch.reset()
        got = lcs(*args, nalpha, host_lengths=(host[1], host[3]))
        torch.cuda.synchronize()
        assert dispatch.snapshot()["lcs"] == 1
        assert torch.equal(got.long().cpu(), want.cpu())


@pytest.mark.cuda
def test_lcs_pairs_on_card_one_launch(card, monkeypatch):
    """lcs_pairs on the card: one X1 launch per call, the lengths those
    of the host's plain version."""
    from delly_tpu_torch.ops.msa import lcs_pairs
    from delly_tpu_torch.utils import torchenv

    rng = random.Random(3)
    pairs = [(_rand_seq(rng, 0, 300), _rand_seq(rng, 1, 320))
             for _ in range(200)] + [("", "ACGT"), ("ACGT", "")]
    monkeypatch.setenv(torchenv.ENV, "cpu")
    torchenv.reset()
    want = lcs_pairs(pairs)
    monkeypatch.setenv(torchenv.ENV, "cuda")
    torchenv.reset()
    try:
        dispatch.reset()
        got = lcs_pairs(pairs)
        assert dispatch.snapshot()["lcs"] == 1
    finally:
        torchenv.reset()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("purity", [1.0, 0.9])
def test_depth_windows_on_card_bit_equal_to_numpy(card, purity):
    """The CNV window math under a mesh of the card equals the numpy
    route without a mesh bit for bit, on 3.2 M seeded windows, half of
    them on a %g rounding boundary of their logR or cn: the card
    computes cn and the ratio, the host its log2."""
    from delly_tpu_torch.ops.depth_math import window_depth
    from delly_tpu_torch.parallel.depth_step import depth_windows_on_mesh
    from delly_tpu_torch.parallel.mesh import make_mesh

    covsum, expcov, ok = depth_windows(np.random.default_rng(41), 3_200_000)
    want_cn, want_logr = window_depth(np, covsum, np.where(ok, expcov, 0.0),
                                      2.0, purity, 2.0, 2.0)
    mesh = make_mesh(1, devices=[card])
    cn, logr, tot = depth_windows_on_mesh(mesh, covsum, expcov, ok, 2.0,
                                          purity, 2.0, 2.0)
    assert cn.tobytes() == want_cn.tobytes()
    assert logr.tobytes() == want_logr.tobytes()
    assert tot == (int(ok.sum()), float(covsum[ok].sum()))


RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cudaLaunchCooperativeKernel")


@pytest.mark.cuda
def test_launch_records_lie_inside_their_launch_spans(card, tmp_path):
    """One clock for the port's host spans and the card's trace: traced
    around a burst of calls of the four kernels the benchmark's cells
    drive (K1 in both layouts, X1, K2, K2-tb), every runtime launch
    record of a port kernel lies inside a `<kernel>.launch` span of its
    own wrapper once the spans are mapped onto the trace's clock
    (utils/profiling.py), and each wrapper call holds one."""
    import json
    import re

    from torch.profiler import ProfilerActivity, profile

    from delly_tpu_torch.testing.trace_check import KERNEL_OF
    from delly_tpu_torch.utils import profiling

    short = [x.to(card) for x in _myers_case(1, 512, 60, 100, 4)]
    long = [x.to(card) for x in _myers_case(2, 64, 700, 900, 4)]
    rng = np.random.default_rng(3)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    a = letters[rng.integers(0, 4, size=(256, 100))]
    b = letters[rng.integers(0, 4, size=(256, 100))]
    lens = np.full(256, 100, dtype=np.int32)
    lut, nalpha = letter_lut(b, lens)
    x1 = [torch.from_numpy(x).to(card) for x in (a, lens, b, lens, lut)]
    k2 = [x.to(card) for x in _gotoh_case(9, 64, 60, 100, 1, 128)]

    def burst():
        myers(*short, 2)
        myers(*long, 0)
        lcs(*x1, nalpha, host_lengths=(lens, lens))
        _best, bits = gotoh_cuda.gotoh_forward(*k2, True, True, -10, -1)
        gotoh_cuda.gotoh_traceback(bits, k2[3], k2[4])

    burst()                      # the libraries loaded, the modules too
    torch.cuda.synchronize()
    reps = 200
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    profiling.on()
    try:
        for _ in range(reps):
            burst()
        torch.cuda.synchronize()
    finally:
        profiling.off()
        prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = profiling.take()
    assert spans["dropped"] == 0
    profiling.add_to_trace(path, spans)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernel_of = {}
    for e in events:
        if e.get("cat") == "kernel":
            m = re.search(r"::(\w+?)_kernel\b", e["name"])
            if m and m.group(1) in KERNEL_OF:
                kernel_of[e["args"]["correlation"]] = KERNEL_OF[m.group(1)]
    launch = {}
    for e in events:
        if e.get("cat") == "port" and e["name"].endswith(".launch"):
            launch.setdefault(e["name"][:-7], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert {k: len(v) for k, v in launch.items()} == {
        "myers": 2 * reps, "lcs": reps, "gotoh": reps, "gotoh_tb": reps}
    records = [(kernel_of[e["args"]["correlation"]], e["ts"],
                e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "cuda_runtime"
               and e["name"] in RUNTIME_LAUNCHES
               and e["args"].get("correlation") in kernel_of]
    assert len(records) == 5 * reps
    inside = sum(any(a <= t0 and t1 <= b for a, b in launch[k])
                 for k, t0, t1 in records)
    assert inside >= 0.99 * len(records), (inside, len(records))
