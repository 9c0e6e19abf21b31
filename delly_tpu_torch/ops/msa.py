"""Multiple sequence alignment for split-read consensus (sr engine).

Reference: src/msa.h — LCS similarity matrix, UPGMA guide tree, progressive
profile alignment with end-free Gotoh, coverage-gated column consensus.
"""

from __future__ import annotations

import numpy as np

from delly_tpu_torch.ops.gotoh import GAP, DnaScore, gotoh
from delly_tpu_torch.parallel import dispatch
from delly_tpu_torch.utils import profiling

# host spans of lcs_pairs (utils/profiling.py): the call and its phases
_CALL, _PACK, _H2D, _D2H = profiling.entry_spans("lcs_pairs")


def lcs_plain(a, alens, b, blens):
    """Batched LCS lengths on torch tensors (counterpart of the JAX
    package's _lcs_device_fn, msa.py:39-66), the plain version of X1
    (ops/lcs_cuda.py): a loop over the rows of a, each row elementwise
    over the columns of b plus a prefix max (torch.cummax), vectorized
    over the batch. a (B, M) and b (B, N) uint8, lengths (B,) int32;
    returns (B,) int64."""
    import torch

    B, M = a.shape
    N = b.shape[1]
    dev = a.device
    al = alens.to(torch.int64)
    bl = blens.to(torch.int64)
    colmask = (torch.arange(1, N + 1, device=dev)[None, :] <= bl[:, None])
    row = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for i in range(1, M + 1):
        eq = ((a[:, i - 1:i] == b) & colmask).to(torch.int64)
        cand = torch.maximum(row[:, :-1] + eq, row[:, 1:])
        cur = torch.cat([zero, torch.cummax(cand, dim=1).values], dim=1)
        row = torch.where((i <= al)[:, None], cur, row)
    return row.gather(1, bl[:, None]).squeeze(1)


def lcs_pairs(pairs: list) -> np.ndarray:
    """Batched LCS lengths for (a, b) string pairs: one padded batch on
    the run's device (utils.torchenv.device()), with no size gate, in
    one call of ops/lcs_cuda.lcs (on the card one launch of X1,
    csrc/lcs.cu). The batch is packed in the kernel's order
    (lcs_cuda.schedule) and the lengths go back in the pairs' order. Not
    split over a mesh, as the JAX package's is not. Used for the MSA
    similarity matrix (reference HOT LOOP 3 feeder, msa.h:10-44)."""
    if not pairs:
        return np.zeros(0, dtype=np.int64)
    import torch

    from delly_tpu_torch.ops.lcs_cuda import lcs, letter_lut, schedule
    from delly_tpu_torch.utils import torchenv
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        xs = [x.encode() for x, _ in pairs]
        ys = [y.encode() for _, y in pairs]
        order, _ = schedule([len(x) for x in xs], [len(y) for y in ys])
        nb = len(pairs)
        m = max(1, max(len(x) for x in xs))
        n = max(1, max(len(y) for y in ys))
        a = np.zeros((nb, m), dtype=np.uint8)
        b = np.zeros((nb, n), dtype=np.uint8)
        al = np.zeros(nb, dtype=np.int32)
        bl = np.zeros(nb, dtype=np.int32)
        for i, k in enumerate(order):
            a[i, :len(xs[k])] = np.frombuffer(xs[k], dtype=np.uint8)
            b[i, :len(ys[k])] = np.frombuffer(ys[k], dtype=np.uint8)
            al[i] = len(xs[k])
            bl[i] = len(ys[k])
        lut, nalpha = letter_lut(b, bl)
        dev = torchenv.device()
        if s:
            s = profiling.mark(_PACK, s)
        args = [torch.from_numpy(x).to(dev) for x in (a, al, b, bl, lut)]
        if s:
            profiling.mark(_H2D, s)
        got = lcs(*args, nalpha, host_lengths=(al, bl))
        s = profiling.now() if s0 else 0
        out = np.empty(nb, dtype=np.int64)
        out[order] = got.cpu().numpy()
        if s:
            profiling.mark(_D2H, s)
        return out
    finally:
        if s0:
            profiling.mark(_CALL, s0)


def distance_matrix(seqs: list) -> np.ndarray:
    """Similarity percent matrix (msa.h:32-44); the all-pairs LCS runs
    as one batched device call."""
    num = len(seqs)
    d = np.full((2 * num + 1, 2 * num + 1), -1, dtype=np.int64)
    idx = [(i, j) for i in range(num) for j in range(i + 1, num)]
    if not idx:
        return d
    ls = lcs_pairs([(seqs[i], seqs[j]) for i, j in idx])
    for k, (i, j) in enumerate(idx):
        d[i][j] = (int(ls[k]) * 100) // min(len(seqs[i]), len(seqs[j]))
    return d


def upgma(d: np.ndarray, num: int):
    """Guide tree (msa.h:46-89). Returns (root, phylogeny array)."""
    p = np.full((2 * num + 1, 3), -1, dtype=np.int64)
    nn = num
    while nn < 2 * num + 1:
        # closestPair: first maximum in row-major order, strict >
        sub = d[:nn, :nn]
        dmax = sub.max() if nn > 0 else -1
        if dmax == -1:
            break
        flat = int(np.argmax(sub))
        di, dj = divmod(flat, nn)
        p[di][0] = nn
        p[dj][0] = nn
        p[nn][1] = di
        p[nn][2] = dj
        # updateDistanceMatrix (msa.h:62-72)
        for i in range(nn):
            if p[i][0] == -1:
                a = int(d[di][i] if di < i else d[i][di])
                b = int(d[dj][i] if dj < i else d[i][dj])
                q = a + b
                # C++ integer division truncates toward zero.
                d[i][nn] = q // 2 if q >= 0 else -((-q) // 2)
        d[:di, di] = -1
        d[di, di + 1 : nn + 1] = -1
        d[:dj, dj] = -1
        d[dj, dj + 1 : nn + 1] = -1
        nn += 1
    return (nn - 1 if nn > 0 else 0), p


_BANDED_MIN_DIM = 8192


def _long_pair(a1, a2) -> bool:
    """Sequence-vs-sequence merges beyond _BANDED_MIN_DIM take the
    corridor DP, O(m*band) instead of O(m*n), on the kernels K3 and
    K3-tb (ops/gotoh_banded_cuda); the reference's consensus windows
    never reach this size. `sr` meets them when its split reads are
    longer than 8,192 bases."""
    return (a1.shape[0] == 1 and a2.shape[0] == 1
            and max(a1.shape[1], a2.shape[1]) > _BANDED_MIN_DIM
            and min(a1.shape[1], a2.shape[1]) >= 1)


def _gotoh_dispatch(a1, a2, ac, sc):
    """One merge: a batch of one."""
    return _gotoh_dispatch_batch([(a1, a2)], ac, sc)[0]


def _corridor_band(a1, a2):
    """The corridor width of a long pair, from its Myers edit distance
    d: the least power of two from 512 up that holds 2 * (d + 8) + 256,
    or None when d is unknown (no native library) or the band would be
    wider than 4,096."""
    from delly_tpu_torch import native
    sc_d = native.edist_scan(a1[0].tobytes(), a2[0].tobytes(), 0, None)
    if sc_d is None:
        return None
    d = sc_d[0]
    band = 512
    while band < 2 * (d + 8) + 256:
        band *= 2
    return band if band <= 4096 else None


def _banded_or_full(pairs: list, ac, sc) -> list:
    """Long-context sequence merges: corridor Gotoh with a band sized
    from the Myers edit distance, all of a round's pairs in one
    gotoh_banded_batch call (its buckets by band, M and end-gap config
    run on the card at once), validated by checking the traceback never
    rides an interior corridor edge; any doubt falls back to the exact
    full DP on the host, counted as a host route."""
    from delly_tpu_torch.ops.gotoh_banded_cuda import gotoh_banded_batch
    out = [None] * len(pairs)
    ks, bands = [], []
    for k, (a1, a2) in enumerate(pairs):
        band = _corridor_band(a1, a2)
        if band is None:
            dispatch.count("host_routes")
            out[k] = gotoh(a1, a2, ac=ac, sc=sc)
        else:
            ks.append(k)
            bands.append(band)
    res = gotoh_banded_batch([pairs[k] for k in ks], ac=ac, sc=sc,
                             band=bands) if ks else []
    for k, band, (best, merged) in zip(ks, bands, res):
        a1, a2 = pairs[k]
        if _trace_touches_edge(merged, a1.shape[1], a2.shape[1], band):
            dispatch.count("host_routes")
            out[k] = gotoh(a1, a2, ac=ac, sc=sc)
        else:
            out[k] = (best, merged)
    return out


def _trace_touches_edge(merged, m, n, band):
    """True when the alignment path comes within 2 slots of an
    interior corridor edge (matrix boundaries do not count)."""
    from delly_tpu_torch.ops.gotoh import GAP
    from delly_tpu_torch.ops.gotoh_banded import corridor_offsets
    swap = n > m
    mm, nn = (n, m) if swap else (m, n)
    off = corridor_offsets(mm, nn, band)
    r1 = merged[0] != GAP      # consumes a1
    r2 = merged[1] != GAP      # consumes a2
    ia = np.cumsum(r1)
    ja = np.cumsum(r2)
    i_band = ja if swap else ia
    j_band = ia if swap else ja
    slot = j_band - off[i_band]
    left_interior = off[i_band] > 0
    right_interior = off[i_band] + band - 1 < nn
    touch = ((slot <= 1) & left_interior) \
        | ((slot >= band - 2) & right_interior)
    return bool(touch.any())


def palign(seqs: list, p: np.ndarray, root: int, sc: DnaScore) -> np.ndarray:
    """Progressive alignment (msa.h:91-109)."""
    if p[root][1] == -1 and p[root][2] == -1:
        s = seqs[root]
        return np.frombuffer(s.encode(), dtype=np.uint8)[None, :].copy()
    a1 = palign(seqs, p, int(p[root][1]), sc)
    a2 = palign(seqs, p, int(p[root][2]), sc)
    _, merged = _gotoh_dispatch(a1, a2, (True, True), sc)
    return merged


def consensus(align: np.ndarray, min_clique_size: int) -> str:
    """Coverage-gated column consensus (msa.h:111-173)."""
    nrows, ncols = align.shape
    nongap = align != GAP
    first = np.where(nongap.any(axis=1), nongap.argmax(axis=1), ncols)
    rev_last = nongap[:, ::-1].argmax(axis=1)
    last = np.where(nongap.any(axis=1), ncols - 1 - rev_last, -1)
    col = np.arange(ncols)
    fl = (first[:, None] <= col[None, :]) & (col[None, :] <= last[:, None])
    cov = fl.sum(axis=0)
    cov_threshold = max(2, min(min_clique_size, nrows))
    out = []
    # counts per column: A C G T other
    upper = np.char.upper(
        np.frombuffer(align.tobytes(), dtype="S1").reshape(align.shape))
    counts = np.zeros((5, ncols), dtype=np.int32)
    for k, ch in enumerate(b"ACGT"):
        counts[k] = ((upper == bytes([ch])) & fl).sum(axis=0)
    counts[4] = fl.sum(axis=0) - counts[:4].sum(axis=0)
    for j in range(ncols):
        if cov[j] >= cov_threshold:
            max_idx = int(np.argmax(counts[:, j]))  # first max (ties)
            if max_idx < 4:
                out.append("ACGT"[max_idx])
    return "".join(out)


def msa(seqs: list, min_clique_size: int, sc: DnaScore | None = None,
        d: np.ndarray | None = None):
    """msa.h:185-239. Returns (support, consensus string). `d` lets a
    caller supply the similarity matrix from a cross-SV batched LCS
    pass (distance_matrix_from_lcs)."""
    sc = sc or DnaScore()
    num = len(seqs)
    if d is None:
        d = distance_matrix(seqs)
    root, p = upgma(d, num)
    align = palign(seqs, p, int(root), sc)
    cs = consensus(align, min_clique_size)
    return align.shape[0], cs


def distance_matrix_from_lcs(seqs: list, ls) -> np.ndarray:
    """Similarity matrix from precomputed LCS lengths for the i<j pair
    list in row-major order (msa.h:32-44)."""
    num = len(seqs)
    d = np.full((2 * num + 1, 2 * num + 1), -1, dtype=np.int64)
    k = 0
    for i in range(num):
        for j in range(i + 1, num):
            d[i][j] = (int(ls[k]) * 100) // min(len(seqs[i]),
                                                len(seqs[j]))
            k += 1
    return d


def _gotoh_dispatch_batch(pairs: list, ac, sc):
    """Batched merge dispatch: the long sequence pairs of the round go
    to the corridor kernels K3/K3-tb together (_banded_or_full), every
    other merge through one gotoh_batch call: K2 with K2-tb for the
    traceback up to 4,096 columns, K4 with K4-tb up to 16,384
    (ops/gotoh_wide_cuda.py), the host DP only past that width or for
    lowercase letters or a count product that breaks the exact profile
    arithmetic (one host route each)."""
    out = [None] * len(pairs)
    groups = ([], [])
    for k, (a1, a2) in enumerate(pairs):
        groups[_long_pair(a1, a2)].append(k)
    short, long_ = groups
    if long_:
        for k, res in zip(long_, _banded_or_full(
                [pairs[k] for k in long_], ac, sc)):
            out[k] = res
    if short:
        from delly_tpu_torch.ops.gotoh_cuda import gotoh_batch
        for k, res in zip(short, gotoh_batch([pairs[k] for k in short],
                                             ac=ac, sc=sc)):
            out[k] = res
    return out


def msa_batch(items: list, min_clique_size: int,
              sc: DnaScore | None = None) -> list:
    """Lockstep MSA across SVs: same per-item results as msa(), but
    guide-tree merges at the same depth across ALL items run as one
    batched device Gotoh call (the reference runs one msa() per
    ThreadPool task instead, shortpe.h:174-201).

    items: list of (seqs, d) with d the similarity matrix (or None to
    compute it here). Returns [(support, consensus), ...].
    """
    sc = sc or DnaScore()
    out = [None] * len(items)
    trees = []
    levels = {}           # (item, node) -> depth
    rounds = {}           # depth -> [(item, node)]
    for ii, (seqs, d) in enumerate(items):
        num = len(seqs)
        if d is None:
            d = distance_matrix(seqs)
        root, p = upgma(d.copy(), num)  # upgma consumes its matrix
        trees.append((int(root), p))

        def walk(nd, _ii=ii, _p=p):
            c1, c2 = int(_p[nd][1]), int(_p[nd][2])
            if c1 == -1 and c2 == -1:
                levels[(_ii, nd)] = 0
                return 0
            lv = 1 + max(walk(c1), walk(c2))
            levels[(_ii, nd)] = lv
            rounds.setdefault(lv, []).append((_ii, nd))
            return lv

        walk(int(root))

    stores = [dict() for _ in items]

    def fetch(ii, nd):
        if nd < len(items[ii][0]):
            s = items[ii][0][nd]
            return np.frombuffer(s.encode(), dtype=np.uint8)[None, :].copy()
        return stores[ii].pop(nd)

    for lv in sorted(rounds):
        jobs = rounds[lv]
        pairs = []
        for ii, nd in jobs:
            p = trees[ii][1]
            pairs.append((fetch(ii, int(p[nd][1])),
                          fetch(ii, int(p[nd][2]))))
        merged = _gotoh_dispatch_batch(pairs, (True, True), sc)
        for (ii, nd), (_score, mg) in zip(jobs, merged):
            stores[ii][nd] = mg

    for ii, (root, _p) in enumerate(trees):
        align = fetch(ii, root)
        out[ii] = (align.shape[0], consensus(align, min_clique_size))
    return out
