"""Profile Gotoh with its walk, as delly's gotoh.h and align.h define it,
by the plain dynamic program over a batch of merges.

A merge aligns two alignments a1 (r1 rows x m columns) and a2 (r2 x n)
of bytes A, C, G, T, N and the gap '-'. Each side's profile counts, per
column, the letters A, C, G, T, N of the rows that cover it (a row of
several covers the columns from its first to its last non-gap byte; a
single row covers every column), and its depth, the covered bytes of
A, C, G, T, N and '-'. The column pair (i, j) scores
trunc(num / max(depth1_i x depth2_j, 1)), num the sum over letter pairs
of count1 x count2 x (match if the letters agree, else mismatch), in
exact integers.

S, H and V are the best scores ending in a match, a horizontal gap and
a vertical gap; end gaps are free on the sides that `hfree` (the first
and last rows) and `vfree` (the first and last columns) name. The walk
goes back from (m, n) with delly's preference (a horizontal gap, then
a vertical one, then the diagonal) and its gap-open tests, and emits
codes 0 (diagonal), 1 (horizontal) and 2 (vertical) in walk order.

`band` confines the program to the cells with |j - i| <= band (the
others -inf): a banded profile alignment, the approximate control that
the comparison has to fail.
"""

from __future__ import annotations

import torch

INF = 1_000_000
GAP = ord("-")
_LETTERS = b"ACGTN-"


def profiles(a, rows, cols):
    """(counts (G, L, 5) int64 of A, C, G, T, N, depth (G, L) int64) of
    alignments a (G, R, L) uint8, `rows` and `cols` (G,) each merge's
    own extent; columns past `cols` count nothing."""
    dev = a.device
    G, R, L = a.shape
    code = torch.full((256,), -1, dtype=torch.int64, device=dev)
    for k, ch in enumerate(_LETTERS):
        code[ch] = k
        code[ord(chr(ch).lower())] = k
    cls = code[a.to(torch.int64)]
    col = torch.arange(L, device=dev)
    live = ((torch.arange(R, device=dev)[None, :, None] < rows[:, None, None])
            & (col[None, None, :] < cols[:, None, None]))
    nongap = (a != GAP) & live
    anyng = nongap.any(2)
    first = torch.where(anyng, nongap.to(torch.int32).argmax(2), 0)
    last = torch.where(anyng, L - 1 - nongap.flip(2).to(torch.int32).argmax(2),
                       L - 1)
    covered = ((col[None, None, :] >= first[:, :, None])
               & (col[None, None, :] <= last[:, :, None]))
    single = (rows == 1)[:, None, None]
    covered = torch.where(single, torch.ones_like(covered), covered) & live
    counts = torch.stack([((cls == k) & covered).sum(1) for k in range(5)],
                         dim=2)
    depth = ((cls >= 0) & covered).sum(1)
    return counts, depth


def scores(c1, d1, c2, d2, match: int, mismatch: int):
    """(G, m, n) int64 column-pair scores."""
    w = torch.full((5, 5), mismatch, dtype=torch.float64, device=c1.device)
    w.fill_diagonal_(match)
    num = torch.matmul(torch.matmul(c1.to(torch.float64), w),
                       c2.to(torch.float64).transpose(1, 2))
    den = torch.clamp(d1[:, :, None] * d2[:, None, :], min=1)
    num = num.round().to(torch.int64)
    q = torch.div(num.abs(), den, rounding_mode="floor")
    return torch.where(num < 0, -q, q)


def forward(score, mlen, nlen, hfree: bool, vfree: bool, go: int, ge: int,
            band: int | None = None):
    """S, H, V (G, M + 1, N + 1) int64 of the batch, each merge's DP in
    the corner of its own (mlen + 1) x (nlen + 1) cells."""
    dev = score.device
    G, M, N = score.shape
    ml = mlen.to(torch.int64)
    nl = nlen.to(torch.int64)
    c = torch.arange(N + 1, device=dev, dtype=torch.int64)
    free_c = vfree & ((c[None, :] == 0) | (c[None, :] == nl[:, None]))
    vg_open = torch.where(free_c, 0, go + ge)
    vg_ext = torch.where(free_c, 0, ge)
    S = torch.empty(G, M + 1, N + 1, dtype=torch.int64, device=dev)
    H = torch.empty_like(S)
    V = torch.empty_like(S)
    S[:, 0] = 0 if hfree else go + c * ge
    S[:, 0, 0] = 0
    H[:, 0] = S[:, 0]
    H[:, 0, 0] = -INF
    V[:, 0] = -INF
    for r in range(1, M + 1):
        s0 = 0 if vfree else go + r * ge
        last = hfree & (ml == r)
        O = torch.where(last, 0, go + ge)[:, None]
        E = torch.where(last, 0, ge)[:, None]
        Vr = torch.maximum(S[:, r - 1, 1:] + vg_open[:, 1:],
                           V[:, r - 1, 1:] + vg_ext[:, 1:])
        t = torch.maximum(S[:, r - 1, :-1] + score[:, r - 1], Vr)
        tfull = torch.cat([torch.full((G, 1), s0, dtype=torch.int64,
                                      device=dev), t], dim=1)
        # H[c] = max over k < c of tfull[k] + O + (c - 1 - k) E
        z = torch.cummax(tfull[:, :-1] - c[None, :-1] * E, dim=1).values
        Hr = z + (c[None, 1:] - 1) * E + O
        Sr = torch.maximum(t, Hr)
        if band is not None:
            out = (c[None, 1:] - r).abs() > band
            Sr, Hr, Vr = (torch.where(out, -INF, x) for x in (Sr, Hr, Vr))
        S[:, r, 0] = s0
        S[:, r, 1:] = Sr
        H[:, r, 0] = -INF
        H[:, r, 1:] = Hr
        V[:, r, 0] = s0
        V[:, r, 1:] = Vr
    V[:, 0, 0] = -INF
    return S, H, V


def walk(S, H, V, mlen, nlen, hfree: bool, vfree: bool, ge: int):
    """(codes (G, M + N) uint8 in walk order, lens (G,) int64)."""
    dev = S.device
    G, M1, N1 = S.shape
    L = M1 + N1 - 2
    ml = mlen.to(torch.int64)
    nl = nlen.to(torch.int64)
    row, col = ml.clone(), nl.clone()
    last = torch.zeros(G, dtype=torch.int64, device=dev)  # 0 s, 1 h, 2 v
    lens = torch.zeros(G, dtype=torch.int64, device=dev)
    codes = torch.zeros(G, L + 1, dtype=torch.int64, device=dev)
    flat = N1
    Sf, Hf, Vf = (x.reshape(G, -1) for x in (S, H, V))

    def at(x, r, c):
        return x.gather(1, (r * flat + c).clamp(min=0)[:, None]).squeeze(1)

    for _ in range(2 * L + 2):
        alive = (row > 0) | (col > 0)
        if not bool(alive.any()):
            break
        s_here = at(Sf, row, col)
        go_h = ((row == 0) & (col > 0)) | (
            (row > 0) & (col > 0) & (s_here == at(Hf, row, col)))
        go_v = ~go_h & (((col == 0) & (row > 0)) | (
            (row > 0) & (col > 0) & (s_here == at(Vf, row, col))))
        is_s, is_h, is_v = last == 0, last == 1, last == 2
        diag = is_s & ~go_h & ~go_v
        ext_h = torch.where(hfree & ((row == 0) | (row == ml)), 0, ge)
        h_open = torch.where(row == 0, col == 1,
                             at(Hf, row, col) != at(Hf, row, col - 1) + ext_h)
        ext_v = torch.where(vfree & ((col == 0) | (col == nl)), 0, ge)
        v_open = torch.where(col == 0, row == 1,
                             at(Vf, row, col)
                             != at(Vf, row - 1, col) + ext_v)
        emit = alive & (diag | is_h | is_v)
        code = torch.where(diag, 0, torch.where(is_h, 1, 2))
        codes.scatter_(1, torch.where(emit, lens, L)[:, None],
                       code[:, None])
        new_last = torch.where(
            is_s, torch.where(go_h, 1, torch.where(go_v, 2, 0)),
            torch.where(is_h, torch.where(h_open, 0, 1),
                        torch.where(v_open, 0, 2)))
        row = row - (alive & (diag | is_v)).to(torch.int64)
        col = col - (alive & (diag | is_h)).to(torch.int64)
        last = torch.where(alive, new_last, last)
        lens = lens + emit.to(torch.int64)
    return codes[:, :L].to(torch.uint8), lens


def merge(a1, r1, m, a2, r2, n, hfree=True, vfree=True, match=5,
          mismatch=-4, go=-10, ge=-1, band=None):
    """(best (G,) int64, codes (G, M + N) uint8, lens (G,) int64) of a
    batch of merges: a1 (G, R1, M) and a2 (G, R2, N) uint8 alignments,
    r1, m, r2, n (G,) each merge's rows and columns."""
    c1, d1 = profiles(a1, r1, m)
    c2, d2 = profiles(a2, r2, n)
    sc = scores(c1, d1, c2, d2, match, mismatch)
    S, H, V = forward(sc, m, n, hfree, vfree, go, ge, band)
    G = S.shape[0]
    idx = (m.to(torch.int64) * S.shape[2] + n.to(torch.int64))[:, None]
    best = S.reshape(G, -1).gather(1, idx).squeeze(1)
    codes, lens = walk(S, H, V, m, n, hfree, vfree, ge)
    return best, codes, lens
