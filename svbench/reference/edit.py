"""Edit distance by the plain dynamic program, row by row over a batch.

D[i][j] is the least number of substitutions, insertions and deletions
that turn the query's first i bytes into the target's first j bytes,
with the target's prefix free in HW mode (D[0][j] = 0) and charged in
NW mode (D[0][j] = j). NW reads D[qlen][tlen]; HW reads the least
D[qlen][j] over j <= tlen (edlib's infix mode, delly's HW). Bytes
compare exactly. The in-row term D[i][j-1] + 1 is a running minimum:
D[i][j] = j + min over k <= j of (X[k] - k), X the row's other terms.

`band` confines the program to the cells with |j - i| <= band: an
approximate distance, the control that the comparison has to fail.
"""

from __future__ import annotations

import torch

NW, HW = 0, 2
INF = 1 << 28


def edit_distance(q, qlens, t, tlens, mode: int, band: int | None = None):
    """(B,) int64 distances of q (B, M) uint8 against t (B, N) uint8,
    lengths (B,) int."""
    if mode not in (NW, HW):
        raise ValueError(f"edit_distance: mode {mode}")
    dev = q.device
    B, M = q.shape
    N = t.shape[1]
    ql = qlens.to(torch.int64)
    tl = tlens.to(torch.int64)
    j = torch.arange(N + 1, device=dev, dtype=torch.int64)
    D = (j.expand(B, N + 1) if mode == NW
         else torch.zeros(B, N + 1, dtype=torch.int64, device=dev)).clone()
    if band is not None:
        D = torch.where(j[None, :] > band, INF, D)
    tb = t.to(torch.int16)
    rows = int(ql.max()) if B else 0
    for i in range(1, min(rows, M) + 1):
        sub = (q[:, i - 1:i].to(torch.int16) != tb).to(torch.int64)
        X = torch.empty_like(D)
        X[:, 0] = i
        X[:, 1:] = torch.minimum(D[:, :-1] + sub, D[:, 1:] + 1)
        if band is not None:
            X = torch.where((j[None, :] - i).abs() > band, INF, X)
        Dn = torch.cummin(X - j, dim=1).values + j
        if band is not None:
            Dn = torch.where((j[None, :] - i).abs() > band, INF, Dn)
        D = torch.where((i <= ql)[:, None], Dn, D)
    if mode == NW:
        return D.gather(1, tl[:, None]).squeeze(1)
    return torch.where(j[None, :] <= tl[:, None], D, INF).min(1).values
