"""Longest common subsequence by the plain dynamic program.

L[i][j] = L[i-1][j-1] + 1 where a[i-1] == b[j-1], else the larger of
L[i-1][j] and L[i][j-1]; the in-row term is a running maximum. Reads
L[alen][blen]. Bytes compare exactly.
"""

from __future__ import annotations

import torch


def lcs_length(a, alens, b, blens):
    """(B,) int64 LCS lengths of a (B, M) uint8 and b (B, N) uint8 with
    lengths (B,) int."""
    dev = a.device
    B, M = a.shape
    N = b.shape[1]
    al = alens.to(torch.int64)
    bl = blens.to(torch.int64)
    L = torch.zeros(B, N + 1, dtype=torch.int64, device=dev)
    zero = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    bb = b.to(torch.int16)
    rows = int(al.max()) if B else 0
    for i in range(1, min(rows, M) + 1):
        eq = (a[:, i - 1:i].to(torch.int16) == bb).to(torch.int64)
        X = torch.maximum(L[:, :-1] + eq, L[:, 1:])
        Ln = torch.cat([zero, torch.cummax(X, dim=1).values], dim=1)
        L = torch.where((i <= al)[:, None], Ln, L)
    return L.gather(1, bl[:, None]).squeeze(1)
