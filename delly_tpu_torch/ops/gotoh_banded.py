"""Banded (corridor) affine-gap Gotoh for long sequences, host side.

The host part of the JAX package's ops/gotoh_banded.py: the corridor
schedule, the numpy DP and its traceback. They are the oracle of the
kernels K3 and K3-tb (ops/gotoh_banded_cuda.py, which replaces the
Pallas kernel gotoh_banded.py:192 and its walk :342), and serve the
jobs those kernels do not take (longer than 32,768 columns, or letters
outside ACGTN-).

SURVEY §5 "long-context banded device DP": the full-matrix Pallas
kernel (ops/gotoh_pallas.py) serves dimensions up to MAX_K=4096; very
long consensus/reference alignments need O(m·band) work instead of
O(m·n). This module defines a corridor DP whose semantics are shared
bit-for-bit between the numpy oracle and the Pallas kernel:

- corridor: DP row r covers columns [off(r), off(r)+B), with
  off(r) = floor128(max(0, r*n//m - B//2)) — the 128-lane
  quantization makes consecutive-row shifts delta(r) in {0, 128},
  which the kernel resolves with two static lane shifts and an
  elementwise select (no per-sublane dynamic slicing);
- cells outside the corridor are -INF (unreachable); when the band
  covers the whole matrix the result equals the full Gotoh exactly
  (asserted by tests);
- scoring/boundaries/traceback mirror ops/gotoh.py (reference
  gotoh.h:71-174, align.h:45-73) restricted to the corridor; the
  per-row equality windows are gathered host-side so the kernel
  streams an (m x B) int8 tile and never performs dynamic slicing.

Requires n <= m (the batch wrapper transposes, swapping h/v trace
codes and the merged row order) and band >= 256.
"""

from __future__ import annotations

import numpy as np

from delly_tpu_torch.ops.gotoh import (
    DnaScore, INF, create_alignment_codes, to_align,
)

QUANT = 128
NINF = -INF


def corridor_offsets(m: int, n: int, band: int) -> np.ndarray:
    """off(r) for DP rows r = 0..m (host/kernel shared schedule)."""
    r = np.arange(m + 1, dtype=np.int64)
    raw = np.maximum(0, (r * n) // m - band // 2)
    return (raw - raw % QUANT).astype(np.int64)


def _seq_codes(a: np.ndarray) -> np.ndarray:
    return a[0]


def gotoh_banded_host(a1, a2, ac=(False, False),
                      sc: DnaScore | None = None, band: int = 512):
    """Corridor Gotoh on the host: O(m*band) memory/time. Single-row
    alignments only (sequence x sequence). Returns (score, merged)."""
    sc = sc or DnaScore()
    a1 = to_align(a1)
    a2 = to_align(a2)
    assert a1.shape[0] == 1 and a2.shape[0] == 1
    m, n = a1.shape[1], a2.shape[1]
    assert 1 <= n <= m and band >= 256
    s1, s2 = _seq_codes(a1), _seq_codes(a2)
    B = band
    off = corridor_offsets(m, n, B)
    GO, GE = sc.go, sc.ge
    hfree, vfree = bool(ac[0]), bool(ac[1])

    k = np.arange(B, dtype=np.int64)
    # rolling previous row for S/V (only r-1 is ever read); the bits
    # tile is the only O(m*band) state, as the traceback needs it
    bits = np.zeros((m + 1, B), dtype=np.uint8)

    col0 = off[0] + k            # off[0] == 0
    in0 = col0 <= n
    S_prev = np.where(in0, 0 if hfree else GO + col0 * GE,
                      np.int64(NINF))
    S_prev[0] = 0
    V_prev = np.full(B, NINF, dtype=np.int64)
    for r in range(1, m + 1):
        d = int(off[r] - off[r - 1])
        col = off[r] + k
        inb = col <= n
        # previous-row values shifted into this row's band coords
        def shift(prev, by):
            if by == 0:
                return prev
            out = np.full(B, NINF, dtype=np.int64)
            if by > 0:
                out[: B - by] = prev[by:]
            else:
                out[-by:] = prev[:by]
            return out
        S_up = shift(S_prev, d)        # (r-1, col)
        V_up = shift(V_prev, d)
        S_diag = shift(S_prev, d - 1)  # (r-1, col-1)

        if vfree:
            vg_open = np.where(col == n, 0, GO + GE)
            vg_ext = np.where(col == n, 0, GE)
        else:
            vg_open = np.full(B, GO + GE, dtype=np.int64)
            vg_ext = np.full(B, GE, dtype=np.int64)
        row_free = hfree and r == m
        O = 0 if row_free else GO + GE
        E = 0 if row_free else GE

        V_body = np.maximum(S_up + vg_open, V_up + vg_ext)
        score = np.where(s1[r - 1] == s2[np.clip(col - 1, 0, n - 1)],
                         sc.match, sc.mismatch)
        t = np.maximum(S_diag + score, V_body)
        s_col0 = 0 if vfree else GO + r * GE
        t_seed = np.where(col == 0, s_col0, t)
        zin = np.concatenate(([NINF], (t_seed - col * E)[:-1]))
        zmax = np.maximum.accumulate(zin)
        H_body = zmax + (col - 1) * E + O
        H_body = np.maximum(H_body, NINF)
        S_body = np.maximum(t, H_body)
        H_prev = np.concatenate(([NINF], H_body[:-1]))
        V_up_ext = V_up + vg_ext
        b = ((S_body == H_body).astype(np.uint8)
             | ((S_body == V_body).astype(np.uint8) << 1)
             | ((H_body != H_prev + E).astype(np.uint8) << 2)
             | ((V_body != V_up_ext).astype(np.uint8) << 3))
        # column-0 boundary (only while the corridor still covers it)
        S_body = np.where(col == 0, s_col0, S_body)
        V_body = np.where(col == 0, s_col0, V_body)
        S_body = np.where(inb, S_body, NINF)
        S_prev, V_prev = S_body, V_body
        bits[r] = b

    slot_n = n - int(off[m])
    best = int(S_prev[slot_n])
    codes = _walk_bits(bits, off, m, n)
    merged = create_alignment_codes(codes, a1, a2)
    return best, merged


def _walk_bits(bits: np.ndarray, off: np.ndarray, m: int, n: int):
    """Host traceback over band-coordinate bits (gotoh.h:134-174
    preference order). Returns forward-order int codes 0=s,1=h,2=v."""
    out = []
    row, col = m, n
    last = 0
    while row > 0 or col > 0:
        slot = col - int(off[row]) if row > 0 else col
        b = int(bits[row, slot]) if (row > 0 and 0 <= slot < bits.shape[1]) else 0
        bSH, bSV = b & 1, b & 2
        bHO, bVO = b & 4, b & 8
        if last == 0:
            if row == 0 and col > 0:
                last = 1
            elif col == 0 and row > 0:
                last = 2
            elif bSH:
                last = 1
            elif bSV:
                last = 2
            else:
                row -= 1
                col -= 1
                out.append(0)
        elif last == 1:
            opened = (col == 1) if row == 0 else bHO
            if opened:
                last = 0
            col -= 1
            out.append(1)
        else:
            opened = (row == 1) if col == 0 else bVO
            if opened:
                last = 0
            row -= 1
            out.append(2)
    return np.asarray(out[::-1], dtype=np.int64)
