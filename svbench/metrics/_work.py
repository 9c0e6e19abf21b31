"""The work of each kernel's unit of the recurrence, as a floor, and the
bound it sets on the H100: max(bytes / HBM rate, operations / int32
rate) (svbench/metrics/_peaks.py).

Operations are the fewest Hopper integer instructions that compute one
unit for these inputs: real lengths and real walk steps, never padding.
A `lop3` (any logic function of three inputs) counts one, a DPX
add-max (`viaddmax`) counts one, a funnel shift counts one. Loads and
stores are not integer instructions and count none. Bytes count each
input byte once (the real lengths) and each output once. So no kernel
can read over 100% of its bound, and the bound measures the same work
whatever computes it. The counts of chip_smoke.py (MYERS_OPS_PER_WORD =
24, _PER_COLUMN = 8, GOTOH_OPS_PER_CELL = 42, LCS_OPS_PER_WORD = 7) are
revised down to such floors below.
"""

from __future__ import annotations

import numpy as np

from svbench.metrics import _peaks

# K1, one 32-row word of the query against one target column (Hyyrö's
# multi-word Myers): Eq | the negative carry from the word below 1,
# Xv = Eq | Mv 1, Eq & Pv 1, + Pv with the carry chain 1,
# Xh = (sum ^ Pv) | Eq as one lop3 1, Ph = Mv | ~(Xh | Pv) lop3 1,
# Mh = Pv & Xh 1, Ph and Mh shifted in with the word below's top bits,
# a funnel shift each 2, Pv = Mh | ~(Xv | Ph) lop3 1, Mv = Ph & Xv 1.
MYERS_OPS_PER_WORD = 11
# the query's first word takes its carries from the mode, a constant
# (no Eq | carry; the shift-ins stay one instruction each)
MYERS_OPS_FIRST_WORD = 10
# HW, once per target column in the query's last word: the score's two
# bits at the query's last row 2, the score update (iadd3) 1, the least
# score so far 1. NW reads the score once, after the last column.
MYERS_HW_OPS_PER_COLUMN = 4
# K2, one DP cell of a merge. The profile score: 5 multiply-adds for the
# numerator, the depth product 1, the quotient 1 (no division is one
# instruction; the floor counts one) = 7; when both sides are single
# sequences the score is a comparison and a select = 2. V = max(S_up +
# open, V_up + extend): one add and one add-max 2; the diagonal, an
# add-max 1; H likewise 2; S = max(t, H) 1; the direction bits: four
# comparisons and one pack of their predicates 5.
GOTOH_DP_OPS_PER_CELL = 11
GOTOH_PROFILE_SCORE_OPS = 7
GOTOH_PAIR_SCORE_OPS = 2
# K2-tb, one step of the walk: the cell's index 1, the next state from
# the step table (a byte permute) 1, the move 1. Bytes: the cell's
# direction byte read once and the code written once.
GOTOH_TB_OPS_PER_STEP = 3
# X1, one 64-bit word of b against one row of a (bit-parallel LCS,
# V' = (V + (V & M)) | (V & ~M)): U = V & M, one per 32-bit half 2, the
# add with the carry in and out 2, the or with V & ~U as one lop3 per
# half 2. Rows of a whose letter b lacks change nothing and count none.
LCS_OPS_PER_WORD = 6


def myers(qlens, tlens, mode: int) -> tuple:
    """(operations, bytes) of K1 on pairs of these query and target
    lengths (mode 0 NW, 2 HW)."""
    ql = np.asarray(qlens, dtype=np.int64)
    tl = np.asarray(tlens, dtype=np.int64)
    words = (ql + 31) // 32
    per_col = np.where(words > 0, MYERS_OPS_FIRST_WORD
                       + MYERS_OPS_PER_WORD * (words - 1), 0)
    if mode == 2:
        per_col = per_col + MYERS_HW_OPS_PER_COLUMN * (words > 0)
    ops = int((per_col * tl).sum())
    # the bytes of both sequences, the int32 lengths in and distance out,
    # the letter table
    return ops, int(ql.sum() + tl.sum() + 12 * len(ql) + 256)


def gotoh(m, n, multi) -> tuple:
    """(operations, bytes) of K2 on merges of m x n columns; `multi`
    marks merges with a profile of several rows on either side."""
    m = np.asarray(m, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    per_cell = GOTOH_DP_OPS_PER_CELL + np.where(
        np.asarray(multi, dtype=bool), GOTOH_PROFILE_SCORE_OPS,
        GOTOH_PAIR_SCORE_OPS)
    ops = int((per_cell * m * n).sum())
    # profiles in (6 int32 a row, 5 weighted counts and a depth a column),
    # lengths in, the best score out, one direction byte a cell out
    return ops, int((24 * (m + n) + 12 + m * n).sum())


def gotoh_tb(steps) -> tuple:
    """(operations, bytes) of K2-tb on walks of these lengths."""
    s = np.asarray(steps, dtype=np.int64)
    return (int(GOTOH_TB_OPS_PER_STEP * s.sum()),
            int((2 * s + 12).sum()))


def lcs(word_steps: int, alens, blens) -> tuple:
    """(operations, bytes) of X1: `word_steps` = the sum over pairs of
    (rows of a whose letter occurs in b) x ceil(len(b) / 64)."""
    al = np.asarray(alens, dtype=np.int64)
    bl = np.asarray(blens, dtype=np.int64)
    return (int(LCS_OPS_PER_WORD * word_steps),
            int(al.sum() + bl.sum() + 12 * len(al) + 256))


def bound_s(ops: int, nbytes: int) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / _peaks.HBM_BYTES_PER_S, ops / _peaks.INT32_OPS_PER_S)
