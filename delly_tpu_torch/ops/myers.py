"""Myers bit-parallel edit distance: the plain PyTorch version of K1.

Counterpart of the JAX package's ops/myers.py (``encode_batch``,
``_device_myers``): the same algorithm, boundary rules and per-pair
length handling, on torch tensors of any device.

- 32 query rows are packed per 32-bit word (held in int64 tensors,
  masked to 32 bits); a column costs one update per word, and words
  couple only through the +-1 horizontal delta (hin/hout).
- NW and SHW charge the target prefix (hin=+1 into word 0), HW does
  not; SHW/HW take the minimum over columns <= tlen, NW the score at
  column tlen (qlen when tlen is 0). The score is read at bit qlen-1,
  so one padded batch serves ragged lengths.

The kernel (csrc/myers.cu) runs each pair's columns in order, word by
word. This version runs the same word updates on a wavefront: at step
s, word wi processes column s - wi, so the batch needs n + w - 1
steps of tensor work instead of n * w, and long queries stay fast on
the host. Word wi at column j reads only word wi at column j-1 and
word wi-1 at column j, which the previous step produced, so the two
schedules compute the same values.

The alphabet is the set of distinct bytes in the batch (exact byte
equality, edlib semantics), coded through a 256-entry table; batches
with more than MAX_ALPHA letters go to the row-scan in ops/edist.py.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_ALPHA = 16
MASK = 0xFFFFFFFF
_BIG = 1 << 20


def alphabet_lut(queries: np.ndarray, targets: np.ndarray):
    """Byte -> letter code table for a batch, or None above MAX_ALPHA
    letters. Absent bytes map to MAX_ALPHA (an all-zero Peq plane)."""
    present = np.zeros(256, dtype=bool)
    present[np.asarray(queries, dtype=np.uint8).reshape(-1)] = True
    present[np.asarray(targets, dtype=np.uint8).reshape(-1)] = True
    letters = np.nonzero(present)[0]
    if len(letters) > MAX_ALPHA:
        return None
    lut = np.full(256, MAX_ALPHA, dtype=np.uint8)
    lut[letters] = np.arange(len(letters), dtype=np.uint8)
    return lut


def alphabet_size(lut) -> int:
    """Letters an alphabet_lut codes (0 ... n - 1): the `nalpha` the
    kernel needs Peq planes for. Takes the numpy table or a tensor."""
    return int((lut < MAX_ALPHA).sum())


def peq_planes(qcodes: torch.Tensor, qlens: torch.Tensor) -> torch.Tensor:
    """Peq bit planes (MAX_ALPHA + 1, w, B) int64 from (B, M) letter
    codes; bits at or above qlen are clear, and plane MAX_ALPHA is
    zero."""
    b, m = qcodes.shape
    w = max(1, (m + 31) // 32)
    dev = qcodes.device
    codes = torch.full((b, w * 32), MAX_ALPHA, dtype=torch.int64,
                       device=dev)
    valid = (torch.arange(m, device=dev)[None, :]
             < qlens.to(torch.int64)[:, None])
    codes[:, :m] = torch.where(valid, qcodes.to(torch.int64), MAX_ALPHA)
    codes = codes.view(b, w, 32)
    weights = torch.ones(32, dtype=torch.int64, device=dev) \
        << torch.arange(32, dtype=torch.int64, device=dev)
    peq = torch.zeros((MAX_ALPHA + 1, w, b), dtype=torch.int64, device=dev)
    for a in torch.unique(codes).tolist():
        if a < MAX_ALPHA:
            peq[a] = ((codes == a).to(torch.int64) * weights).sum(-1).T
    return peq


def myers_plain(q: torch.Tensor, qlens: torch.Tensor, t: torch.Tensor,
                tlens: torch.Tensor, lut: torch.Tensor,
                mode: int) -> torch.Tensor:
    """Edit distances (B,) int32 of q (B, M) uint8 against t (B, N)
    uint8 with per-pair lengths, mode 0=NW 1=SHW 2=HW."""
    dev = q.device
    b, m = q.shape
    n = t.shape[1]
    lut64 = lut.to(torch.int64)
    ql = qlens.to(torch.int64)
    tl = tlens.to(torch.int64)
    peq = peq_planes(lut64[q.to(torch.int64)], ql)
    w = peq.shape[1]
    tcodes = lut64[t.to(torch.int64)].T.contiguous()     # (N, B)

    hi_word = torch.div(ql - 1, 32, rounding_mode="floor")
    hi_bit = torch.remainder(ql - 1, 32)
    hin0 = 0 if mode == 2 else 1
    pv = torch.full((w, b), MASK, dtype=torch.int64, device=dev)
    mv = torch.zeros((w, b), dtype=torch.int64, device=dev)
    hout = torch.zeros((w, b), dtype=torch.int64, device=dev)
    score = ql.clone()
    if mode == 0:
        res = torch.where(tl == 0, ql, torch.full_like(ql, _BIG))
    else:
        res = ql.clone()
    words = torch.arange(w, device=dev)
    hw_idx = hi_word.clamp(min=0)[None, :]
    for s in range(n + w - 1):
        j = s - words
        act = ((j >= 0) & (j < n))[:, None]
        tc = tcodes[j.clamp(0, n - 1)]                   # (w, B)
        eq = torch.gather(peq, 0, tc[None]).squeeze(0)
        hin = torch.cat([torch.full((1, b), hin0, dtype=torch.int64,
                                    device=dev), hout[:-1]])
        hneg = (hin < 0).to(torch.int64)
        hpos = (hin > 0).to(torch.int64)
        xv = eq | mv
        eq2 = eq | hneg
        xh = ((((eq2 & pv) + pv) & MASK) ^ pv) | eq2
        ph = mv | ((xh | pv) ^ MASK)
        mh = pv & xh
        hout = (ph >> 31) - (mh >> 31)
        d_here = ((ph >> hi_bit) & 1) - ((mh >> hi_bit) & 1)
        ph = ((ph << 1) & MASK) | hpos
        mh = ((mh << 1) & MASK) | hneg
        pv = torch.where(act, mh | ((xv | ph) ^ MASK), pv)
        mv = torch.where(act, ph & xv, mv)
        # the pair's delta comes from its word hi_word, which holds
        # column s - hi_word at this step
        jb = s - hi_word
        live = (jb >= 0) & (jb < n) & (ql > 0)
        score = score + torch.where(
            live, torch.gather(d_here, 0, hw_idx).squeeze(0), 0)
        col = jb + 1
        if mode == 0:
            res = torch.where(live & (col == tl), score, res)
        else:
            res = torch.where(live & (col <= tl),
                              torch.minimum(res, score), res)
    # empty queries analytically (no bit qlen-1 to read): NW = tlen,
    # SHW/HW = 0, as the host core returns
    empty = tl if mode == 0 else torch.zeros_like(tl)
    res = torch.where(ql == 0, empty, res)
    return res.to(torch.int32)
