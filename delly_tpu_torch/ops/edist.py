"""Edit distance (Levenshtein) in NW / SHW / HW modes.

This module fills the role of the vendored edlib (reference src/edlib.{h,cpp})
with two implementations written from scratch:

- exact host implementations (numpy, row-vectorized DP) including the
  alignment path with edlib's traceback preference (up > left > diagonal)
  and leftmost optimal end location;
- batched device DISTANCE for the genotyping hot loop (reference
  coverage.h:107-115 `_editDistanceHW` and genotype.h:21-29
  `_editDistanceNW`): the Myers kernel K1 (ops/myers_cuda.py), with a
  torch row-scan for alphabets above 16 letters.

Modes (edlib.h:36-62):
  NW  - global; distance D[m][n]
  SHW - prefix; distance min_j D[m][j], free gap after query in target
  HW  - infix; free target prefix (D[0][j] = 0) and suffix (min over j)

Alignment op codes (edlib.h:84-87):
  0 = MATCH, 1 = INSERT (consumes query only), 2 = DELETE (consumes target
  only), 3 = MISMATCH.
"""

from __future__ import annotations

import numpy as np

EDOP_MATCH, EDOP_INSERT, EDOP_DELETE, EDOP_MISMATCH = 0, 1, 2, 3

MODE_NW, MODE_SHW, MODE_HW = 0, 1, 2


# ---------------------------------------------------------------------------
# Host (numpy) exact implementation
# ---------------------------------------------------------------------------

def equality_matrix(pairs) -> np.ndarray:
    """256x256 symmetric character-equality table (edlib custom pairs).

    Used for aligning reads against IUPAC-extended consensus columns
    (reference assemble.h:425 additionalEqualities).
    """
    eq = np.zeros((256, 256), dtype=bool)
    eq[np.arange(256), np.arange(256)] = True
    for a, b in pairs:
        ia, ib = ord(a), ord(b)
        eq[ia, ib] = True
        eq[ib, ia] = True
    return eq


def _dp_matrix(query: np.ndarray, target: np.ndarray, mode: int,
               eq: np.ndarray | None = None) -> np.ndarray:
    """Full (m+1) x (n+1) DP matrix. The exact-equality case uses the
    native C++ kernel (hostio.cpp edist_matrix); custom-equality (IUPAC)
    and toolchain-less environments use the row-vectorized numpy DP."""
    if len(query) and len(target):
        try:
            from delly_tpu_torch import native
            eqb = None if eq is None else \
                np.ascontiguousarray(eq, dtype=np.uint8).tobytes()
            mat = native.edist_matrix(query.tobytes(), target.tobytes(),
                                      mode, eqb)
            if mat is not None:
                return mat
        except Exception:
            pass
    m, n = len(query), len(target)
    D = np.empty((m + 1, n + 1), dtype=np.int32)
    if mode == MODE_HW:
        D[0] = 0
    else:
        D[0] = np.arange(n + 1, dtype=np.int32)
    j_idx = np.arange(1, n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        if eq is None:
            sub = (query[i - 1] != target).astype(np.int32)
        else:
            sub = (~eq[query[i - 1], target]).astype(np.int32)
        cand = np.minimum(D[i - 1, :-1] + sub, D[i - 1, 1:] + 1)
        # Horizontal chains: D[i][j] = min_k<=j (cand[k] + (j - k)), plus the
        # boundary D[i][0] feeding the first horizontal step.
        run = np.minimum.accumulate(
            np.concatenate(([np.int32(i)], cand - j_idx)))
        D[i, 0] = i
        D[i, 1:] = np.minimum(cand, run[1:] + j_idx)
    return D


def edit_distance(query, target, mode: int = MODE_NW, k: int = -1,
                  eq: np.ndarray | None = None):
    """Distance + leftmost end location. Returns (dist, end_loc).

    dist == -1 if k >= 0 and the distance exceeds k (edlib semantics).
    end_loc is the 0-based index of the last aligned target char (n-1 for NW;
    -1 convention not used by callers we mirror).
    """
    q = np.frombuffer(query.encode(), dtype=np.uint8) if isinstance(query, str) else query
    t = np.frombuffer(target.encode(), dtype=np.uint8) if isinstance(target, str) else target
    if len(q) == 0 or len(t) == 0:
        # edlib's empty-sequence special case (edlib.cpp:158-176)
        # returns the distance WITHOUT consulting k (oracle-pinned by
        # tests/test_edlib_oracle.py)
        if mode == MODE_NW:
            return max(len(q), len(t)), len(t) - 1
        return len(q), -1
    if len(t):
        try:
            from delly_tpu_torch import native
            sc = native.edist_scan(
                q.tobytes(), t.tobytes(), mode,
                None if eq is None else
                np.ascontiguousarray(eq, dtype=np.uint8).tobytes())
        except Exception:
            sc = None
        if sc is not None:
            dist, end_col = sc
            if k >= 0 and dist > k:
                return -1, -1
            return dist, (len(t) - 1 if mode == MODE_NW else end_col - 1)
    D = _dp_matrix(q, t, mode, eq)
    last = D[-1]
    if mode == MODE_NW:
        dist = int(last[-1])
        end = len(t) - 1
    else:
        end1 = int(np.argmin(last))  # leftmost optimum
        dist = int(last[end1])
        end = end1 - 1
    if k >= 0 and dist > k:
        return -1, -1
    return dist, end


def _align_banded(q: np.ndarray, t: np.ndarray, mode: int,
                  eq: np.ndarray | None):
    """Ukkonen-corridor path alignment (native). Exact: the corridor
    half-width is grown until it provably contains every optimal-path
    cell, at which point band values and the greedy traceback equal
    the full-matrix ones. Returns (dist, end_loc, ops) or None to fall
    back to the full DP."""
    try:
        from delly_tpu_torch import native
        if native.get_lib() is None:
            return None
    except Exception:
        return None
    m, n = len(q), len(t)
    qb, tb = q.tobytes(), t.tobytes()
    eqb = None if eq is None else \
        np.ascontiguousarray(eq, dtype=np.uint8).tobytes()
    INF = 1 << 29
    if mode == MODE_HW:
        sc = native.edist_scan(qb, tb, mode, eqb)
        if sc is None:
            return None
        dist, end_col = sc
        if end_col <= 0 or 2 * (2 * dist + 9) >= n:
            return None          # degenerate / band ~ full width
        w = dist + 8             # optimal-path cells: |j-i-c| <= dist
        c = end_col - m
        return native.edist_path_banded(qb, tb, mode, eqb,
                                        c - w, c + w, end_col)
    sc = native.edist_scan(qb, tb, mode, eqb)
    if sc is None:
        return None
    dist = sc[0]
    base_lo = min(0, n - m)
    base_hi = max(0, n - m)
    w = dist + 8                 # w > dist: provably exact corridor
    if (base_hi - base_lo) + 2 * w >= n + 1:
        return None              # band as wide as the matrix
    r = native.edist_path_banded(qb, tb, mode, eqb,
                                 base_lo - w, base_hi + w, -1)
    if r is None or r[0] >= INF or r[0] != dist:
        return None
    return r


def _last_dp_row(q: np.ndarray, t: np.ndarray, mode: int,
                 eq: np.ndarray | None) -> np.ndarray:
    """Final DP row only (two-row recurrence, O(n) memory). NW/SHW
    rows come from the native Myers bit-parallel scan when available
    (the Hirschberg column computations are quadratic in total)."""
    n = len(t)
    if mode != MODE_HW and len(q):
        try:
            from delly_tpu_torch import native
            eqb = None if eq is None else \
                np.ascontiguousarray(eq, dtype=np.uint8).tobytes()
            row = native.edist_scan_row(q.tobytes(), t.tobytes(), eqb)
            if row is not None:
                return row
        except Exception:
            pass
    if mode == MODE_HW:
        prev = np.zeros(n + 1, dtype=np.int32)
    else:
        prev = np.arange(n + 1, dtype=np.int32)
    j_idx = np.arange(1, n + 1, dtype=np.int32)
    for i in range(1, len(q) + 1):
        if eq is None:
            sub = (q[i - 1] != t).astype(np.int32)
        else:
            sub = (~eq[q[i - 1], t]).astype(np.int32)
        cand = np.minimum(prev[:-1] + sub, prev[1:] + 1)
        run = np.minimum.accumulate(
            np.concatenate(([np.int32(i)], cand - j_idx)))
        cur = np.empty(n + 1, dtype=np.int32)
        cur[0] = i
        cur[1:] = np.minimum(cand, run[1:] + j_idx)
        prev = cur
    return prev


def _edlib_traceback_mem(m: int, n: int) -> int:
    """edlib's memory estimate for the plain-traceback NW alignment
    (edlib.cpp:1189-1191, WORD_SIZE=64): below 1 MB it tracebacks the
    full matrix; at or above it switches to Hirschberg's algorithm,
    which picks DIFFERENT (co-optimal) paths. PATH parity therefore
    requires reproducing both regimes."""
    max_blocks = -(-m // 64)
    return (2 * 8 + 4) * max_blocks * n + 2 * 4 * n


_EDLIB_TB_LIMIT = 1 << 20


def _nw_path_ops(q: np.ndarray, t: np.ndarray,
                 eq: np.ndarray | None) -> np.ndarray:
    """NW PATH ops in edlib's sub-1MB regime: the plain full-matrix
    traceback preference (up > left > diagonal), served by the banded
    native path when exact (both oracle-pinned against
    obtainAlignmentTraceback by tests/test_edlib_oracle.py)."""
    m, n = len(q), len(t)
    if m == 0:
        return np.full(n, EDOP_DELETE, dtype=np.uint8)
    if n == 0:
        return np.full(m, EDOP_INSERT, dtype=np.uint8)
    banded = _align_banded(q, t, MODE_NW, eq)
    if banded is not None:
        return banded[2]
    D = _dp_matrix(q, t, MODE_NW, eq)
    ops = []
    i, j = m, n
    while i > 0:
        cur = D[i, j]
        if D[i - 1, j] + 1 == cur:
            ops.append(EDOP_INSERT)
            i -= 1
        elif j > 0 and D[i, j - 1] + 1 == cur:
            ops.append(EDOP_DELETE)
            j -= 1
        else:
            if eq is None:
                is_match = q[i - 1] == t[j - 1]
            else:
                is_match = bool(eq[q[i - 1], t[j - 1]])
            ops.append(EDOP_MATCH if is_match else EDOP_MISMATCH)
            i -= 1
            j -= 1
    while j > 0:
        ops.append(EDOP_DELETE)
        j -= 1
    ops.reverse()
    return np.asarray(ops, dtype=np.uint8)


def _hirschberg_nw(q: np.ndarray, t: np.ndarray, best: int,
                   eq: np.ndarray | None) -> np.ndarray:
    """edlib's Hirschberg NW alignment, reproduced exactly
    (edlib.cpp obtainAlignmentHirschberg): split the target at
    n//2, take the FIRST query row whose left-prefix + right-suffix
    distances sum to `best` (then the q=-1 and q=m-1 boundary moves,
    in that order), and recurse — each sub-problem re-deciding
    plain-traceback vs Hirschberg by the same 1 MB rule. Scanning full
    DP columns from row 0 is equivalent to edlib's band-bounded scan:
    any row below a band start exceeds `best` on that side, so its sum
    can never match."""
    m, n = len(q), len(t)
    if m == 0 or n == 0:
        return _nw_path_ops(q, t, eq)
    if _edlib_traceback_mem(m, n) < _EDLIB_TB_LIMIT:
        return _nw_path_ops(q, t, eq)
    mid = n // 2
    if mid == 0:
        # n == 1 (only reachable for multi-megabase queries): the
        # ulHeight=0 split would recurse on the identical subproblem;
        # the two-column DP is trivial instead
        return _nw_path_ops(q, t, eq)
    # leftCol[i] = d(q[:i], t[:mid]); edit distance is symmetric (and
    # the custom-equality matrix is symmetric), so it is the last DP
    # row with the roles swapped. rightCol[r] = d(q[r:], t[mid:]).
    left_col = _last_dp_row(t[:mid], q, MODE_NW, eq)
    rq = q[::-1].copy()
    rt2 = t[mid:][::-1].copy()
    rcr = _last_dp_row(rt2, rq, MODE_NW, eq)
    right_col = rcr[::-1]                  # right_col[r] = rcr[m - r]

    split = None                           # (ulHeight, leftScore, rightScore)
    sums = left_col[1:m] + right_col[1:m]  # query rows 0..m-2
    hits = np.nonzero(sums == best)[0]
    if len(hits):
        qi = int(hits[0])
        split = (qi + 1, int(left_col[qi + 1]), int(right_col[qi + 1]))
    elif mid + int(right_col[0]) == best:
        split = (0, mid, int(right_col[0]))
    elif int(left_col[m]) + (n - mid) == best:
        split = (m, int(left_col[m]), n - mid)
    if split is None:
        # unreachable for a correct `best`; mirror edlib's error path
        raise ValueError("hirschberg: no split consistent with best")
    ul_h, left_score, right_score = split
    ul = _hirschberg_nw(q[:ul_h], t[:mid], left_score, eq)
    lr = _hirschberg_nw(q[ul_h:], t[mid:], right_score, eq)
    return np.concatenate([ul, lr])


def align(query, target, mode: int = MODE_NW, k: int = -1,
          eq: np.ndarray | None = None):
    """Distance, end location, and alignment path (edlib TASK_PATH role).

    Returns (dist, end_loc, ops: np.ndarray uint8). ops covers
    target[start..end_loc] where start is implied by the path. Traceback
    preference matches edlib.cpp obtainAlignmentTraceback: up (INSERT) first,
    then left (DELETE), then diagonal.
    """
    q = np.frombuffer(query.encode(), dtype=np.uint8) if isinstance(query, str) else query
    t = np.frombuffer(target.encode(), dtype=np.uint8) if isinstance(target, str) else target
    m, n = len(q), len(t)
    if m == 0 or n == 0:
        # edlib empty-sequence semantics (edlib.cpp:158-176): distance
        # regardless of k, end -1 outside NW, and no PATH stage — the
        # trivial op string is still emitted for repo callers.
        if mode == MODE_NW:
            if m == 0:
                return n, n - 1, np.full(n, EDOP_DELETE, dtype=np.uint8)
            return m, n - 1, np.full(m, EDOP_INSERT, dtype=np.uint8)
        return m, -1, np.full(m, EDOP_INSERT, dtype=np.uint8)
    if mode == MODE_HW and m and n:
        # edlib HW path semantics (edlib.cpp:244-255): leftmost optimal
        # END from the forward scan, then the START from a REVERSED SHW
        # scan taking the LAST optimal position — "alignment will not
        # start with insertions if it can start with mismatches" — and
        # an NW path over the [start, end] infix. A greedy traceback
        # over the free-prefix HW matrix picks a different start on
        # ties, drifting every HW-path consumer from the reference.
        dist, end_loc = edit_distance(q, t, MODE_HW, eq=eq)
        if k >= 0 and dist > k:
            return -1, -1, np.zeros(0, dtype=np.uint8)
        rq = q[::-1].copy()
        rt = t[:end_loc + 1][::-1].copy()
        pos = None
        try:
            from delly_tpu_torch import native
            eqb = None if eq is None else \
                np.ascontiguousarray(eq, dtype=np.uint8).tobytes()
            sc = native.edist_scan_last(rq.tobytes(), rt.tobytes(),
                                        MODE_SHW, eqb)
            if sc is not None and sc[0] == dist:
                pos = sc[1] - 1
        except Exception:
            pass
        if pos is None:
            row = _last_dp_row(rq, rt, MODE_SHW, eq)
            opt = np.nonzero(row == dist)[0]
            pos = int(opt[-1]) - 1
        start = end_loc - pos
        _d, _e, ops = align(q, t[start:end_loc + 1], MODE_NW, eq=eq)
        return dist, end_loc, ops
    if mode == MODE_SHW and m and n:
        # edlib SHW PATH pipeline: leftmost optimal end from the
        # semi-global scan, then an NW alignment over target[0:end+1]
        # (edlibAlign: startLocations are 0 for SHW and obtainAlignment
        # runs NW on the [start, end] slice) — the NW call below picks
        # plain traceback or Hirschberg by edlib's own 1 MB rule.
        dist, end_loc = edit_distance(q, t, MODE_SHW, eq=eq)
        if k >= 0 and dist > k:
            return -1, -1, np.zeros(0, dtype=np.uint8)
        _d, _e, ops = align(q, t[:end_loc + 1], MODE_NW, eq=eq)
        return dist, end_loc, ops
    if mode == MODE_NW and m and n \
            and _edlib_traceback_mem(m, n) >= _EDLIB_TB_LIMIT:
        # edlib switches to Hirschberg above 1 MB of traceback memory,
        # whose co-optimal path choices differ from the plain traceback
        # — reproduce it exactly (found by the live-oracle fuzz on
        # kb-scale inputs, tests/test_edlib_oracle.py).
        dist, _e = edit_distance(q, t, MODE_NW, eq=eq)
        if k >= 0 and dist > k:
            return -1, -1, np.zeros(0, dtype=np.uint8)
        return dist, n - 1, _hirschberg_nw(q, t, dist, eq)
    if m and n:
        banded = _align_banded(q, t, mode, eq)
        if banded is not None:
            dist, end_loc, ops = banded
            if k >= 0 and dist > k:
                return -1, -1, np.zeros(0, dtype=np.uint8)
            return dist, end_loc, ops
    D = _dp_matrix(q, t, mode, eq) if m else None
    if m == 0:
        if mode == MODE_NW:
            return n, n - 1, np.full(n, EDOP_DELETE, dtype=np.uint8)
        return 0, -1, np.zeros(0, dtype=np.uint8)
    last = D[-1]
    if mode == MODE_NW:
        dist, endj = int(last[-1]), n
    else:
        endj = int(np.argmin(last))
        dist = int(last[endj])
    if k >= 0 and dist > k:
        return -1, -1, np.zeros(0, dtype=np.uint8)
    ops = []
    i, j = m, endj
    free_top = (mode == MODE_HW)
    while i > 0:
        cur = D[i, j]
        if D[i - 1, j] + 1 == cur:  # up: INSERT
            ops.append(EDOP_INSERT)
            i -= 1
        elif j > 0 and D[i, j - 1] + 1 == cur:  # left: DELETE
            ops.append(EDOP_DELETE)
            j -= 1
        else:  # diagonal
            if eq is None:
                is_match = q[i - 1] == t[j - 1]
            else:
                is_match = bool(eq[q[i - 1], t[j - 1]])
            ops.append(EDOP_MATCH if is_match else EDOP_MISMATCH)
            i -= 1
            j -= 1
    if not free_top:
        while j > 0:
            ops.append(EDOP_DELETE)
            j -= 1
    ops.reverse()
    return dist, endj - 1, np.asarray(ops, dtype=np.uint8)


def infix_start(ops: np.ndarray, end_loc: int) -> int:
    """Start position in target of an HW alignment (util.h:86-94)."""
    t_idx = end_loc - int(np.count_nonzero(ops != EDOP_INSERT))
    return t_idx + 1 if t_idx >= 0 else 0


# ---------------------------------------------------------------------------
# Device (torch) batched DISTANCE: Myers kernel K1, row-scan X4
# ---------------------------------------------------------------------------

def rowscan_plain(queries, qlens, targets, tlens, mode):
    """Dense DP row-scan over a padded batch, for alphabets above
    MAX_ALPHA letters (counterpart of the JAX package's _device_fns,
    edist.py:451-515): a loop over the query rows, each row elementwise
    over the target columns plus a min-plus prefix scan (cummin),
    vectorized over the batch. Takes and returns torch tensors."""
    import torch

    dev = queries.device
    B, M = queries.shape
    N = targets.shape[1]
    BIG = 1 << 20
    ql = qlens.to(torch.int64)
    tl = tlens.to(torch.int64)
    cols = torch.arange(N + 1, device=dev)
    jpos = cols[1:]
    in_t = cols[None, :] <= tl[:, None]                  # (B, N+1)
    col_valid = in_t[:, 1:]
    if mode == MODE_HW:
        row = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    else:
        row = cols[None, :].expand(B, N + 1).clone()
    row = torch.where(in_t, row, BIG)
    for i in range(1, M + 1):
        active = (i <= ql)[:, None]
        sub = (queries[:, i - 1:i] != targets).to(torch.int64)
        cand = torch.minimum(row[:, :-1] + sub, row[:, 1:] + 1)
        cand = torch.where(col_valid, cand, BIG)
        shifted = torch.cat([torch.full((B, 1), i, dtype=torch.int64,
                                        device=dev), cand - jpos], dim=1)
        run = torch.cummin(shifted, dim=1).values
        body = torch.minimum(cand, run[:, 1:] + jpos)
        new = torch.cat([torch.full((B, 1), i, dtype=torch.int64,
                                    device=dev), body], dim=1)
        new = torch.where(in_t, new, BIG)
        row = torch.where(active, new, row)
    if mode == MODE_NW:
        dist = row.gather(1, tl[:, None]).squeeze(1)
    else:
        dist = torch.where(in_t, row, BIG).min(dim=1).values
    return dist.to(torch.int32)


def batched_edit_distance(queries, qlens, targets, tlens, mode=MODE_NW):
    """Batched edit distance on the run's device
    (utils.torchenv.device()), one (query, target) pair per row.

    queries: (B, M) uint8, qlens: (B,) int32; targets: (B, N) uint8,
    tlens: (B,) int32. Returns (B,) int32 distances as numpy.

    Batches of at most MAX_ALPHA letters go to the Myers kernel K1 on
    CUDA tensors and to its plain version on CPU tensors
    (ops/myers_cuda.py), at any query width; larger alphabets take
    the row-scan, each batch counted as ``rowscan``
    (parallel/dispatch.py). Every batch goes to the device: there is no
    pair or cell gate. Under an active mesh the batches K1 serves are
    cut into contiguous chunks, one per device of the mesh
    (ops/myers_cuda.py); the row-scan runs on the run's device."""
    from delly_tpu_torch.ops.myers_cuda import batched_edit_distance_myers
    from delly_tpu_torch.parallel import dispatch
    out = batched_edit_distance_myers(queries, qlens, targets, tlens, mode)
    if out is not None:
        return out
    dispatch.count("rowscan")
    return batched_edit_distance_rowscan(queries, qlens, targets, tlens,
                                         mode)


def batched_edit_distance_rowscan(queries, qlens, targets, tlens,
                                  mode=MODE_NW):
    """Row-scan on the run's device (numpy in, numpy out)."""
    import torch

    from delly_tpu_torch.utils import torchenv
    dev = torchenv.device()
    out = rowscan_plain(
        torch.as_tensor(np.ascontiguousarray(queries, dtype=np.uint8),
                        device=dev),
        torch.as_tensor(np.asarray(qlens, dtype=np.int32), device=dev),
        torch.as_tensor(np.ascontiguousarray(targets, dtype=np.uint8),
                        device=dev),
        torch.as_tensor(np.asarray(tlens, dtype=np.int32), device=dev),
        mode)
    return out.cpu().numpy()


def batched_pairs_distance(pairs: list, mode: int = MODE_NW) -> np.ndarray:
    """Edit distances for a list of (query, target) string pairs via one
    padded device batch (ragged lengths are handled by the kernels).
    Array dims are bucketed to powers of two to bound compile count."""
    if not pairs:
        return np.zeros(0, dtype=np.int64)

    def bucket_q(x):
        # query length drives the Myers word count w = ceil(m/32), and
        # compile time scales with w. Round to the exact word multiple
        # below 512 (<= 16 keys, minimal w), powers of two above.
        if x <= 512:
            return max(32, -(-x // 32) * 32)
        b = 1024
        while b < x:
            b *= 2
        return b

    def bucket_t(x):
        b = 128
        while b < x:
            b *= 2
        return b

    m = bucket_q(max(len(a) for a, _ in pairs))
    n = bucket_t(max(len(b) for _, b in pairs))
    nb = len(pairs)
    q = np.zeros((nb, m), dtype=np.uint8)
    t = np.zeros((nb, n), dtype=np.uint8)
    ql = np.zeros(nb, dtype=np.int32)
    tl = np.zeros(nb, dtype=np.int32)
    for i, (a, b) in enumerate(pairs):
        ab = a.encode() if isinstance(a, str) else bytes(a)
        bb = b.encode() if isinstance(b, str) else bytes(b)
        q[i, :len(ab)] = np.frombuffer(ab, dtype=np.uint8)
        t[i, :len(bb)] = np.frombuffer(bb, dtype=np.uint8)
        ql[i] = len(ab)
        tl[i] = len(bb)
    out = np.asarray(batched_edit_distance(q, ql, t, tl, mode))
    # empty-query pairs analytically (the kernels assume qlen >= 1)
    empty = ql == 0
    if empty.any():
        out = out.copy()
        out[empty] = tl[empty] if mode == MODE_NW else 0
    return out


def edit_distance_hw_score(dist: int, qlen: int, flank_quality: float) -> float:
    """Reference coverage.h:107-115 score transform."""
    if dist == -1:
        return 0.0
    return ((1.0 - flank_quality) * qlen) / (dist + 1)
