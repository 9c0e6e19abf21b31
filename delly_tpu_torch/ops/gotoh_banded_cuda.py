"""K3 and K3-tb: corridor (banded) Gotoh for long sequence merges.

Replaces ``delly_tpu/ops/gotoh_banded.py``: the Pallas forward kernel
``_build`` (:192, call :314) becomes csrc/gotoh_banded.cu, and the XLA
traceback walk ``_build_tb`` (:342) becomes csrc/gotoh_banded_tb.cu, so
the m x B direction tile never leaves the card. ``gotoh_banded_batch``
keeps the contract of the JAX package's ``gotoh_banded_batch``
(:420-546): jobs with n > m are transposed, multi-row or empty jobs take
the full host ``gotoh``, jobs above ``max_m`` or with letters outside
ACGTN- take the host corridor ``gotoh_banded_host`` (all three count as
``host_routes``), the rest are bucketed by (band, M, end-gap config) and
``create_alignment_codes`` runs on the host. Results equal
``gotoh_banded_host`` per job. It takes one band for all jobs or one
per job, and runs every bucket's K3 and K3-tb on its own CUDA stream,
joined before one copy back, so a round's bands share the card.

What is packed for the card: the two sequences as bytes and the
lengths. The kernel compares s1[r-1] with s2[clip(col-1, 0, n-1)] itself
(the TPU path packed (m, B) equality windows on the host), writes one
byte of direction bits per (row, slot), and solves the in-row chain
with a block-wide max-plus scan. Both kernels step off(r) with a
quotient and remainder (``corridor_table_stepped`` is their twin).

Bounds on the H100: the forward pass writes one byte per (row, slot)
and its recurrence has 39 integer operations per cell; the walk is a
chain of dependent byte loads per job (latency). Each wrapper launches
its kernel on CUDA tensors (or raises) and runs its plain PyTorch
version, in this module, on CPU tensors. All arithmetic is exact
integer.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delly_tpu_torch.ops import _build
from delly_tpu_torch.ops.gotoh import (
    DnaScore, INF, create_alignment_codes, gotoh as gotoh_full, to_align,
)
from delly_tpu_torch.ops.gotoh_banded import QUANT, gotoh_banded_host
from delly_tpu_torch.parallel import dispatch
from delly_tpu_torch.utils import profiling

NINF = -INF
BANDS = (512, 1024, 2048, 4096)
MAX_M = 32768
TILE_BYTES = 1 << 32       # direction bytes of one launch, at most
_P = ctypes.c_void_p
_I = ctypes.c_int
# host spans (utils/profiling.py) of each wrapper: the call, then its
# phases check, plan, alloc, upload and launch
(_FWD_CALL, _FWD_CHECK, _FWD_PLAN, _FWD_ALLOC, _FWD_UPLOAD,
 _FWD_LAUNCH) = profiling.kernel_spans("gotoh_banded")
(_TB_CALL, _TB_CHECK, _TB_PLAN, _TB_ALLOC, _TB_UPLOAD,
 _TB_LAUNCH) = profiling.kernel_spans("gotoh_banded_tb")

_ALLOWED = frozenset(b"ACGTN-")  # uppercase only: the host oracle scores
# raw bytes, as the kernel does


def _bucket_m(m: int) -> int:
    b = 256
    while b < m:
        b *= 2
    return b


def corridor_table(mlen, nlen, M: int, B: int):
    """off(r) for DP rows r = 0..M of each job, (G, M + 1) int64: the
    schedule of ops.gotoh_banded.corridor_offsets."""
    r = torch.arange(M + 1, dtype=torch.int64, device=mlen.device)[None, :]
    m = mlen.to(torch.int64).clamp(min=1)[:, None]
    n = nlen.to(torch.int64)[:, None]
    raw = (r * n // m - B // 2).clamp(min=0)
    return raw - raw % QUANT


def corridor_table_stepped(mlen, nlen, M: int, B: int,
                           descending: bool = False) -> np.ndarray:
    """corridor_table as K3 and K3-tb compute it, with no division (numpy
    twin of their arithmetic): the quotient q and remainder of r * n / m
    step with r (n <= m, so one carry or borrow at most), and off(r) is
    q - B/2 rounded down to a multiple of 128, or 0. Ascending from row 0
    as K3 steps, or, with `descending`, from row m down to 0 as K3-tb
    steps (rows above m stay 0). (G, M + 1) int64."""
    m = np.asarray(mlen, dtype=np.int64)
    n = np.asarray(nlen, dtype=np.int64)
    out = np.zeros((len(m), M + 1), dtype=np.int64)

    def off(q):
        raw = q - B // 2
        return np.where(raw > 0, raw & ~(QUANT - 1), 0)

    if descending:
        q, rem, row = n.copy(), np.zeros_like(m), m.copy()
        idx = np.arange(len(m))
        while len(row) and row.max() >= 0:
            live = row >= 0
            out[idx[live], row[live]] = off(q)[live]
            rem -= n
            borrow = rem < 0
            rem += np.where(borrow, m, 0)
            q -= borrow
            row -= 1
        return out
    q, rem = np.zeros_like(m), np.zeros_like(m)
    for r in range(1, M + 1):
        rem += n
        carry = rem >= m
        rem -= np.where(carry, m, 0)
        q += carry
        out[:, r] = off(q)
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def banded_forward_plain(s1, s2, mlen, nlen, B: int, hfree: bool,
                         vfree: bool, match: int, mismatch: int, go: int,
                         ge: int):
    """Corridor DP over a batch, the recurrence of gotoh_banded_host:
    (best (G,) int32, bits (G, M, B) uint8 with DP row r at index r - 1).
    Rows above a job's mlen are left zero."""
    dev = s1.device
    G, M = s1.shape
    i64 = torch.int64
    k = torch.arange(B, dtype=i64, device=dev)[None, :]
    ml = mlen.to(i64)
    nl = nlen.to(i64)[:, None]
    off = corridor_table(mlen, nlen, M, B)
    shift = off[:, 1:] - off[:, :-1]
    rows = torch.arange(1, M + 1, device=dev)[None, :]
    assert bool(((shift == 0) | (shift == QUANT) | (rows > ml[:, None]))
                .all()), "corridor shift outside {0, 128}"
    ninf = torch.full((G, 1), NINF, dtype=i64, device=dev)
    # the previous S and V rows, padded: index j + 1 holds slot j, and
    # the shifted-out slots on either side read NINF
    Sp = torch.full((G, B + 1 + QUANT), NINF, dtype=i64, device=dev)
    Vp = torch.full((G, B + 1 + QUANT), NINF, dtype=i64, device=dev)
    Sp[:, 1:B + 1] = torch.where(k <= nl, 0 if hfree else go + k * ge, NINF)
    Sp[:, 1] = 0
    best = torch.full((G,), NINF, dtype=i64, device=dev)
    bits = torch.zeros((G, M, B), dtype=torch.uint8, device=dev)
    a = s1.to(i64)
    b2 = s2.to(i64)
    mmin = int(ml.min()) if G else 0
    for r in range(1, (int(ml.max()) if G else 0) + 1):
        o = off[:, r:r + 1]
        d = shift[:, r - 1:r]
        col = o + k
        # the previous row in this row's band coordinates: slot k reads
        # k + d + 1 (up) and k + d (diagonal) of the padded rows
        up = (k + d + 1).expand(G, B)
        S_up = Sp.gather(1, up)
        V_up = Vp.gather(1, up)
        S_diag = Sp.gather(1, up - 1)
        if vfree:
            at_n = col == nl
            vg_open = torch.where(at_n, 0, go + ge)
            vg_ext = torch.where(at_n, 0, ge)
        else:
            vg_open, vg_ext = go + ge, ge
        if hfree:
            rf = (ml == r)[:, None]
            O = torch.where(rf, 0, go + ge)
            E = torch.where(rf, 0, ge)
        else:
            O, E = go + ge, ge
        Vb = torch.maximum(S_up + vg_open, V_up + vg_ext)
        j = torch.minimum((col - 1).clamp(min=0), nl - 1)
        score = torch.where(a[:, r - 1:r] == b2.gather(1, j), match, mismatch)
        t = torch.maximum(S_diag + score, Vb)
        s_col0 = 0 if vfree else go + r * ge
        t_seed = torch.where(col == 0, s_col0, t)
        zin = torch.cat([ninf, (t_seed - col * E)[:, :-1]], dim=1)
        H = (torch.cummax(zin, dim=1).values + (col - 1) * E + O).clamp(
            min=NINF)
        Sb = torch.maximum(t, H)
        Hp = torch.cat([ninf, H[:, :-1]], dim=1)
        b = ((Sb == H).to(i64) | ((Sb == Vb).to(i64) << 1)
             | ((H != Hp + E).to(i64) << 2)
             | ((Vb != V_up + vg_ext).to(i64) << 3))
        # column-0 boundary (only while the corridor still covers it)
        Sb = torch.where(col == 0, s_col0, Sb)
        Vb = torch.where(col == 0, s_col0, Vb)
        Sb = torch.where(col <= nl, Sb, NINF)
        slot_n = (nl - o).clamp(0, B - 1)
        best = torch.where(ml == r, Sb.gather(1, slot_n).squeeze(1), best)
        if r <= mmin:
            bits[:, r - 1] = b
            Sp[:, 1:B + 1] = Sb
            Vp[:, 1:B + 1] = Vb
        else:
            live = (r <= ml)[:, None]
            bits[:, r - 1] = torch.where(live, b, 0)
            Sp[:, 1:B + 1] = torch.where(live, Sb, Sp[:, 1:B + 1])
            Vp[:, 1:B + 1] = torch.where(live, Vb, Vp[:, 1:B + 1])
    return best.to(torch.int32), bits


def banded_traceback_plain(bits, mlen, nlen):
    """Lockstep walk over a batch of band tiles: (codes (G, 2M) uint8 in
    walk order, lens (G,) int32), in the order of the JAX package's host
    walk ``_walk_bits`` (gotoh_banded.py:138-174): a cell outside the
    band, or on row 0, reads as 0."""
    dev = bits.device
    G, M, B = bits.shape
    i64 = torch.int64
    L, cap = 2 * M, 4 * M + 8
    off = corridor_table(mlen, nlen, M, B)
    flat = bits.reshape(G, M * B)
    row = mlen.to(i64).clone()
    col = nlen.to(i64).clone()
    last = torch.zeros(G, dtype=i64, device=dev)
    i = torch.zeros(G, dtype=i64, device=dev)
    codes = torch.zeros((G, L), dtype=torch.uint8, device=dev)
    for _ in range(cap):
        alive = ((row > 0) | (col > 0)) & (i < L)
        if not bool(alive.any()):
            break
        up = row > 0
        o = off.gather(1, row.clamp(0, M)[:, None]).squeeze(1)
        slot = col - o
        inb = up & (slot >= 0) & (slot < B)
        idx = (row - 1).clamp(min=0) * B + slot.clamp(0, B - 1)
        b = torch.where(inb, flat.gather(1, idx[:, None]).squeeze(1)
                        .to(i64), 0)
        is_s, is_h, is_v = last == 0, last == 1, last == 2
        top = (row == 0) & (col > 0)
        left = (col == 0) & up
        go_h = top | (~left & ((b & 1) != 0))
        go_v = ~go_h & (left | ((b & 2) != 0))
        s_move = is_s & ~go_h & ~go_v
        h_open = torch.where(row == 0, col == 1, (b & 4) != 0)
        v_open = torch.where(col == 0, row == 1, (b & 8) != 0)
        new_last = torch.where(
            is_s, torch.where(go_h, 1, torch.where(go_v, 2, 0)),
            torch.where(is_h, torch.where(h_open, 0, 1),
                        torch.where(v_open, 0, 2)))
        emit = alive & (s_move | is_h | is_v)
        code = torch.where(s_move, 0, torch.where(is_h, 1, 2))
        at = i.clamp(max=L - 1)[:, None]
        cur = codes.gather(1, at).squeeze(1).to(i64)
        codes.scatter_(1, at, torch.where(emit, code, cur)[:, None]
                       .to(torch.uint8))
        row = row - (alive & (s_move | is_v)).to(i64)
        col = col - (alive & (s_move | is_h)).to(i64)
        last = torch.where(alive, new_last, last)
        i = i + emit.to(i64)
    return codes, i.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib(name: str):
    lib = _build.load(name)
    if name == "gotoh_banded" and lib.gotoh_banded_launch.argtypes is None:
        lib.gotoh_banded_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _I, _I, _I, _I, _P, _P, _I,
                                            _P]
        lib.gotoh_banded_launch.restype = _I
    if (name == "gotoh_banded_tb"
            and lib.gotoh_banded_tb_launch.argtypes is None):
        lib.gotoh_banded_tb_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P,
                                               _P, _P]
        lib.gotoh_banded_tb_launch.restype = _I
    return lib


def _check(name, dev, specs):
    for arg, x, dt, shape in specs:
        if x.dtype != dt:
            raise TypeError(f"{name}: {arg} must be {dt}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.device != dev:
            raise ValueError(f"{name}: {arg} is on {x.device}, not {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_lengths(name: str, mlen, nlen, M: int,
                   host_lengths=None) -> None:
    """The kernels index the sequences and the tile by these lengths.
    `host_lengths` are numpy copies of mlen and nlen, checked in their
    place, so that the check reads nothing back from the card."""
    if host_lengths is not None:
        hm, hn = host_lengths
        if hm.shape != tuple(mlen.shape) or hn.shape != tuple(nlen.shape):
            raise ValueError(f"{name}: host_lengths have shapes {hm.shape} "
                             f"and {hn.shape}, expected "
                             f"{tuple(mlen.shape)}")
        mlen, nlen = hm, hn
    if len(mlen) and not bool(((nlen >= 1) & (nlen <= mlen)
                               & (mlen <= M)).all()):
        raise ValueError(f"{name}: lengths must satisfy 1 <= nlen <= mlen "
                         f"<= {M}")


def _check_mb(name: str, M: int, B: int) -> None:
    if B not in BANDS:
        raise ValueError(f"{name}: band {B} is not one of {BANDS}")
    if M < 256 or M > MAX_M or M & (M - 1):
        raise ValueError(f"{name}: M={M} is not a power of two in "
                         f"256..{MAX_M}")


def banded_forward(s1, s2, mlen, nlen, B: int, hfree: bool, vfree: bool,
                   match: int, mismatch: int, go: int, ge: int,
                   spread: bool = False, host_lengths=None):
    """K3: (best (G,) int32, bits (G, M, B) uint8) for s1, s2 (G, M) uint8
    and mlen, nlen (G,) int32 with 1 <= nlen <= mlen <= M. `spread`
    keeps its blocks on SMs of their own (for launches that together hold
    fewer jobs than the card has SMs); it does not change the result.
    `host_lengths`: the numpy mlen and nlen that the caller uploaded,
    checked in place of the card's (see _check_lengths)."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        G, M = s1.shape
        _check_mb("gotoh_banded", M, B)
        _check("gotoh_banded", s1.device, (
            ("s1", s1, torch.uint8, (G, M)), ("s2", s2, torch.uint8, (G, M)),
            ("mlen", mlen, torch.int32, (G,)),
            ("nlen", nlen, torch.int32, (G,))))
        _check_lengths("gotoh_banded", mlen, nlen, M, host_lengths)
        if s:
            s = profiling.mark(_FWD_CHECK, s)
        if s1.device.type == "cpu":
            return banded_forward_plain(s1, s2, mlen, nlen, B, hfree,
                                        vfree, match, mismatch, go, ge)
        if s1.device.type != "cuda":
            raise ValueError(
                f"gotoh_banded: unsupported device {s1.device}")
        best = torch.empty(G, dtype=torch.int32, device=s1.device)
        bits = torch.empty((G, M, B), dtype=torch.uint8, device=s1.device)
        if s:
            s = profiling.mark(_FWD_ALLOC, s)
        if G == 0:
            return best, bits
        rc = _lib("gotoh_banded").gotoh_banded_launch(
            s1.data_ptr(), s2.data_ptr(), mlen.data_ptr(), nlen.data_ptr(),
            G, M, B, int(hfree), int(vfree), int(match), int(mismatch),
            int(go), int(ge), best.data_ptr(), bits.data_ptr(), int(spread),
            _build.stream_ptr(s1.device))
        _build.check(rc, "gotoh_banded")
        dispatch.count("gotoh_banded")
        if s:
            profiling.mark(_FWD_LAUNCH, s)
        return best, bits
    finally:
        if s0:
            profiling.mark(_FWD_CALL, s0)


def banded_traceback(bits, mlen, nlen, host_lengths=None):
    """K3-tb: (codes (G, 2M) uint8 in walk order, lens (G,) int32).
    `host_lengths` as in banded_forward."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        G, M, B = bits.shape
        _check_mb("gotoh_banded_tb", M, B)
        _check("gotoh_banded_tb", bits.device, (
            ("bits", bits, torch.uint8, (G, M, B)),
            ("mlen", mlen, torch.int32, (G,)),
            ("nlen", nlen, torch.int32, (G,))))
        _check_lengths("gotoh_banded_tb", mlen, nlen, M, host_lengths)
        if s:
            s = profiling.mark(_TB_CHECK, s)
        if bits.device.type == "cpu":
            return banded_traceback_plain(bits, mlen, nlen)
        if bits.device.type != "cuda":
            raise ValueError(
                f"gotoh_banded_tb: unsupported device {bits.device}")
        codes = torch.empty((G, 2 * M), dtype=torch.uint8,
                            device=bits.device)
        lens = torch.empty(G, dtype=torch.int32, device=bits.device)
        if s:
            s = profiling.mark(_TB_ALLOC, s)
        if G == 0:
            return codes, lens
        rc = _lib("gotoh_banded_tb").gotoh_banded_tb_launch(
            bits.data_ptr(), mlen.data_ptr(), nlen.data_ptr(), G, M, B,
            codes.data_ptr(), lens.data_ptr(),
            _build.stream_ptr(bits.device))
        _build.check(rc, "gotoh_banded_tb")
        dispatch.count("gotoh_banded_tb")
        if s:
            profiling.mark(_TB_LAUNCH, s)
        return codes, lens
    finally:
        if s0:
            profiling.mark(_TB_CALL, s0)


# ---------------------------------------------------------------------------
# Batch entry point
# ---------------------------------------------------------------------------

def pack_jobs(jobs: list, M: int):
    """Host packing of one M bucket of (a1, a2) single-row jobs with
    n <= m <= M: the two sequences as (G, M) uint8, zero-padded, and the
    lengths (G,) int32 (numpy)."""
    G = len(jobs)
    s1 = np.zeros((G, M), dtype=np.uint8)
    s2 = np.zeros((G, M), dtype=np.uint8)
    ml = np.zeros(G, dtype=np.int32)
    nl = np.zeros(G, dtype=np.int32)
    for gi, (a1, a2) in enumerate(jobs):
        m, n = a1.shape[1], a2.shape[1]
        s1[gi, :m] = a1[0]
        s2[gi, :n] = a2[0]
        ml[gi] = m
        nl[gi] = n
    return s1, s2, ml, nl


_side_streams: dict = {}


def run_concurrently(dev, fns: list) -> list:
    """[fn() for fn in fns], each called with a CUDA stream of its own
    current, after the current stream's queued work; the current stream
    then waits for all of them. On the CPU, one after the other."""
    if dev.type != "cuda":
        return [fn() for fn in fns]
    main = torch.cuda.current_stream(dev)
    pool = _side_streams.setdefault(dev, [])
    while len(pool) < len(fns):
        pool.append(torch.cuda.Stream(dev))
    outs = []
    for fn, st in zip(fns, pool):
        st.wait_stream(main)
        with torch.cuda.stream(st):
            out = fn()
        for x in out if isinstance(out, tuple) else (out,):
            if isinstance(x, torch.Tensor):
                x.record_stream(main)
        outs.append(out)
    for st in pool[:len(fns)]:
        main.wait_stream(st)
    return outs


def gotoh_banded_batch(jobs, ac=(False, False), sc: DnaScore | None = None,
                       band=512, max_m: int = MAX_M):
    """Batched corridor Gotoh on the run's device: [(score, merged)] with
    the values of gotoh_banded_host per job (transposed when n > m, its
    trace codes and merged rows swapped back). `band` is one band for
    every job or a sequence of one per job. Jobs the kernels do not
    serve take a host DP and count as host routes. Each (band, M, end-gap
    config) bucket, split at TILE_BYTES, is one K3 and one K3-tb launch;
    on the card all buckets' K3 launches run at once on their own
    streams, then their K3-tb launches, before one copy back. Under an
    active mesh (parallel/dispatch.py) every bucket is cut into
    contiguous chunks, one per device, after the host-route gates."""
    from delly_tpu_torch.utils import torchenv

    sc = sc or DnaScore()
    bands = [band] * len(jobs) if isinstance(band, int) else list(band)
    prep = []
    for a1, a2 in jobs:
        a1, a2 = to_align(a1), to_align(a2)
        swap = a2.shape[1] > a1.shape[1]
        prep.append((a2, a1, True) if swap else (a1, a2, False))
    results = [None] * len(jobs)
    by_bucket = {}
    for idx, (a1, a2, swap) in enumerate(prep):
        m, n = a1.shape[1], a2.shape[1]
        eac = (ac[1], ac[0]) if swap else tuple(ac)
        if a1.shape[0] != 1 or a2.shape[0] != 1 or n < 1:
            # shapes the corridor does not serve (multi-row profiles,
            # an empty sequence): the exact full Gotoh
            dispatch.count("host_routes")
            best, merged = gotoh_full(a1, a2, ac=eac, sc=sc)
            results[idx] = _unswap(best, merged, a1, swap)
            continue
        if (m > max_m or not _ALLOWED.issuperset(a1.tobytes())
                or not _ALLOWED.issuperset(a2.tobytes())):
            dispatch.count("host_routes")
            best, merged = gotoh_banded_host(a1, a2, ac=eac, sc=sc,
                                             band=bands[idx])
            results[idx] = _unswap(best, merged, a1, swap)
            continue
        key = (bands[idx], _bucket_m(m), bool(eac[0]), bool(eac[1]))
        by_bucket.setdefault(key, []).append(idx)
    parts = []
    for (B, M, hfree, vfree), idxs in sorted(by_bucket.items()):
        step = max(1, TILE_BYTES // (M * B))
        parts += [(B, hfree, vfree, idxs[lo:lo + step])
                  for lo in range(0, len(idxs), step)]
    if not parts:
        return results
    mesh = dispatch.get_mesh()
    if mesh is None:
        outs = _run_parts(torchenv.device(), parts, prep, sc)
    else:
        # every part cut into contiguous chunks, one per device; a
        # device runs its chunks of all parts at once, as one device
        # runs the parts
        per = [dispatch.cuts(len(p[3]), int(mesh.devices.size))
               for p in parts]

        def launch(pos, d):
            sub = []
            for (B, hf, vf, idxs), c in zip(parts, per):
                lo, hi = c[pos]
                if hi > lo:
                    sub.append((B, hf, vf, idxs[lo:hi]))
            return _run_parts(d, sub, prep, sc) if sub else None

        outs = [o for r in dispatch.on_mesh(mesh, "gotoh_banded", launch)
                if r is not None for o in r]
    for part, best, codes, lens in outs:
        best = best.cpu().numpy()
        codes = codes.cpu().numpy()
        lens = lens.cpu().numpy()
        for slot, idx in enumerate(part):
            a1, a2, swap = prep[idx]
            fwd_codes = codes[slot, :lens[slot]][::-1].astype(np.int64)
            merged = create_alignment_codes(fwd_codes, a1, a2)
            results[idx] = _unswap(int(best[slot]), merged, a1, swap)
    return results


def _run_parts(dev, parts, prep, sc) -> list:
    """K3 and K3-tb on `dev` for parts [(band, hfree, vfree, job
    indices)] of the prepared jobs: [(job indices, best, codes, lens)],
    tensors on `dev`. On the card every part's K3 runs at once on a
    stream of its own, then every part's K3-tb."""
    # a round of fewer jobs than SMs: one job per SM, none sharing
    spread = dev.type == "cuda" and sum(len(p[3]) for p in parts) <= (
        torch.cuda.get_device_properties(dev).multi_processor_count)

    def forward(B, hfree, vfree, part):
        M = _bucket_m(max(prep[i][0].shape[1] for i in part))
        packed = pack_jobs([prep[i][:2] for i in part], M)
        s1, s2, ml, nl = (torch.from_numpy(x).to(dev) for x in packed)
        host = packed[2:]
        best, bits = banded_forward(s1, s2, ml, nl, B, hfree, vfree,
                                    sc.match, sc.mismatch, sc.go, sc.ge,
                                    spread=spread, host_lengths=host)
        return best, bits, ml, nl, host

    fwd = run_concurrently(dev, [lambda p=p: forward(*p) for p in parts])
    # the walks' streams wait for every forward pass (run_concurrently);
    # the lengths are checked on the host, so nothing here waits for the
    # card and a mesh's next device is launched at once
    walks = run_concurrently(dev, [
        lambda f=f: banded_traceback(*f[1:4], host_lengths=f[4])
        for f in fwd])
    return [(part, best, codes, lens) for (_B, _hf, _vf, part), (best, *_r),
            (codes, lens) in zip(parts, fwd, walks)]


def _unswap(best: int, merged: np.ndarray, a1, swap: bool):
    if not swap:
        return best, merged
    n1 = a1.shape[0]
    return best, np.concatenate([merged[n1:], merged[:n1]], axis=0)
