"""K2 and K2-tb: lockstep profile Gotoh for batches of MSA merges.

Replaces ``delly_tpu/ops/gotoh_pallas.py``: the forward kernel
``_build`` (:52) becomes csrc/gotoh.cu, and the XLA traceback walk
``_build_tb`` (:209) becomes csrc/gotoh_tb.cu, so the K x K direction
tile never leaves the card. ``gotoh_batch`` keeps the contract of
``gotoh_pallas.gotoh_batch`` (:295-398): the same ``_eligible`` gate
and 128...4096 K buckets, the profile packing on the host, and
``create_alignment_codes`` on the host. Results equal ops.gotoh.gotoh
per job. Merges that K2 refuses only for their width (more than 4,096
columns, up to 16,384) go to K4/K4-tb (ops/gotoh_wide_cuda.py, the
counterpart of the JAX package's device Gotoh, ops/gotoh_device.py);
only merges wider still, or outside the alphabet and count-product
gates (``_exact``), take the host DP.

Bounds on the H100: the forward pass writes one byte per DP cell and
its recurrence counts 42 integer operations per cell (the exact score's
division among them; the kernel divides by an f32 estimate and one
integer correction), so it is bound by operations; it runs a warp per
merge up to K = 256 and a block of warps with one barrier per DP row
above. The walk is a chain of dependent byte loads per merge (latency):
K2-tb runs one block per merge and reads the rows the walk can touch
from shared-memory windows that ``tb_geometry`` sizes.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs
its plain PyTorch version, in this module, on CPU tensors. All
arithmetic is exact integer: the score is trunc(num / max(d1 * d2, 1)).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delly_tpu_torch.ops import _build
from delly_tpu_torch.ops.gotoh import (
    DnaScore, INF, create_alignment_codes, gotoh as gotoh_host,
    profile_counts, to_align,
)
from delly_tpu_torch.parallel import dispatch
from delly_tpu_torch.utils import profiling

MAX_K = 4096    # largest padded dimension served by the kernel
SMEM_MAX = 232_448          # dynamic shared memory one block may use (H100)
TB_WINDOW_BYTES = 32_768    # K2-tb's window above K = 128
NINF = -INF
_P = ctypes.c_void_p
_I = ctypes.c_int
# host spans (utils/profiling.py) of each wrapper: the call, then its
# phases check, plan, alloc, upload and launch
(_FWD_CALL, _FWD_CHECK, _FWD_PLAN, _FWD_ALLOC, _FWD_UPLOAD,
 _FWD_LAUNCH) = profiling.kernel_spans("gotoh")
(_TB_CALL, _TB_CHECK, _TB_PLAN, _TB_ALLOC, _TB_UPLOAD,
 _TB_LAUNCH) = profiling.kernel_spans("gotoh_tb")
_BATCH_CALL, _BATCH_PACK, _BATCH_H2D, _BATCH_D2H = profiling.entry_spans(
    "gotoh_batch")


def _bucket_k(x: int) -> int:
    b = 128
    while b < x:
        b *= 2
    return b


_ALLOWED = frozenset(b"ACGTN-")  # uppercase only: the host pure-pair path
# scores raw bytes, so case-folded device profiles would diverge on
# soft-masked (lowercase) input; those fall back to the host oracle


def _exact(a1: np.ndarray, a2: np.ndarray) -> bool:
    """The gates that decide the bytes: uppercase ACGTN- only, and
    rows1 * rows2 * 125 < 2^24, which keeps the profile arithmetic
    exact. The kernels' widths decide only where a merge runs."""
    return (a1.shape[0] * a2.shape[0] * 125 < (1 << 24)
            and _ALLOWED.issuperset(a1.tobytes())
            and _ALLOWED.issuperset(a2.tobytes()))


def _eligible(a1: np.ndarray, a2: np.ndarray) -> bool:
    """K2's gate."""
    m, n = a1.shape[1], a2.shape[1]
    return 0 < m <= MAX_K and 0 < n <= MAX_K and _exact(a1, a2)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def gotoh_forward_plain(prof, wc2, d2, mlen, nlen, hfree: bool,
                        vfree: bool, go: int, ge: int):
    """Forward DP over a batch: (best (G,) int32, bits (G, M, N) uint8)
    for prof (G, M, 6), wc2 (G, 5, N), d2 (G, N): K2's square tiles (M =
    N = K) and K4's (ops/gotoh_wide_cuda.py) alike. Rows above a merge's
    mlen are left zero. int32 as in the kernels; the profile scores of
    256 rows at a time, their numerators from one float64 product
    (exact: every term is an integer far below 2^53)."""
    block = 256
    dev = prof.device
    G, M, _ = prof.shape
    N = wc2.shape[2]
    i32 = torch.int32
    col = torch.arange(1, N + 1, dtype=i32, device=dev)[None, :]
    ml = mlen.to(torch.int64)
    nl = nlen.to(torch.int64)[:, None]
    if vfree:
        vfc = col == nl
        vg_open = torch.where(vfc, 0, go + ge).to(i32)
        vg_ext = torch.where(vfc, 0, ge).to(i32)
    else:
        vg_open = torch.full((1, N), go + ge, dtype=i32, device=dev)
        vg_ext = torch.full((1, N), ge, dtype=i32, device=dev)
    w = wc2.to(torch.float64)
    dd = d2.to(torch.int64)[:, None, :]
    S = (torch.zeros((G, N), dtype=i32, device=dev) if hfree
         else (go + col * ge).expand(G, N).clone())
    V = torch.full((G, N), NINF, dtype=i32, device=dev)
    best = torch.full((G,), NINF, dtype=i32, device=dev)
    bits = torch.zeros((G, M, N), dtype=torch.uint8, device=dev)
    ninf_col = torch.full((G, 1), NINF, dtype=i32, device=dev)
    mmax = int(ml.max()) if G else 0
    for r0 in range(0, mmax, block):
        p = prof[:, r0:min(r0 + block, mmax)].to(torch.int64)
        num = torch.bmm(p[:, :, :5].to(torch.float64), w).to(torch.int64)
        den = torch.clamp(p[:, :, 5:6] * dd, min=1)
        q = torch.div(num.abs(), den, rounding_mode="floor")
        scores = torch.where(num < 0, -q, q).to(i32)
        for r in range(r0 + 1, r0 + p.shape[1] + 1):
            score = scores[:, r - 1 - r0]
            if hfree:
                rf = (ml == r)[:, None]
                O = torch.where(rf, 0, go + ge).to(i32)
                E = torch.where(rf, 0, ge).to(i32)
            else:
                O, E = go + ge, ge
            s_r0 = 0 if vfree else go + r * ge
            s_r0_prev = 0 if (vfree or r == 1) else go + (r - 1) * ge
            Vn = torch.maximum(S + vg_open, V + vg_ext)
            Sd = torch.cat([torch.full((G, 1), s_r0_prev, dtype=i32,
                                       device=dev), S[:, :-1]], dim=1)
            t = torch.maximum(Sd + score, Vn)
            zin = torch.cat([torch.full((G, 1), s_r0, dtype=i32, device=dev),
                             (t - col * E)[:, :-1]], dim=1)
            H = torch.cummax(zin, dim=1).values + (col - 1) * E + O
            Sn = torch.maximum(t, H)
            Hp = torch.cat([ninf_col, H[:, :-1]], dim=1)
            u8 = torch.uint8
            b = ((Sn == H).to(u8) | ((Sn == Vn).to(u8) << 1)
                 | ((H != Hp + E).to(u8) << 2)
                 | ((Vn != V + vg_ext).to(u8) << 3))
            live = (r <= ml)[:, None]
            bits[:, r - 1] = torch.where(live, b, 0)
            best = torch.where(ml == r, Sn.gather(1, nl - 1).squeeze(1),
                               best)
            S, V = Sn, Vn
    return best, bits


def gotoh_traceback_plain(bits, mlen, nlen):
    """Lockstep walk over a batch of tiles (G, M, N): (codes (G, M + N)
    uint8 in walk order, lens (G,) int32). Same preference order as the
    kernels K2-tb and K4-tb."""
    dev = bits.device
    G, M, N = bits.shape
    i64 = torch.int64
    L, cap = M + N, 2 * (M + N) + 8
    flat = bits.reshape(G, M * N)
    row = mlen.to(i64).clone()
    col = nlen.to(i64).clone()
    last = torch.zeros(G, dtype=i64, device=dev)
    i = torch.zeros(G, dtype=i64, device=dev)
    codes = torch.zeros((G, L), dtype=torch.uint8, device=dev)
    for _ in range(cap):
        alive = ((row > 0) | (col > 0)) & (i < L)
        if not bool(alive.any()):
            break
        interior = (row > 0) & (col > 0)
        idx = (row - 1).clamp(min=0) * N + (col - 1).clamp(min=0)
        b = torch.where(interior, flat.gather(1, idx[:, None]).squeeze(1)
                        .to(i64), 0)
        is_s, is_h, is_v = last == 0, last == 1, last == 2
        go_h = ((row == 0) & (col > 0)) | (interior & ((b & 1) != 0))
        go_v = ~go_h & (((col == 0) & (row > 0))
                        | (interior & ((b & 2) != 0)))
        s_move = is_s & ~go_h & ~go_v
        h_open = torch.where(row == 0, col == 1, (b & 4) != 0)
        v_open = torch.where(col == 0, row == 1, (b & 8) != 0)
        new_last = torch.where(
            is_s, torch.where(go_h, 1, torch.where(go_v, 2, 0)),
            torch.where(is_h, torch.where(h_open, 0, 1),
                        torch.where(v_open, 0, 2)))
        emit = alive & (s_move | is_h | is_v)
        code = torch.where(s_move, 0, torch.where(is_h, 1, 2))
        slot = i.clamp(max=L - 1)[:, None]
        cur = codes.gather(1, slot).squeeze(1).to(i64)
        codes.scatter_(1, slot, torch.where(emit, code, cur)[:, None]
                       .to(torch.uint8))
        dec_r = (alive & (s_move | is_v)).to(i64)
        dec_c = (alive & (s_move | is_h)).to(i64)
        row = row - dec_r
        col = col - dec_c
        last = torch.where(alive, new_last, last)
        i = i + emit.to(i64)
    return codes, i.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib(name: str):
    lib = _build.load(name)
    if name == "gotoh" and lib.gotoh_launch.argtypes is None:
        lib.gotoh_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _P, _P, _P]
        lib.gotoh_launch.restype = _I
    if name == "gotoh_tb" and lib.gotoh_tb_launch.argtypes is None:
        lib.gotoh_tb_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P,
                                        _P]
        lib.gotoh_tb_launch.restype = _I
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


def _check_k(name: str, K: int) -> None:
    if K not in (128, 256, 512, 1024, 2048, MAX_K):
        raise ValueError(f"{name}: K={K} is not a power of two in "
                         f"128..{MAX_K}")


def tb_geometry(K: int) -> tuple:
    """K2-tb's shared-memory windows for tiles of K x K bytes: (rows per
    window, windows in flight, dynamic shared memory bytes: the windows
    and the walk's 2K codes). At K = 128 the whole tile (16 KB) is one
    window, so ~13 walks share an SM; above it two windows of
    TB_WINDOW_BYTES (whole rows) are in flight."""
    rows, stages = (K, 1) if K * K <= 16_384 else (TB_WINDOW_BYTES // K, 2)
    return rows, stages, stages * rows * K + 2 * K


def gotoh_forward(prof, wc2, d2, mlen, nlen, hfree: bool, vfree: bool,
                  go: int, ge: int):
    """K2: (best (G,) int32, bits (G, K, K) uint8) for prof (G, K, 6),
    wc2 (G, 5, K), d2 (G, K), mlen/nlen (G,), all int32."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        G, K = prof.shape[0], prof.shape[1]
        _check_k("gotoh", K)
        i32 = torch.int32
        _check("gotoh", prof.device, (
            ("prof", prof, i32, (G, K, 6)), ("wc2", wc2, i32, (G, 5, K)),
            ("d2", d2, i32, (G, K)), ("mlen", mlen, i32, (G,)),
            ("nlen", nlen, i32, (G,))))
        if s:
            s = profiling.mark(_FWD_CHECK, s)
        if prof.device.type == "cpu":
            return gotoh_forward_plain(prof, wc2, d2, mlen, nlen, hfree,
                                       vfree, go, ge)
        if prof.device.type != "cuda":
            raise ValueError(f"gotoh: unsupported device {prof.device}")
        best = torch.empty(G, dtype=i32, device=prof.device)
        bits = torch.empty((G, K, K), dtype=torch.uint8, device=prof.device)
        if G == 0:
            return best, bits
        if s:
            s = profiling.mark(_FWD_ALLOC, s)
        rc = _lib("gotoh").gotoh_launch(
            prof.data_ptr(), wc2.data_ptr(), d2.data_ptr(), mlen.data_ptr(),
            nlen.data_ptr(), G, K, int(hfree), int(vfree), int(go), int(ge),
            best.data_ptr(), bits.data_ptr(), _build.stream_ptr(prof.device))
        _build.check(rc, "gotoh")
        dispatch.count("gotoh")
        if s:
            profiling.mark(_FWD_LAUNCH, s)
        return best, bits
    finally:
        if s0:
            profiling.mark(_FWD_CALL, s0)


def gotoh_traceback(bits, mlen, nlen):
    """K2-tb: (codes (G, 2K) uint8 in walk order, lens (G,) int32)."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        G, K = bits.shape[0], bits.shape[1]
        _check_k("gotoh_tb", K)
        _check("gotoh_tb", bits.device, (
            ("bits", bits, torch.uint8, (G, K, K)),
            ("mlen", mlen, torch.int32, (G,)),
            ("nlen", nlen, torch.int32, (G,))))
        if s:
            s = profiling.mark(_TB_CHECK, s)
        if bits.device.type == "cpu":
            return gotoh_traceback_plain(bits, mlen, nlen)
        if bits.device.type != "cuda":
            raise ValueError(f"gotoh_tb: unsupported device {bits.device}")
        codes = torch.empty((G, 2 * K), dtype=torch.uint8, device=bits.device)
        lens = torch.empty(G, dtype=torch.int32, device=bits.device)
        if G == 0:
            return codes, lens
        if s:
            s = profiling.mark(_TB_ALLOC, s)
        if bits.data_ptr() % 16:
            raise ValueError("gotoh_tb: bits must be 16-byte aligned")
        rows, stages, _smem = tb_geometry(K)
        if s:
            s = profiling.mark(_TB_PLAN, s)
        rc = _lib("gotoh_tb").gotoh_tb_launch(
            bits.data_ptr(), mlen.data_ptr(), nlen.data_ptr(), G, K, rows,
            stages, codes.data_ptr(), lens.data_ptr(),
            _build.stream_ptr(bits.device))
        _build.check(rc, "gotoh_tb")
        dispatch.count("gotoh_tb")
        if s:
            profiling.mark(_TB_LAUNCH, s)
        return codes, lens
    finally:
        if s0:
            profiling.mark(_TB_CALL, s0)


# ---------------------------------------------------------------------------
# Batch entry point
# ---------------------------------------------------------------------------

def pack_bucket(jobs: list, K: int, sc: DnaScore, N: int | None = None):
    """Host packing of one K bucket (K rows and N = K columns, or N given):
    query profiles on the DP-row axis (A,C,G,T,N counts and the depth),
    the score-weighted target profile, the target depth, and the lengths
    (numpy int32)."""
    G = len(jobs)
    N = K if N is None else N
    prof = np.zeros((G, K, 6), dtype=np.int32)
    c2 = np.zeros((G, 5, N), dtype=np.int32)
    d2 = np.zeros((G, N), dtype=np.int32)
    ml = np.zeros(G, dtype=np.int32)
    nl = np.zeros(G, dtype=np.int32)
    for gi, (a1, a2) in enumerate(jobs):
        cc1, dd1 = profile_counts(a1)
        cc2, dd2 = profile_counts(a2)
        m, n = a1.shape[1], a2.shape[1]
        prof[gi, :m, 0:5] = cc1[:5].T
        prof[gi, :m, 5] = dd1
        c2[gi, :, :n] = cc2[:5]
        d2[gi, :n] = dd2
        ml[gi] = m
        nl[gi] = n
    w = np.full((5, 5), int(sc.mismatch), dtype=np.int32)
    np.fill_diagonal(w, int(sc.match))
    wc2 = np.einsum("ab,gbk->gak", w, c2).astype(np.int32)
    return prof, wc2, d2, ml, nl


def gotoh_batch(jobs, ac=(False, False), sc: DnaScore | None = None):
    """Batched gotoh() over a list of (a1, a2) jobs on the run's device:
    [(score, merged)] with the same values as ops.gotoh.gotoh per job.
    Jobs of up to 4,096 columns run on K2/K2-tb, wider ones of up to
    16,384 on K4/K4-tb (gotoh_wide_cuda.gotoh_wide_batch). Jobs neither
    serves (exotic alphabet, count-product overflow, wider than 16,384)
    take the host DP individually and count as host routes. Under an
    active mesh (parallel/dispatch.py) each K bucket is cut into
    contiguous chunks, one per device, after that gate."""
    s0 = (profiling.begin() if profiling.ON
          or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        return _gotoh_batch(jobs, ac, sc, s0)
    finally:
        if s0:
            profiling.mark(_BATCH_CALL, s0)


def _gotoh_batch(jobs, ac, sc, s0):
    from delly_tpu_torch.ops.gotoh_wide_cuda import (
        gotoh_wide_batch, wide_eligible,
    )
    from delly_tpu_torch.utils import torchenv

    sc = sc or DnaScore()
    jobs = [(to_align(a1), to_align(a2)) for a1, a2 in jobs]
    results = [None] * len(jobs)
    by_bucket, wide = {}, []
    for idx, (a1, a2) in enumerate(jobs):
        if _eligible(a1, a2):
            K = _bucket_k(max(a1.shape[1], a2.shape[1]))
            by_bucket.setdefault(K, []).append(idx)
        elif wide_eligible(a1, a2):
            wide.append(idx)
        else:
            dispatch.count("host_routes")
            results[idx] = gotoh_host(a1, a2, ac=ac, sc=sc)
    if wide:
        for idx, res in zip(wide, gotoh_wide_batch(
                [jobs[i] for i in wide], ac, sc)):
            results[idx] = res
    dev = torchenv.device()
    mesh = dispatch.get_mesh()
    for K, idxs in sorted(by_bucket.items()):
        def launch(d, lo, hi, K=K, idxs=idxs):
            part = idxs[lo:hi]
            h = profiling.now() if s0 else 0
            packed = pack_bucket([jobs[i] for i in part], K, sc)
            if h:
                h = profiling.mark(_BATCH_PACK, h)
            prof, wc2, d2, ml, nl = (torch.from_numpy(x).to(d)
                                     for x in packed)
            if h:
                profiling.mark(_BATCH_H2D, h)
            best, bits = gotoh_forward(prof, wc2, d2, ml, nl, bool(ac[0]),
                                       bool(ac[1]), int(sc.go), int(sc.ge))
            codes, lens = gotoh_traceback(bits, ml, nl)
            return part, best, codes, lens

        outs = ([launch(dev, 0, len(idxs))] if mesh is None else
                dispatch.split_batch(mesh, "gotoh_msa", len(idxs), launch))
        for part, best, codes, lens in outs:
            h = profiling.now() if s0 else 0
            best = best.cpu().numpy()
            codes = codes.cpu().numpy()
            lens = lens.cpu().numpy()
            if h:
                profiling.mark(_BATCH_D2H, h)
            for slot, idx in enumerate(part):
                a1, a2 = jobs[idx]
                fwd = codes[slot, :lens[slot]][::-1].astype(np.int64)
                results[idx] = (int(best[slot]),
                                create_alignment_codes(fwd, a1, a2))
    return results
