"""K4 and K4-tb: profile Gotoh for MSA merges wider than K2's 4,096
columns, up to 16,384.

Replaces ``delly_tpu/ops/gotoh_device.py`` (X2) over the widths that K2
(ops/gotoh_cuda.py) does not serve: its XLA scan ``_build`` (:35) becomes
csrc/gotoh_wide.cu and its host walk ``_traceback`` (:101)
csrc/gotoh_wide_tb.cu, so the direction tile never leaves the card.
Only the gates that decide the bytes are X2's: the alphabet and the
count product (``gotoh_cuda._exact``); X2's cap of m * n <= 2^26 cells
sized a tile for a TPU and is not kept. Results equal ops.gotoh.gotoh
per job.

A merge's tile is mlen x nlen bytes of direction bits; a launch packs its
merges to the largest of each (columns to a multiple of 16), not to a
square bucket, and holds at most TILE_BUDGET bytes of tiles (``chunks``).
The plain versions are K2's (``gotoh_forward_plain``,
``gotoh_traceback_plain``), which take such rectangular tiles. Each
wrapper launches its kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors.

K4 runs a merge as column strips (``strip_geometry``): a launch of G
merges on a card of S SMs gives each merge P ~ S / G blocks (P = 1 from
G = S on), each holding W columns as C chunks of at most CHUNK_MAX, so
that the G x P blocks fill the card. A chunk keeps its slice of the
target profile in shared memory; its warps run as a wavefront, each
handing every DP row's carry (S, R and the H-opened flag at its last
column) to the next warp through shared memory, and the chunk's last warp
to the next chunk through a ring of row records in global memory, point
to point, never a barrier over the strips; with P > 1 the launch is
cooperative, so every block is on the card at once. The geometry depends
only on G, N and S and changes no byte.

Bounds on the H100: K4 counts K2's 42 integer operations per cell and
writes one byte per cell, so it is bound by operations; a warp's DP row
is a chain of latencies (a shuffle scan, the carry) beside its cells,
and a launch adds the wavefront's fill. K4-tb is a chain of dependent
byte loads per merge (latency), one warp per merge, which reads the bits
as 128 x 128-byte tiles (``tb_geometry``) loaded by the Tensor Memory
Accelerator ahead of the walk.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delly_tpu_torch.ops import _build
from delly_tpu_torch.ops.gotoh import create_alignment_codes
from delly_tpu_torch.ops.gotoh_cuda import (
    MAX_K, _check, _exact, gotoh_forward_plain, gotoh_traceback_plain,
    pack_bucket,
)
from delly_tpu_torch.parallel import dispatch
from delly_tpu_torch.utils import profiling

BUCKETS = (8192, 16384)     # widest dimension of a merge, by launch group
MAX_WIDE = BUCKETS[-1]
TILE_BUDGET = 1 << 31       # bytes of direction bits in one launch
TB_TILE = 128               # K4-tb's tiles: 128 x 128 bytes of a merge's bits
TB_SIDE = 3                 # K4-tb's ring: TB_SIDE x TB_SIDE tiles
CHUNK_MAX = 4096            # K4's widest chunk: 1,024 threads x 4 columns
# K4's narrowest strip: 8 warps of 4 columns a lane, so that an SM's four
# schedulers have two warps each. Narrower strips give a merge more SMs
# but little more speed, since a warp's row is a chain of latencies
# (shuffle scan, carry) that more SMs do not shorten: on the H100 one
# merge of 16,384 columns took 10.98 ms at 512 columns a strip, 11.92 at
# 1,024 and 14.65 at 2,048; three of ~12,200 8.87, 9.73 and 12.44 ms
# (PERF.md, PR 14)
STRIP_FLOOR = 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
# host spans (utils/profiling.py) of each wrapper: the call, then its
# phases check, plan, alloc, upload and launch
(_FWD_CALL, _FWD_CHECK, _FWD_PLAN, _FWD_ALLOC, _FWD_UPLOAD,
 _FWD_LAUNCH) = profiling.kernel_spans("gotoh_wide")
(_TB_CALL, _TB_CHECK, _TB_PLAN, _TB_ALLOC, _TB_UPLOAD,
 _TB_LAUNCH) = profiling.kernel_spans("gotoh_wide_tb")


def wide_eligible(a1: np.ndarray, a2: np.ndarray) -> bool:
    """K4's gate: a merge that K2 refuses only for its width."""
    m, n = a1.shape[1], a2.shape[1]
    return (max(m, n) > MAX_K and 0 < m <= MAX_WIDE and 0 < n <= MAX_WIDE
            and _exact(a1, a2))


def _bucket_w(x: int) -> int:
    return next(b for b in BUCKETS if x <= b)


def tile_shape(ms, ns) -> tuple:
    """(M, N) of a launch's tiles for merges of ms x ns cells: the
    largest of each, N rounded up to a multiple of 16 (K4's rows are
    written 16 bytes a thread)."""
    return max(ms), -(-max(ns) // 16) * 16


def chunks(ms, ns, budget: int | None = None) -> list:
    """Merges of ms[i] x ns[i] cells, in order, cut into runs whose
    tiles, G x M x N bytes (``tile_shape``), fit `budget` (TILE_BUDGET
    when None): [(lo, hi)]. A merge alone always makes a run."""
    budget = TILE_BUDGET if budget is None else budget
    out, lo = [], 0
    for hi in range(1, len(ms) + 1):
        M, N = tile_shape(ms[lo:hi], ns[lo:hi])
        if hi - lo > 1 and (hi - lo) * M * N > budget:
            out.append((lo, hi - 1))
            lo = hi - 1
    if len(ms) > lo:
        out.append((lo, len(ms)))
    return out


def tb_geometry(M: int, N: int) -> tuple:
    """K4-tb's layout for tiles of M x N bytes: (tile side in bytes, ring
    side in tiles, code row bytes, shared memory bytes). The walk reads
    TB_TILE x TB_TILE tiles on a fixed grid, TB_SIDE x TB_SIDE of them in
    its ring, each with an 8-byte barrier; a merge's codes, at most M + N
    <= 2 MAX_WIDE, collect in a static buffer of 2 MAX_WIDE bytes and
    leave in 16-byte stores into rows of M + N bytes rounded up to 16."""
    ring = TB_SIDE * TB_SIDE
    cstride = -(-(M + N) // 16) * 16
    return TB_TILE, TB_SIDE, cstride, ring * (TB_TILE * TB_TILE + 8) + \
        2 * MAX_WIDE


def strip_geometry(G: int, N: int, sms: int) -> tuple:
    """K4's strips for a launch of G merges of N columns on a card of
    `sms` SMs: (P blocks per merge, W columns per block, C chunks per
    block). P = min(sms // G, N // STRIP_FLOOR), at least 1, so G x P <=
    sms while G < sms and P = 1 from G = sms on; the merge's columns are
    Q = P x C chunks of W / C columns (a multiple of 16, at most
    CHUNK_MAX), chunk q on block q mod P, and every chunk starts inside
    the tile. W is a multiple of 16, at least STRIP_FLOOR where N is,
    and P x W >= N."""
    P = max(1, min(sms // max(G, 1), N // STRIP_FLOOR))
    C = -(-N // (P * CHUNK_MAX))
    wc = -(-N // (16 * P * C)) * 16
    return P, C * wc, C


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib(name: str):
    lib = _build.load(name)
    if name == "gotoh_wide" and lib.gotoh_wide_launch.argtypes is None:
        lib.gotoh_wide_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                          _P]
        lib.gotoh_wide_launch.restype = _I
    if name == "gotoh_wide_tb" and lib.gotoh_wide_tb_launch.argtypes is None:
        lib.gotoh_wide_tb_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                             _P, _I, _P, _P]
        lib.gotoh_wide_tb_launch.restype = _I
    return lib


def _check_tile(name: str, M: int, N: int) -> None:
    if not (1 <= M <= MAX_WIDE and 16 <= N <= MAX_WIDE and N % 16 == 0):
        raise ValueError(f"{name}: tile {M} x {N}: rows must be 1..{MAX_WIDE}"
                         f" and columns a multiple of 16 in 16..{MAX_WIDE}")


def gotoh_wide_forward(prof, wc2, d2, mlen, nlen, hfree: bool, vfree: bool,
                       go: int, ge: int):
    """K4: (best (G,) int32, bits (G, M, N) uint8) for prof (G, M, 6),
    wc2 (G, 5, N), d2 (G, N), mlen/nlen (G,), all int32, with 1 <= mlen
    <= M and 1 <= nlen <= N; on the card in ``strip_geometry``'s strips
    for the SMs of the tensors' device."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        G, M, N = prof.shape[0], prof.shape[1], wc2.shape[2]
        _check_tile("gotoh_wide", M, N)
        i32 = torch.int32
        _check("gotoh_wide", prof.device, (
            ("prof", prof, i32, (G, M, 6)), ("wc2", wc2, i32, (G, 5, N)),
            ("d2", d2, i32, (G, N)), ("mlen", mlen, i32, (G,)),
            ("nlen", nlen, i32, (G,))))
        if s:
            s = profiling.mark(_FWD_CHECK, s)
        if prof.device.type == "cpu":
            return gotoh_forward_plain(prof, wc2, d2, mlen, nlen, hfree,
                                       vfree, go, ge)
        if prof.device.type != "cuda":
            raise ValueError(f"gotoh_wide: unsupported device {prof.device}")
        best = torch.empty(G, dtype=i32, device=prof.device)
        bits = torch.empty((G, M, N), dtype=torch.uint8, device=prof.device)
        if s:
            s = profiling.mark(_FWD_ALLOC, s)
        if G == 0:
            return best, bits
        if any(x.data_ptr() % 16 for x in (prof, wc2, d2)):
            raise ValueError("gotoh_wide: prof, wc2 and d2 must be 16-byte "
                             "aligned")
        sms = torch.cuda.get_device_properties(
            prof.device).multi_processor_count
        P, W, C = strip_geometry(G, N, sms)
        if s:
            s = profiling.mark(_FWD_PLAN, s)
        Q = P * C
        # the carry rings: a record of 4 int32 per DP row and chunk
        # boundary
        recs = torch.empty((G, Q - 1, M, 4) if Q > 1 else (4,),
                           dtype=torch.int32, device=prof.device)
        if s:
            s = profiling.mark(_FWD_ALLOC, s)
        rc = _lib("gotoh_wide").gotoh_wide_launch(
            prof.data_ptr(), wc2.data_ptr(), d2.data_ptr(), mlen.data_ptr(),
            nlen.data_ptr(), G, M, N, P, Q, W // C, int(hfree), int(vfree),
            int(go), int(ge), best.data_ptr(), bits.data_ptr(),
            recs.data_ptr(), _build.stream_ptr(prof.device))
        _build.check(rc, "gotoh_wide")
        dispatch.count("gotoh_wide")
        if s:
            profiling.mark(_FWD_LAUNCH, s)
        return best, bits
    finally:
        if s0:
            profiling.mark(_FWD_CALL, s0)


def gotoh_wide_traceback(bits, mlen, nlen):
    """K4-tb: (codes (G, M + N) uint8 in walk order, lens (G,) int32)
    for bits (G, M, N) uint8; on the card the codes are a view of rows
    padded to ``tb_geometry``'s 16-byte multiple."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        G, M, N = bits.shape
        _check_tile("gotoh_wide_tb", M, N)
        _check("gotoh_wide_tb", bits.device, (
            ("bits", bits, torch.uint8, (G, M, N)),
            ("mlen", mlen, torch.int32, (G,)),
            ("nlen", nlen, torch.int32, (G,))))
        if s:
            s = profiling.mark(_TB_CHECK, s)
        if bits.device.type == "cpu":
            return gotoh_traceback_plain(bits, mlen, nlen)
        if bits.device.type != "cuda":
            raise ValueError(
                f"gotoh_wide_tb: unsupported device {bits.device}")
        tile, side, cstride, _smem = tb_geometry(M, N)
        if s:
            s = profiling.mark(_TB_PLAN, s)
        # rows of cstride bytes, for the kernel's 16-byte stores; the
        # caller sees their first M + N
        rows = torch.empty((G, cstride), dtype=torch.uint8,
                           device=bits.device)
        codes = rows[:, :M + N]
        lens = torch.empty(G, dtype=torch.int32, device=bits.device)
        if s:
            s = profiling.mark(_TB_ALLOC, s)
        if G == 0:
            return codes, lens
        if bits.data_ptr() % 16:
            raise ValueError("gotoh_wide_tb: bits must be 16-byte aligned")
        rc = _lib("gotoh_wide_tb").gotoh_wide_tb_launch(
            bits.data_ptr(), mlen.data_ptr(), nlen.data_ptr(), G, M, N, tile,
            side, rows.data_ptr(), cstride, lens.data_ptr(),
            _build.stream_ptr(bits.device))
        _build.check(rc, "gotoh_wide_tb")
        dispatch.count("gotoh_wide_tb")
        if s:
            profiling.mark(_TB_LAUNCH, s)
        return codes, lens
    finally:
        if s0:
            profiling.mark(_TB_CALL, s0)


# ---------------------------------------------------------------------------
# Batch entry point
# ---------------------------------------------------------------------------

def gotoh_wide_batch(jobs, ac, sc) -> list:
    """[(score, merged)] for (a1, a2) jobs that ``wide_eligible`` admits
    (numpy alignment arrays), on the run's device, the same values as
    ops.gotoh.gotoh per job. Jobs are grouped by BUCKETS (the wider of m
    and n); under an active mesh (parallel/dispatch.py) each group is cut
    into contiguous chunks, one per device, and each device runs its
    share in launches of at most TILE_BUDGET bytes of tiles (``chunks``),
    K4 then K4-tb on each."""
    from delly_tpu_torch.utils import torchenv

    results = [None] * len(jobs)
    groups = {}
    for idx, (a1, a2) in enumerate(jobs):
        groups.setdefault(_bucket_w(max(a1.shape[1], a2.shape[1])),
                          []).append(idx)
    dev = torchenv.device()
    mesh = dispatch.get_mesh()
    for _W, idxs in sorted(groups.items()):
        def launch(d, lo, hi, idxs=idxs):
            part = idxs[lo:hi]
            ms = [jobs[i][0].shape[1] for i in part]
            ns = [jobs[i][1].shape[1] for i in part]
            outs = []
            for clo, chi in chunks(ms, ns):
                M, N = tile_shape(ms[clo:chi], ns[clo:chi])
                packed = pack_bucket([jobs[i] for i in part[clo:chi]], M, sc,
                                     N)
                prof, wc2, d2, ml, nl = (torch.from_numpy(x).to(d)
                                         for x in packed)
                best, bits = gotoh_wide_forward(
                    prof, wc2, d2, ml, nl, bool(ac[0]), bool(ac[1]),
                    int(sc.go), int(sc.ge))
                codes, lens = gotoh_wide_traceback(bits, ml, nl)
                del bits            # the next launch may reuse its memory
                outs.append((part[clo:chi], best, codes, lens))
            return outs

        runs = ([launch(dev, 0, len(idxs))] if mesh is None else
                dispatch.split_batch(mesh, "gotoh_wide", len(idxs), launch))
        for outs in runs:
            for part, best, codes, lens in outs:
                best = best.cpu().numpy()
                codes = codes.cpu().numpy()
                lens = lens.cpu().numpy()
                for slot, idx in enumerate(part):
                    a1, a2 = jobs[idx]
                    fwd = codes[slot, :lens[slot]][::-1].astype(np.int64)
                    results[idx] = (int(best[slot]),
                                    create_alignment_codes(fwd, a1, a2))
    return results
