"""K1 wrapper: batched Myers edit distance on the card.

Replaces ``delly_tpu/ops/myers_pallas.py::batched_edit_distance_pallas``
(kernel ``_make_pallas`` :247). The kernel is csrc/myers.cu, in two
layouts that ``launch_geometry`` chooses by the query's word count W:
one thread per pair up to 64 query rows (W <= 2), a group of
min(W, 32) lanes per pair above, up to W = 256 (8,192 rows, 8 words a
lane). In the lanes layout word w = l WL + k (word k of lane l, WL words
a lane) updates column s - w at step s, its carry from word w - 1's
column of the step before: a register within a lane, a shuffle of lane
l - 1's top word between lanes. A lane's words so run side by side, a
pair takes tlen + W - 1 steps, and each step loads the next one's Peq
planes and letter ahead of the carry. The targets are staged a pair at
a time into a ring of 8 chunks of 64 columns (`RING_BYTES`) and coded to
letters there. Longer queries (``lr``'s consensus distances of long DUPs
and INSs) run as strips of 8,192 rows, one launch each from the bottom
up, each strip's top carries handed to the next: K1 serves any width. On
the H100 its floor is set by integer operations (~24 per 32-query-row
word and target column); the bytes of the pairs it reads once weigh
less. With few pairs a launch (one warp an SM) a lanes step is bound by
its latency and its one warp's issue instead.

``myers`` takes tensors: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs the plain version
(ops/myers.py::myers_plain). ``batched_edit_distance_myers`` keeps the
numpy contract of the Pallas entry point, ``(queries, qlens, targets,
tlens, mode)``, on the run's device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delly_tpu_torch.ops import _build
from delly_tpu_torch.ops.myers import (MAX_ALPHA, alphabet_lut,
                                       alphabet_size, myers_plain)
from delly_tpu_torch.parallel import dispatch
from delly_tpu_torch.utils import profiling

MAX_WORDS = 256          # words a launch serves: longer queries run in strips
LANES_FROM_WORDS = 4     # W >= 4: a group of lanes per pair
ROW_BYTES = 68           # thread layout: a staged chunk of 64 columns, padded
RING_BYTES = 524         # lanes layout: a pair's ring of 8 chunks, padded
SMEM_MAX = 232_448       # dynamic shared memory one block may use (H100)
_P = ctypes.c_void_p
_I = ctypes.c_int
# host spans (utils/profiling.py): the call and its phases
(_CALL, _CHECK, _PLAN, _ALLOC, _UPLOAD,
 _LAUNCH) = profiling.kernel_spans("myers")
_NP_CALL, _NP_PACK, _NP_H2D, _NP_D2H = profiling.entry_spans(
    "batched_edit_distance_myers")


def _lib():
    lib = _build.load("myers")
    if lib.myers_launch.argtypes is None:
        lib.myers_launch.argtypes = [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.myers_launch.restype = _I
    return lib


def words_bucket(m: int) -> int:
    """Kernel word count for a padded query width: a power of two."""
    need = max(1, -(-m // 32))
    w = 1
    while w < need:
        w *= 2
    return w


def launch_geometry(W: int, nalpha: int = MAX_ALPHA) -> dict:
    """K1's launch for queries of W words and a batch of `nalpha`
    letters: the layout ("thread": a thread per pair, W <= 2; "lanes": a
    group of `lanes` = min(W, 32) lanes per pair, each holding
    `words_per_lane` consecutive words), the `words` of one launch (W,
    or MAX_WORDS for a query run in strips), threads and pairs per
    block, the bytes of staged target columns a pair (`ring_bytes`: two
    padded chunks of 64 in the thread layout, a ring of eight in the
    lanes layout), and the dynamic shared memory: the Peq planes
    (nalpha + 1 of `words` words per pair, the last one empty) and the
    staged columns, twice over in strips (the carries from the strip
    below are staged beside them)."""
    words = min(W, MAX_WORDS)
    if W < LANES_FROM_WORDS:
        lanes, threads, ring = 1, 128, 2 * ROW_BYTES
    else:
        lanes, ring = min(W, 32), RING_BYTES
        threads = 128 if W <= 16 else 32
    pairs = threads // lanes
    rings = 2 if W > MAX_WORDS else 1
    smem = 4 * (nalpha + 1) * words * pairs + rings * pairs * ring
    return {"layout": "thread" if lanes == 1 else "lanes", "lanes": lanes,
            "words": words, "words_per_lane": words // lanes,
            "threads": threads, "pairs": pairs, "ring_bytes": ring,
            "smem": smem}


def _check(q, qlens, t, tlens, lut):
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"myers: q {tuple(q.shape)} and t "
                         f"{tuple(t.shape)} must be (B, M) and (B, N)")
    b = q.shape[0]
    for name, x, dt, shape in (("q", q, torch.uint8, None),
                               ("t", t, torch.uint8, None),
                               ("qlens", qlens, torch.int32, (b,)),
                               ("tlens", tlens, torch.int32, (b,)),
                               ("lut", lut, torch.uint8, (256,))):
        if x.dtype != dt:
            raise TypeError(f"myers: {name} must be {dt}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"myers: {name} must have shape {shape}")
        if x.device != q.device:
            raise ValueError(f"myers: {name} is on {x.device}, q on "
                             f"{q.device}")
        if not x.is_contiguous():
            raise ValueError(f"myers: {name} must be contiguous")


def myers(q: torch.Tensor, qlens: torch.Tensor, t: torch.Tensor,
          tlens: torch.Tensor, lut: torch.Tensor, mode: int,
          nalpha: int = MAX_ALPHA) -> torch.Tensor:
    """(B,) int32 distances of q (B, M) uint8 vs t (B, N) uint8. The
    kernel builds Peq planes for letter codes below `nalpha` only, so it
    must be at least alphabet_size(lut), which callers take it from (the
    CPU path checks it; the card's would cost a copy to the host)."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        _check(q, qlens, t, tlens, lut)
        if mode not in (0, 1, 2):
            raise ValueError(f"myers: mode {mode}")
        if not 0 <= nalpha <= MAX_ALPHA:
            raise ValueError(f"myers: nalpha {nalpha}")
        if s:
            s = profiling.mark(_CHECK, s)
        if q.device.type == "cpu":
            if nalpha < alphabet_size(lut):
                raise ValueError(f"myers: nalpha {nalpha} is below the "
                                 f"{alphabet_size(lut)} letters of lut")
            return myers_plain(q, qlens, t, tlens, lut, mode)
        if q.device.type != "cuda":
            raise ValueError(f"myers: unsupported device {q.device}")
        b, m = q.shape
        n = t.shape[1]
        geo = launch_geometry(words_bucket(m), nalpha)
        w = geo["words"]
        strips = -(-m // (32 * w))
        if s:
            s = profiling.mark(_PLAN, s)
        out = torch.empty(b, dtype=torch.int32, device=q.device)
        if b == 0:
            return out
        # the carries out of a strip's top word, one byte per (pair, column)
        carries = [torch.empty(b * max(n, 1), dtype=torch.int8,
                               device=q.device)
                   for _ in range(min(strips - 1, 2))]
        if s:
            s = profiling.mark(_ALLOC, s)
        lib = _lib()
        for k in range(strips):
            cin = carries[(k - 1) % 2].data_ptr() if k else None
            cout = carries[k % 2].data_ptr() if k + 1 < strips else None
            rc = lib.myers_launch(q.data_ptr(), m, qlens.data_ptr(),
                                  t.data_ptr(), n, tlens.data_ptr(),
                                  lut.data_ptr(), nalpha, b, mode, w,
                                  geo["lanes"], geo["threads"], geo["smem"],
                                  32 * w * k, cin, cout, out.data_ptr(),
                                  _build.stream_ptr(q.device))
            _build.check(rc, "myers")
            dispatch.count("myers")
            if s:
                s = profiling.mark(_LAUNCH, s)
        return out
    finally:
        if s0:
            profiling.mark(_CALL, s0)


def batched_edit_distance_myers(queries, qlens, targets, tlens,
                                mode: int = 0):
    """Numpy contract of the Pallas entry point. Returns (B,) int32, or
    None when the batch has more than MAX_ALPHA letters (the caller
    row-scans those). Under an active mesh (parallel/dispatch.py) the
    batch is cut into contiguous chunks, one per device, after that
    gate, with the whole batch's alphabet on every device."""
    from delly_tpu_torch.utils import torchenv

    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        q = np.ascontiguousarray(np.asarray(queries), dtype=np.uint8)
        t = np.ascontiguousarray(np.asarray(targets), dtype=np.uint8)
        lut = alphabet_lut(q, t)
        if lut is None:
            return None
        ql = np.asarray(qlens, dtype=np.int32)
        tl = np.asarray(tlens, dtype=np.int32)
        nalpha = alphabet_size(lut)
        if s:
            profiling.mark(_NP_PACK, s)

        def launch(dev, lo, hi):
            h = profiling.now() if s0 else 0
            args = (torch.from_numpy(q[lo:hi]).to(dev),
                    torch.as_tensor(ql[lo:hi], device=dev),
                    torch.from_numpy(t[lo:hi]).to(dev),
                    torch.as_tensor(tl[lo:hi], device=dev),
                    torch.from_numpy(lut).to(dev))
            if h:
                profiling.mark(_NP_H2D, h)
            return myers(*args, mode, nalpha)

        mesh = dispatch.get_mesh()
        if mesh is None:
            d = launch(torchenv.device(), 0, len(q))
            s = profiling.now() if s0 else 0
            res = d.cpu().numpy()
        else:
            outs = dispatch.split_batch(mesh, "edist", len(q), launch)
            s = profiling.now() if s0 else 0
            res = np.concatenate([o.cpu().numpy() for o in outs] +
                                 [np.zeros(0, dtype=np.int32)])
        if s:
            profiling.mark(_NP_D2H, s)
        return res
    finally:
        if s0:
            profiling.mark(_NP_CALL, s0)
