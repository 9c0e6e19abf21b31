"""X1 wrapper: batched LCS lengths on the card.

Replaces ``delly_tpu/ops/msa.py::_lcs_device_fn`` (:39-66, XLA: a scan
over the rows of a with an in-row prefix max). The kernel is
csrc/lcs.cu: the bit-parallel recurrence of the host's ``lcs_many``
(native/hostio.cpp), b's bit vector V in registers, a pair on one
thread (b of up to 256 bases) or on a group of lanes (LAYOUTS), its
words running the rows of a as a wavefront, its match masks built by
the kernel in shared memory. On the H100 its floor is set by integer
operations (about seven 32-bit ones per 64-bit word and row of a); the
bytes of the pairs weigh far less.

``lcs`` takes tensors: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs the plain version
(ops/msa.py::lcs_plain). ``letter_lut`` codes the letters that occur in
b for it; ``schedule`` orders a batch by layout.
"""

from __future__ import annotations

import bisect
import ctypes

import numpy as np
import torch

from delly_tpu_torch.ops import _build
from delly_tpu_torch.ops.msa import lcs_plain
from delly_tpu_torch.parallel import dispatch
from delly_tpu_torch.utils import profiling

ABSENT = 255             # letter code of a byte that b lacks
# (lanes per pair, 64-bit words of V per lane), as csrc/lcs.cu kG and kK;
# a pair takes the first layout that holds ceil(n / 64) words, and b
# longer than the last holds runs in strips of STRIP_WORDS words
LAYOUTS = ((1, 1), (1, 2), (1, 3), (1, 4), (2, 4), (4, 4), (8, 4), (16, 4),
           (32, 4), (32, 6), (32, 8))
STRIP_WORDS = 32 * 8
SMEM_MASKS = 64 * 1024   # mask bytes a warp keeps in shared memory
_CAPACITY = tuple(g * k for g, k in LAYOUTS)
_P = ctypes.c_void_p
_I = ctypes.c_int
# host spans (utils/profiling.py): the call and its phases
_CALL, _CHECK, _PLAN, _ALLOC, _UPLOAD, _LAUNCH = profiling.kernel_spans("lcs")


def _lib():
    lib = _build.load("lcs")
    if lib.lcs_launch.argtypes is None:
        lib.lcs_launch.argtypes = [_P, _I, _P, _P, _I, _P, _P, _I, _I, _P,
                                   _P, _I, _P, _P, _P, _P]
        lib.lcs_launch.restype = _I
    return lib


def letter_lut(b: np.ndarray, blens: np.ndarray) -> tuple:
    """(lut, nalpha) for the kernel: the bytes that occur in b's first
    blens[i] positions of each row, coded 0..nalpha-1 in byte order;
    every other byte ABSENT."""
    b = np.asarray(b, dtype=np.uint8)
    valid = np.arange(b.shape[1])[None, :] < np.asarray(blens)[:, None]
    letters = np.flatnonzero(np.bincount(b[valid], minlength=256))
    lut = np.full(256, ABSENT, dtype=np.uint8)
    lut[letters] = np.arange(len(letters))
    return lut, len(letters)


def layout_of(blens) -> np.ndarray:
    """Index into LAYOUTS of each b length: the first layout whose
    G x K words hold ceil(n / 64), the last (strips) beyond."""
    words = (np.asarray(blens, dtype=np.int64) + 63) // 64
    return np.minimum(np.searchsorted(_CAPACITY, words), len(LAYOUTS) - 1)


def _layout(n: int) -> int:
    """layout_of for one b length, without numpy's cost per call (the
    wrapper's host time is the launch's time at deepgeno's shape)."""
    words = (n + 63) // 64
    return min(bisect.bisect_left(_CAPACITY, words), len(LAYOUTS) - 1)


def _segments(lay: np.ndarray) -> list:
    """(layout, first slot, pairs) of each run of one layout."""
    firsts = np.flatnonzero(lay[1:] != lay[:-1]) + 1
    ends = list(firsts) + [len(lay)]
    return [(int(lay[f]), int(f), int(e - f))
            for f, e in zip([0] + list(firsts), ends)]


def schedule(alens, blens) -> tuple:
    """(order, segments) of a batch: `order` sorts the pairs by layout,
    the widest first, then by the length of a, the longest first (so a
    warp's pairs have close lengths and the longest chains start
    first); `segments` lists (layout, first slot, pairs) in that order."""
    lay = layout_of(blens)
    order = np.lexsort((-np.asarray(alens, dtype=np.int64), -lay))
    return order, _segments(lay[order]) if len(order) else []


def warps_of(segs) -> int:
    """Warps (blocks) a launch of these segments takes."""
    return sum(-(-count // (32 // LAYOUTS[lay][0])) for lay, _f, count in segs)


def _check(a, alens, b, blens, lut):
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"lcs: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"must be (B, M) and (B, N)")
    n = a.shape[0]
    for name, x, dt, shape in (("a", a, torch.uint8, None),
                               ("b", b, torch.uint8, None),
                               ("alens", alens, torch.int32, (n,)),
                               ("blens", blens, torch.int32, (n,)),
                               ("lut", lut, torch.uint8, (256,))):
        if x.dtype != dt:
            raise TypeError(f"lcs: {name} must be {dt}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"lcs: {name} must have shape {shape}")
        if x.device != a.device:
            raise ValueError(f"lcs: {name} is on {x.device}, a on "
                             f"{a.device}")
        if not x.is_contiguous():
            raise ValueError(f"lcs: {name} must be contiguous")


def _lengths(a, alens, b, blens, host_lengths):
    """(alens, blens, (min, max) of blens) as numpy arrays: the caller's
    `host_lengths` in place of the card's (nothing is read back from the
    card), the tensors themselves on the host; None for card tensors
    without host lengths. Raises on shapes other than the tensors' and
    on b lengths outside [0, N] (the kernel and the plain version clamp
    a's lengths alike)."""
    if host_lengths is not None:
        al, bl = (np.asarray(x) for x in host_lengths)
        if al.shape != tuple(alens.shape) or bl.shape != tuple(blens.shape):
            raise ValueError(f"lcs: host_lengths have shapes {al.shape} and "
                             f"{bl.shape}, expected {tuple(alens.shape)}")
    elif a.device.type == "cpu":
        al, bl = alens.numpy(), blens.numpy()
    else:
        return None
    span = (int(bl.min()), int(bl.max())) if len(bl) else (0, 0)
    if span[0] < 0 or span[1] > b.shape[1]:
        raise ValueError(f"lcs: b lengths must lie in [0, {b.shape[1]}]")
    return al, bl, span


def lcs(a: torch.Tensor, alens: torch.Tensor, b: torch.Tensor,
        blens: torch.Tensor, lut: torch.Tensor, nalpha: int,
        host_lengths=None) -> torch.Tensor:
    """(B,) int32 LCS lengths of a[i, :alens[i]] and b[i, :blens[i]], a
    (B, M) and b (B, N) uint8. The kernel codes b's letters through
    `lut` (letter_lut), whose codes of b's bytes must lie below `nalpha`
    (the CPU path checks it; the card's would cost a copy to the host).
    `host_lengths`: the numpy alens and blens that the caller uploaded;
    with them the card's launch groups the pairs by layout and length
    (schedule; a batch already in that order needs no permutation on the
    card), without them every pair takes the layout of b's width N."""
    s0 = s = (profiling.begin() if profiling.ON
              or profiling.PROFILER._is_profiler_enabled else 0)
    try:
        _check(a, alens, b, blens, lut)
        if not 0 <= nalpha <= 256:
            raise ValueError(f"lcs: nalpha {nalpha}")
        lengths = _lengths(a, alens, b, blens, host_lengths)
        if s:
            s = profiling.mark(_CHECK, s)
        if a.device.type == "cpu":
            n = b.shape[1]
            valid = torch.arange(n)[None, :] < blens.to(torch.int64)[:, None]
            if bool((lut[b.to(torch.int64)][valid] >= nalpha).any()):
                raise ValueError(f"lcs: lut codes a byte of b at or above "
                                 f"nalpha {nalpha}")
            return lcs_plain(a, alens, b, blens).to(torch.int32)
        if a.device.type != "cuda":
            raise ValueError(f"lcs: unsupported device {a.device}")
        return _launch(a, alens, b, blens, lut, nalpha, lengths, s)
    finally:
        if s0:
            profiling.mark(_CALL, s0)


def _launch(a, alens, b, blens, lut, nalpha, lengths, s=0):
    """One launch of X1 on the tensors' device (checked by lcs); `s`,
    where host spans are on, the start of its first phase."""
    nb, m = a.shape
    n = b.shape[1]
    out = torch.empty(nb, dtype=torch.int32, device=a.device)
    if nb == 0:
        return out
    if m == 0 or n == 0:
        return out.zero_()
    if s:
        s = profiling.mark(_ALLOC, s)
    order = None
    if lengths is None:
        segs = [(_layout(n), 0, nb)]
    else:
        al, bl, span = lengths
        lo, hi = (_layout(x) for x in span)
        lay = layout_of(bl) if lo != hi else None
        if lay is None or (lay[1:] <= lay[:-1]).all():
            # one layout, or grouped by layout: launch in the given order
            segs = [(lo, 0, nb)] if lay is None else _segments(lay)
        else:
            perm, segs = schedule(al, bl)
            if s:
                s = profiling.mark(_PLAN, s)
            order = torch.from_numpy(perm.astype(np.int32)).to(a.device)
            if s:
                s = profiling.mark(_UPLOAD, s)
    warps = warps_of(segs)
    kmax = max(LAYOUTS[lay][1] for lay, _f, _c in segs)
    if s:
        s = profiling.mark(_PLAN, s)
    gmasks = None
    if (nalpha + 1) * kmax * 32 * 8 > SMEM_MASKS:
        gmasks = torch.empty(warps * (nalpha + 1) * kmax * 32,
                             dtype=torch.int64, device=a.device)
    carry = None
    if n > STRIP_WORDS * 64 and any(lay == len(LAYOUTS) - 1
                                    for lay, _f, _c in segs):
        carry = torch.empty(warps * 2 * (-(-m // 32)), dtype=torch.int32,
                            device=a.device)
    if s:
        s = profiling.mark(_ALLOC, s)
    flat = (ctypes.c_int * (3 * len(segs)))(*(v for g in segs for v in g))
    rc = _lib().lcs_launch(
        a.data_ptr(), m, alens.data_ptr(), b.data_ptr(), n, blens.data_ptr(),
        lut.data_ptr(), nalpha, nb,
        None if order is None else order.data_ptr(), flat, len(segs),
        None if gmasks is None else gmasks.data_ptr(),
        None if carry is None else carry.data_ptr(), out.data_ptr(),
        _build.stream_ptr(a.device))
    _build.check(rc, "lcs")
    dispatch.count("lcs")
    if s:
        profiling.mark(_LAUNCH, s)
    return out
