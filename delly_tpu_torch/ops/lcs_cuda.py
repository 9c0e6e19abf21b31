"""X1 wrapper: batched LCS lengths on the card.

Replaces ``delly_tpu/ops/msa.py::_lcs_device_fn`` (:39-66, XLA: a scan
over the rows of a with an in-row prefix max). The kernel is
csrc/lcs.cu: the bit-parallel recurrence of the host's ``lcs_many``
(native/hostio.cpp), one thread per pair, b's bit vector V and its
match masks in scratch buffers that this wrapper allocates. On the H100
its floor is set by integer operations (about seven 32-bit ones per
64-bit word and row of a); the bytes of the pairs weigh far less.

``lcs`` takes tensors: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs the plain version
(ops/msa.py::lcs_plain). ``letter_lut`` codes the letters that occur in
b for it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delly_tpu_torch.ops import _build
from delly_tpu_torch.ops.msa import lcs_plain
from delly_tpu_torch.parallel import dispatch

ABSENT = 255             # letter code of a byte that b lacks
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("lcs")
    if lib.lcs_launch.argtypes is None:
        lib.lcs_launch.argtypes = [_P, _I, _P, _P, _I, _P, _P, _I, _I, _P,
                                   _P, _P, _P]
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


def lcs(a: torch.Tensor, alens: torch.Tensor, b: torch.Tensor,
        blens: torch.Tensor, lut: torch.Tensor, nalpha: int) -> torch.Tensor:
    """(B,) int32 LCS lengths of a[i, :alens[i]] and b[i, :blens[i]], a
    (B, M) and b (B, N) uint8. The kernel codes b's letters through
    `lut` (letter_lut), whose codes of b's bytes must lie below `nalpha`
    (the CPU path checks it; the card's would cost a copy to the
    host)."""
    _check(a, alens, b, blens, lut)
    if not 0 <= nalpha <= 256:
        raise ValueError(f"lcs: nalpha {nalpha}")
    if a.device.type == "cpu":
        n = b.shape[1]
        valid = torch.arange(n)[None, :] < blens.to(torch.int64)[:, None]
        if bool((lut[b.to(torch.int64)][valid] >= nalpha).any()):
            raise ValueError(f"lcs: lut codes a byte of b at or above "
                             f"nalpha {nalpha}")
        return lcs_plain(a, alens, b, blens).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"lcs: unsupported device {a.device}")
    nb, m = a.shape
    n = b.shape[1]
    out = torch.empty(nb, dtype=torch.int32, device=a.device)
    if nb == 0:
        return out
    if m == 0 or n == 0:
        return out.zero_()
    # V and the match masks, word j of a pair at [j][pair]
    words = -(-n // 64)
    v = torch.empty(words * nb, dtype=torch.int64, device=a.device)
    masks = torch.zeros(nalpha * words * nb, dtype=torch.int64,
                        device=a.device)
    rc = _lib().lcs_launch(a.data_ptr(), m, alens.data_ptr(), b.data_ptr(),
                           n, blens.data_ptr(), lut.data_ptr(), nalpha, nb,
                           v.data_ptr(), masks.data_ptr() if nalpha else None,
                           out.data_ptr(), _build.stream_ptr(a.device))
    _build.check(rc, "lcs")
    dispatch.count("lcs")
    return out
