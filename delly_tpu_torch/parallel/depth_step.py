"""Read-depth windows over a device mesh: the CNV window math, split
(counterpart of the JAX package's parallel/depth_step.py).

models/coral.py ``_write_windows`` sends its per-window accumulations
through ``depth_windows_on_mesh`` when a mesh is active: the
purity/ploidy-adjusted copy number and the log2 ratio of every genome
window (reference coral.h:296-414). Each device takes its contiguous
chunk of the window axis and computes, in float64, the copy number and
the ratio (cov + 1) / (exp + 1) with ``ops/depth_math.window_cn_ratio``;
the host takes ``window_logr`` of the gathered ratios in numpy. The
route without a mesh runs both in numpy (``window_depth``).

- The result equals the route without a mesh bit for bit by
  construction. The device runs only float64 +, -, * and /, which round
  correctly on the card as on the host, in the same order, and each
  torch operation is a kernel of its own, so nothing fuses into an FMA
  (a division by a Python number would become a product with its
  reciprocal on the card, so none is left).
  The one transcendental, log2, runs in numpy on the host: the card's
  float64 log2 rounds otherwise than numpy's on about a third of the
  values (chip_smoke.py counts them).
- Every output is elementwise in the window axis, so a split over 1 or
  N devices gives the same values.
- The callable-window and coverage tallies are integer-valued float64
  (window counts and sums of integer fragment counts), so their sum
  over the devices is exact in any order: the role of the JAX
  package's psum.
"""

from __future__ import annotations

import numpy as np

from delly_tpu_torch.ops.depth_math import window_cn_ratio, window_logr
from delly_tpu_torch.parallel import dispatch


def depth_windows_shard_fn(covsum, expcov, ok, expected_cn=2.0,
                           purity=1.0, ctrl_ploidy=2.0, chr_ploidy=2.0):
    """Window math of one chunk, on the chunk's device.

    covsum: (W,) float64 fragment-count sum per window (integer-valued)
    expcov: (W,) float64 GC-expected coverage per window
    ok:     (W,) bool window passes the callable gates (coral.h naFlag)

    Returns window_cn_ratio's cn per window (chr_ploidy for windows
    that are not callable or have no expected coverage, as the
    reference's NA values) and ratio, whose log2 the host takes, and the
    chunk's (callable windows, coverage) as a (2,) float64 tensor.
    """
    import torch

    exp = torch.where(ok, expcov, 0.0)
    # a tensor divided by a Python number is multiplied by its reciprocal
    # on the card, which rounds otherwise: purity, the one such divisor,
    # goes in as a tensor on the chunk's device
    pur = torch.tensor(purity, dtype=torch.float64, device=covsum.device)
    cn, ratio = window_cn_ratio(torch, covsum, exp, expected_cn, pur,
                                ctrl_ploidy, chr_ploidy)
    local = torch.stack([ok.to(torch.float64).sum(),
                         torch.where(ok, covsum, 0.0).sum()])
    return cn, ratio, local


def depth_windows_on_mesh(mesh, covsum, expcov, ok, expected_cn: float,
                          purity: float, ctrl_ploidy: float,
                          chr_ploidy: float):
    """The per-window depth math split over `mesh`: host (cn, logr)
    float64 arrays in window order, logr = window_logr of the devices'
    ratios in numpy, and the summed (callable_windows,
    coverage_total) tallies."""
    import torch

    covsum = np.asarray(covsum, dtype=np.float64)
    expcov = np.asarray(expcov, dtype=np.float64)
    ok = np.asarray(ok, dtype=bool)

    def launch(dev, lo, hi):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)
        return depth_windows_shard_fn(put(covsum), put(expcov), put(ok),
                                      expected_cn, purity, ctrl_ploidy,
                                      chr_ploidy)

    parts = dispatch.split_batch(mesh, "cnv_depth", len(covsum), launch)
    empty = [np.zeros(0, dtype=np.float64)]
    cn = np.concatenate([p[0].cpu().numpy() for p in parts] + empty)
    ratio = np.concatenate([p[1].cpu().numpy() for p in parts] + empty)
    logr = window_logr(np, np.where(ok, expcov, 0.0), ratio)
    tot = np.zeros(2, dtype=np.float64)
    for p in parts:
        tot += p[2].cpu().numpy()
    return cn, logr, (int(tot[0]), float(tot[1]))
