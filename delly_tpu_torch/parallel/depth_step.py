"""Read-depth windows over a device mesh: the CNV window math, split
(counterpart of the JAX package's parallel/depth_step.py).

models/coral.py ``_write_windows`` sends its per-window accumulations
through ``depth_windows_on_mesh`` when a mesh is active: the
purity/ploidy-adjusted copy number and the log2 ratio of every genome
window (reference coral.h:296-414) are computed in float64 on each
device over its contiguous chunk of the window axis, by the same
``ops/depth_math.window_depth`` that the route without a mesh runs with
numpy, here with torch.

- Every output is elementwise in the window axis, so a split over 1 or
  N devices gives the same values.
- The callable-window and coverage tallies are integer-valued float64
  (window counts and sums of integer fragment counts), so their sum
  over the devices is exact in any order: the role of the JAX
  package's psum.
- The coverage file prints cn and logR with ``%g``; a float64 log2 on
  a card that rounds otherwise than numpy's would change a byte only at
  a rounding boundary, and a test holds the file to the route without
  a mesh.
"""

from __future__ import annotations

import numpy as np

from delly_tpu_torch.ops.depth_math import window_depth
from delly_tpu_torch.parallel import dispatch


def depth_windows_shard_fn(covsum, expcov, ok, expected_cn=2.0,
                           purity=1.0, ctrl_ploidy=2.0, chr_ploidy=2.0):
    """Window math of one chunk, on the chunk's device.

    covsum: (W,) float64 fragment-count sum per window (integer-valued)
    expcov: (W,) float64 GC-expected coverage per window
    ok:     (W,) bool window passes the callable gates (coral.h naFlag)

    Returns (cn, logr) per window (chr_ploidy and logR 0 for windows
    that are not callable, as the reference's NA values) and the
    chunk's (callable windows, coverage) as a (2,) float64 tensor.
    """
    import torch

    cn, logr = window_depth(torch, covsum, torch.where(ok, expcov, 0.0),
                            expected_cn, purity, ctrl_ploidy, chr_ploidy)
    local = torch.stack([ok.to(torch.float64).sum(),
                         torch.where(ok, covsum, 0.0).sum()])
    return cn, logr, local


def depth_windows_on_mesh(mesh, covsum, expcov, ok, expected_cn: float,
                          purity: float, ctrl_ploidy: float,
                          chr_ploidy: float):
    """The per-window depth math split over `mesh`: host (cn, logr)
    float64 arrays in window order and the summed (callable_windows,
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
    logr = np.concatenate([p[1].cpu().numpy() for p in parts] + empty)
    tot = np.zeros(2, dtype=np.float64)
    for p in parts:
        tot += p[2].cpu().numpy()
    return cn, logr, (int(tot[0]), float(tot[1]))
