"""The program's own host spans (delly_tpu_torch/utils/profiling.py)
and kernel-library set-up record (delly_tpu_torch/ops/_build.py loads),
read in the run's process after the window.

The port records its spans while a torch.profiler session records: in
a traced run on the card, from the window's first wrapper call to its
last. Nothing is read where the run has no card trace, where the
program keeps no such record (a version without spans), or where it
dropped spans past its buffers (a partial sum would read low)."""

from __future__ import annotations

import numpy as np

from svbench.metrics.launches_per_batch import KERNELS


def seconds(rec):
    """{span name: host seconds summed over the window}, or None."""
    if not rec["batches"] or not rec["trace"]:
        return None
    from delly_tpu_torch.utils import profiling

    take = getattr(profiling, "take", None)
    if take is None:
        return None
    got = take()
    if got["dropped"] or not len(got["ids"]):
        return None
    dur = (got["end_ns"] - got["start_ns"]).astype(np.float64)
    secs = np.bincount(got["ids"], weights=dur,
                       minlength=len(got["names"])) / 1e9
    seen = np.bincount(got["ids"], minlength=len(got["names"])) > 0
    return {n: float(s) for n, s, k in zip(got["names"], secs, seen) if k}


def per_batch_ms(rec, names):
    """Host ms a batch inside the spans `names`, or None where the
    window recorded none of them."""
    secs = seconds(rec)
    if secs is None or not any(n in secs for n in names):
        return None
    return sum(secs.get(n, 0.0) for n in names) / rec["batches"] * 1e3


def wrapper_ms(rec):
    """Inside the kernel wrappers' outer spans."""
    return per_batch_ms(rec, KERNELS)


def launch_ms(rec):
    """Inside their launch spans."""
    return per_batch_ms(rec, [f"{k}.launch" for k in KERNELS])


def load_ms(rec):
    """Host ms of the kernel libraries' set-up in this process: each
    load (with its build, where it built) and each first launch."""
    from delly_tpu_torch.ops import _build

    loads = getattr(_build, "loads", None)
    if not loads:
        return None
    return sum(v.get("load_s", 0.0) + v.get("first_launch_s", 0.0)
               for v in loads.values()) * 1e3
