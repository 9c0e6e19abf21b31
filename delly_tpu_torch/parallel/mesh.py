"""Device meshes of the PyTorch port (counterpart of the JAX package's
parallel/mesh.py).

A mesh is an ordered list of ``torch.device``s. A job batch split over
it (parallel/dispatch.py ``split_batch``) gives mesh position p the
p-th contiguous chunk of the batch, so the order of the devices is the
order of the results. ``mesh.devices`` is a numpy object array, so that
``mesh.devices.size`` and ``mesh.devices.flat`` read as on a JAX mesh
(models/coral.py reads the size). On the host the tests list the CPU
device N times: the counterpart of the JAX tests' virtual CPU devices.
"""

from __future__ import annotations

import numpy as np


class Mesh:
    """The devices one job batch is split over, in mesh order."""

    def __init__(self, devices):
        devices = list(devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = devices


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over the first `n_devices` of `devices` (every visible GPU
    by default)."""
    import torch

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"a mesh of {n_devices} devices from "
                         f"{len(devices)} visible")
    return Mesh(devices[:n_devices])
