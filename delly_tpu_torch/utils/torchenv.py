"""Device selection for the PyTorch port (counterpart of the JAX
package's utils/jaxenv.py).

The run's device is resolved once, from ``DELLY_TPU_TORCH_DEVICE``:

- ``cuda`` (the default): the first visible GPU, ``cuda:0``. When
  ``torch.cuda.is_available()`` is False the run raises; it never
  carries on on the CPU.
- ``cpu``: every batch runs the kernels' plain PyTorch versions on the
  host (the CPU tests ask for this).

This is the device of everything that is not split over a mesh. The
kernels' job batches go over the active mesh instead when there is one
(parallel/dispatch.py; the CLI makes it from ``DELLY_TPU_MESH``, or
over every visible GPU for large inputs), on the host too: under
``cpu``, ``DELLY_TPU_MESH=N`` lists the CPU N times.
"""

from __future__ import annotations

import os

ENV = "DELLY_TPU_TORCH_DEVICE"
_CHOICES = ("cuda", "cpu")

_device = None


def device():
    """The run's ``torch.device``, resolved on first use."""
    global _device
    if _device is None:
        import torch

        want = os.environ.get(ENV, "cuda").strip().lower() or "cuda"
        if want not in _CHOICES:
            raise ValueError(
                f"{ENV}={want!r}: expected one of {', '.join(_CHOICES)}")
        if want == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"{ENV}=cuda but torch.cuda.is_available() is False; "
                    f"set {ENV}=cpu to run the plain versions on the host")
            _device = torch.device("cuda", 0)
        else:
            _device = torch.device("cpu")
    return _device


def reset() -> None:
    """Forget the resolved device (tests that change the variable)."""
    global _device
    _device = None
