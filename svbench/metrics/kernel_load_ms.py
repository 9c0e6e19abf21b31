"""kernel_load_ms: host milliseconds of set-up that the port's kernel
libraries cost the run's process (delly_tpu_torch/ops/_build.py
loads): each library's load (with its nvcc build where the checkout had
none) and its first launch, which holds CUDA's lazy load of the
kernels' module. All of it falls before the window, inside setup_s."""

from svbench.metrics import _spans


def read(rec):
    return _spans.load_ms(rec)
