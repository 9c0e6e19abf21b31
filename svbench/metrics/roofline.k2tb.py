"""roofline.k2tb: the share, in %, of its bound that the kernel of
delly_tpu_torch/csrc/gotoh_tb.cu (K2-tb) reaches in the traced window: the sum over the
window's batches of the bound of their work (svbench/metrics/_work.py)
over the kernel's device seconds by name in the trace. None where the
window ran no such kernel or the trace holds none of its records."""

from svbench.metrics import _roofline


def read(rec):
    return _roofline.share(rec, "k2tb")
