"""wrapper_span_ms: host milliseconds a batch inside the port's kernel
wrappers (ops/myers_cuda.py, ops/lcs_cuda.py, ops/gotoh_cuda.py), read
from the program's own outer span of each call (one a call, named after
the kernel's launch counter; delly_tpu_torch/utils/profiling.py): the
inside counterpart of wrapper_host_ms, averaged over the window's
batches. Traced runs only: the spans record while torch.profiler does."""

from svbench.metrics import _spans


def read(rec):
    return _spans.wrapper_ms(rec)
