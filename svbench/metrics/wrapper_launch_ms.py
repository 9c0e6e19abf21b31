"""wrapper_launch_ms: host milliseconds a batch inside the launch spans
of the port's kernel wrappers (`<kernel>.launch`: the stream handle,
the ctypes call into the C entry point with the CUDA runtime's launch,
the return code's check and the launch counter), averaged over the
window's batches. The rest of wrapper_span_ms is the wrappers' Python:
checks, plan, allocations and uploads. Traced runs only."""

from svbench.metrics import _spans


def read(rec):
    return _spans.launch_ms(rec)
