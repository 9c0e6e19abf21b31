"""wrapper_span_ms.msa: wrapper_span_ms (svbench/metrics/wrapper_span_ms.py)
in the MSA cells, whose end-to-end rate is gcups.msa."""

from svbench.metrics.wrapper_span_ms import read  # noqa: F401
