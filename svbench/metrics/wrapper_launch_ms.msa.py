"""wrapper_launch_ms.msa: wrapper_launch_ms
(svbench/metrics/wrapper_launch_ms.py) in the MSA cells, whose
end-to-end rate is gcups.msa."""

from svbench.metrics.wrapper_launch_ms import read  # noqa: F401
