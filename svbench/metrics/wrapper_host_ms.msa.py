"""wrapper_host_ms.msa: wrapper_host_ms (svbench/metrics/wrapper_host_ms.py) in the MSA cells, whose
end-to-end rate is gcups.msa: the host paces them, so their rate spreads
more from run to run than the K1 cells' and takes a bound of its own."""

from svbench.metrics.wrapper_host_ms import read  # noqa: F401
