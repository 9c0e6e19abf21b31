"""idle_share.msa: idle_share (svbench/metrics/idle_share.py) in the MSA cells, whose
end-to-end rate is gcups.msa: the host paces them, so their rate spreads
more from run to run than the K1 cells' and takes a bound of its own."""

from svbench.metrics.idle_share import read  # noqa: F401
