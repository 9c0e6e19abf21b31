"""launches_per_batch.msa: launches_per_batch (svbench/metrics/launches_per_batch.py) in the MSA cells, whose
end-to-end rate is gcups.msa: the host paces them, so their rate spreads
more from run to run than the K1 cells' and takes a bound of its own."""

from svbench.metrics.launches_per_batch import read  # noqa: F401
