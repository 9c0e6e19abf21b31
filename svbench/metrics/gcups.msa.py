"""gcups.msa: the rate of gcups (svbench/metrics/gcups.py) in the MSA
cells. The host paces them (eleven launches and sixteen copies a batch
against ~0.8 ms of device work), so their rate spreads more from run to
run and from machine to machine than the K1 cells' and takes a bound of
its own."""

from svbench.metrics.gcups import read  # noqa: F401
