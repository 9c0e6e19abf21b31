"""Kernel launch counters of the PyTorch port.

Each kernel wrapper adds one to its counter where it launches its
kernel, and nowhere else (K1 once per strip of a query longer than
8,192 rows), in the manner of the JAX package's
``engine_hits``. A run can then show that its main path really went
through the kernels (chip_smoke.py reads them around the ``sr`` and
``lr`` runs).
``host_routes`` counts MSA merges that took a host DP instead of a
kernel: merges the Gotoh kernel does not serve (``_eligible`` in
ops/gotoh_cuda.py); long sequence merges whose corridor would be wider
than 4,096 or whose traceback touches the corridor's edge (ops/msa.py);
and the jobs that ``gotoh_banded_batch`` (ops/gotoh_banded_cuda.py)
sends to a host DP. ``rowscan`` counts the batches of
``batched_edit_distance`` (ops/edist.py) that K1 does not serve and that
take the torch row-scan instead: batches of more than 16 letters (as
the JAX package's Pallas entry point sends them to its row-scan).
Neither is a kernel, so both stand
in ``snapshot()`` beside the kernels, not among them.

The port has no device mesh yet: every kernel runs on ``cuda:0``, and
``get_mesh()`` says so to the callers that ask (models/coral.py, which
then runs the numpy per-window depth math).
"""

from __future__ import annotations

import threading
from collections import Counter

KERNELS = ("myers", "gotoh", "gotoh_tb", "gotoh_banded", "gotoh_banded_tb")

launches = Counter()
_lock = threading.Lock()


def count(name: str) -> None:
    with _lock:
        launches[name] += 1


def reset() -> None:
    with _lock:
        launches.clear()


def snapshot() -> dict:
    return {k: int(launches.get(k, 0))
            for k in KERNELS + ("host_routes", "rowscan")}


def get_mesh():
    """The active device mesh: None, one device. The JAX package's
    sharded depth step and job batches come with multi-GPU dispatch
    (ROADMAP queue 1, item 7)."""
    return None
