"""Kernel launch counters and the active device mesh of the PyTorch port.

Counters. Each kernel wrapper adds one to its counter where it launches
its kernel, and nowhere else (K1 once per strip of a query longer than
8,192 rows). A run can then show that its main path really went through
the kernels (chip_smoke.py reads them around every run).
``host_routes`` counts MSA merges that took a host DP instead of a
kernel: merges neither profile Gotoh kernel serves (K2 up to 4,096
columns, ``_eligible`` in ops/gotoh_cuda.py; K4 up to 16,384,
``wide_eligible`` in ops/gotoh_wide_cuda.py: letters other than
uppercase ACGTN-, a count product that would break the profile
arithmetic's exactness, or wider than 16,384); long sequence merges
whose corridor would be wider than 4,096 or whose traceback touches the
corridor's edge (ops/msa.py);
and the jobs that ``gotoh_banded_batch`` (ops/gotoh_banded_cuda.py)
sends to a host DP. ``rowscan`` counts the batches of
``batched_edit_distance`` (ops/edist.py) that K1 does not serve and that
take the torch row-scan instead: batches of more than 16 letters (as
the JAX package's Pallas entry point sends them to its row-scan).
Neither is a kernel, so both stand in ``snapshot()`` beside the
kernels, not among them.

Mesh. The active mesh (parallel/mesh.py) is consulted where the JAX
package consults its own: K1 in ``ops/edist.py batched_edit_distance``,
K2/K2-tb in ``ops/gotoh_cuda.py gotoh_batch``, K4/K4-tb in
``ops/gotoh_wide_cuda.py gotoh_wide_batch``, K3/K3-tb in
``ops/gotoh_banded_cuda.py gotoh_banded_batch`` and the CNV window math
in ``parallel/depth_step.py``. Each cuts its job batch into contiguous
chunks, one per device in mesh order, after the gates that choose a
kernel or a host route, runs the same kernel wrapper on each device
(``split_batch``, the role of the JAX package's
``sharded_batched_edit_distance`` and ``sharded_grid_call``) and
gathers the results in job order. Every job's result depends on that
job alone, so a run is byte-identical at any device count. ``hits``
counts, per engine and mesh position, the chunks each device ran (the
role of the JAX package's ``engine_hits``), on the card and on the
host alike, so that a test can assert that every device of the mesh
really worked. A chunk on a card is launched inside
``torch.cuda.device(d)`` with its tensors on d, so the kernels'
C entry points launch on d's stream. Every chunk is launched before
any result is read back (K3's wrappers check the job lengths on their
numpy copies, not on the card), so the cards work at once. A device
that fails to launch raises: its share never moves to another device.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

KERNELS = ("myers", "gotoh", "gotoh_tb", "gotoh_banded", "gotoh_banded_tb",
           "lcs", "gotoh_wide", "gotoh_wide_tb")

launches = Counter()
hits = Counter()            # (engine, mesh position) -> chunks run
_lock = threading.Lock()

_ACTIVE = None
_FACTORY = None


def count(name: str) -> None:
    with _lock:
        launches[name] += 1


def reset() -> None:
    with _lock:
        launches.clear()
        hits.clear()


def snapshot() -> dict:
    return {k: int(launches.get(k, 0))
            for k in KERNELS + ("host_routes", "rowscan")}


def device_snapshot() -> dict:
    """{mesh position: {engine: chunks run}} since the last reset()."""
    out: dict = {}
    with _lock:
        for (engine, pos), n in sorted(hits.items()):
            out.setdefault(pos, {})[engine] = int(n)
    return out


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------

def set_mesh(mesh) -> None:
    """Install `mesh` as the active mesh (None: one device, no split)."""
    global _ACTIVE
    _ACTIVE = mesh


def get_mesh():
    """The active mesh, resolving a pending factory first (the CLI
    installs one, so the devices are listed only when a kernel is about
    to dispatch, after the startup checks)."""
    global _ACTIVE, _FACTORY
    if _ACTIVE is None and _FACTORY is not None:
        factory, _FACTORY = _FACTORY, None
        _ACTIVE = factory()
    return _ACTIVE


@contextlib.contextmanager
def use_mesh_factory(factory):
    """Defer making the mesh until the first get_mesh() call."""
    global _FACTORY
    prev_active, prev_factory = _ACTIVE, _FACTORY
    set_mesh(None)
    _FACTORY = factory
    try:
        yield
    finally:
        set_mesh(prev_active)
        _FACTORY = prev_factory


@contextlib.contextmanager
def use_mesh(mesh):
    prev = _ACTIVE
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def active_devices() -> int:
    """Device count of the active mesh (1 when no mesh is installed)."""
    mesh = get_mesh()
    return int(mesh.devices.size) if mesh is not None else 1


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------

def cuts(n: int, ndev: int) -> list:
    """[(lo, hi)] per device: contiguous chunks of jobs 0..n-1 in order,
    their sizes differing by one at most (the first n % ndev one more)."""
    base, extra = divmod(n, ndev)
    out, lo = [], 0
    for p in range(ndev):
        hi = lo + base + (p < extra)
        out.append((lo, hi))
        lo = hi
    return out


@contextlib.contextmanager
def on_device(dev):
    """The current CUDA device is `dev` inside (nothing on the host)."""
    if dev.type == "cuda":
        import torch
        with torch.cuda.device(dev):
            yield
    else:
        yield


def on_mesh(mesh, engine: str, launch) -> list:
    """launch(pos, dev) for each device of `mesh` in mesh order, inside
    on_device(dev). A launch that returns something other than None ran
    a chunk: one hit of `engine` on device pos. Returns the results in
    mesh order."""
    out = []
    for pos, dev in enumerate(mesh.devices.flat):
        with on_device(dev):
            res = launch(pos, dev)
        if res is not None:
            with _lock:
                hits[(engine, pos)] += 1
        out.append(res)
    return out


def split_batch(mesh, engine: str, n: int, launch) -> list:
    """Jobs 0..n-1 cut into contiguous chunks over the mesh (``cuts``):
    launch(dev, lo, hi) on each device with a non-empty chunk. Returns
    the launches' results in job order."""
    parts = cuts(n, int(mesh.devices.size))

    def one(pos, dev):
        lo, hi = parts[pos]
        return launch(dev, lo, hi) if hi > lo else None

    return [r for r in on_mesh(mesh, engine, one) if r is not None]
