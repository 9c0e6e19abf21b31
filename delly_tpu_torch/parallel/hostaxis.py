"""Host axis of the PyTorch port: one run over several OS processes, on
torch.distributed (counterpart of the JAX package's
parallel/hostaxis.py).

Every process owns a deterministic subset of the chromosome plan,
decodes and scans only its own intervals, and the per-interval products
(candidate records, junction tapes, tallies) are exchanged by an
all-gather before the order-sensitive merge replays them identically on
every process. Process 0 alone writes output files. The rules that keep
a run of several processes byte-identical to one process are the JAX
package's:

- ownership is a pure function of (plan position, process count);
- exchanged products are per (file, chromosome), and the consumer
  replays them in the serial (file, chromosome, row) order;
- drivers exchange before any data-dependent work.

Bring-up (``maybe_init``, once per process):

- ``DELLY_TPU_COORD=host:port`` with ``DELLY_TPU_NPROC`` and
  ``DELLY_TPU_PROC_ID``: ``init_process_group("gloo",
  init_method="tcp://host:port")`` with that world size and rank;
- ``DELLY_TPU_DIST=auto``: the ``env://`` rendezvous that ``torchrun``
  sets up (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).

A world that cannot form raises: the port never carries on as one
process, which would make every process scan the whole genome and write
the same files. A world formed by the caller (torch.distributed already
initialized) is used as it is. Without either, every helper is the
one-process identity, so the drivers call them unconditionally.

The backend is gloo, not NCCL: what moves between processes are pickled
host objects, carried as uint8 CPU tensors. Device dispatch is never
collective across processes (each process splits its own job batches
over its own visible cards, cli.py ``_mesh_scope``), so no device
tensor crosses processes, and gloo serves the host and the card machine
alike.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

_INITIALIZED = False


def maybe_init() -> bool:
    """Form the process world from the environment, once. Returns True
    when a world of more than one process is up; raises when one was
    asked for and cannot form."""
    global _INITIALIZED
    if _INITIALIZED:
        return process_count() > 1
    mode = os.environ.get("DELLY_TPU_DIST", "").strip().lower()
    coord = os.environ.get("DELLY_TPU_COORD", "").strip()
    if not mode and not coord:
        return process_count() > 1
    if mode and mode != "auto":
        raise RuntimeError(f"DELLY_TPU_DIST={mode!r}: expected 'auto'")
    import torch.distributed as dist

    try:
        if mode == "auto":
            dist.init_process_group("gloo", init_method="env://")
        else:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coord}",
                world_size=int(os.environ["DELLY_TPU_NPROC"]),
                rank=int(os.environ["DELLY_TPU_PROC_ID"]))
    except (KeyError, ValueError) as exc:
        raise RuntimeError(
            f"multi-process bring-up failed ({type(exc).__name__}: {exc}); "
            f"set DELLY_TPU_COORD, DELLY_TPU_NPROC and DELLY_TPU_PROC_ID, "
            f"or DELLY_TPU_DIST=auto under torchrun") from exc
    _INITIALIZED = True
    return process_count() > 1


def _in_world() -> bool:
    """True when torch.distributed is up, here or by the caller. Never
    imports torch: a process that has not cannot be in a world."""
    if "torch" not in sys.modules:
        return False
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    if not _in_world():
        return 0
    import torch.distributed as dist
    return int(dist.get_rank())


def process_count() -> int:
    if not _in_world():
        return 1
    import torch.distributed as dist
    return int(dist.get_world_size())


def is_writer() -> bool:
    """Only process 0 writes output files (BCF/covfile/stats)."""
    return process_index() == 0


def owner_of(k: int) -> int:
    """Owner process of plan slot k (round-robin: genome chromosome
    order is roughly size-sorted, so striding balances base counts)."""
    return k % process_count()


def owns(k: int) -> bool:
    return owner_of(k) == process_index()


def partition_plan(plan: list) -> list:
    """The subset of `plan` this process owns (plan-slot round-robin).

    Ownership is by PLAN POSITION, not by item value, so any driver
    work list (chromosome indices, files, SV blocks) partitions the
    same way."""
    me, n = process_index(), process_count()
    return [item for k, item in enumerate(plan) if k % n == me]


def _gather_bytes(payload: bytes) -> list:
    """All-gather one bytes payload per process; returns the list in
    process order. The sizes are gathered first; then every process pads
    its payload to the same power-of-two bucket of uint8 (gloo gathers
    equal shapes) and the buckets are gathered."""
    import torch
    import torch.distributed as dist

    n = process_count()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([len(payload)], dtype=torch.int64))
    sizes = [int(s[0]) for s in sizes]
    cap = max(sizes)
    bucket = 1 << max(10, int(np.ceil(np.log2(max(cap, 1)))))
    buf = torch.zeros(bucket, dtype=torch.uint8)
    buf.numpy()[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gathered = [torch.empty(bucket, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(gathered, buf)
    return [gathered[p][:sizes[p]].numpy().tobytes() for p in range(n)]


def allgather_obj(obj):
    """Exchange one picklable object per process; returns the list of
    all processes' objects in process order. Identity at 1 process."""
    if process_count() == 1:
        return [obj]
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return [pickle.loads(b) for b in _gather_bytes(payload)]


def exchange_owned(products: dict) -> dict:
    """Merge per-key products across processes.

    `products` maps work keys (e.g. chromosome index) owned by THIS
    process to their results; the return value maps every key produced
    by any process. Duplicate keys must not occur (ownership is a
    partition); the first producer in process order wins if they do.
    """
    merged: dict = {}
    for part in allgather_obj(products):
        for key, val in part.items():
            merged.setdefault(key, val)
    return merged


def barrier(tag: str = "delly") -> None:
    """Every process waits here for the others (`tag` names the point
    in the caller; gloo's barrier takes no name)."""
    if process_count() == 1:
        return
    import torch.distributed as dist
    dist.barrier()
