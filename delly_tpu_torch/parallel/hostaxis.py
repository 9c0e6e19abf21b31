"""Host axis of the PyTorch port: the single-process identity.

Counterpart of the JAX package's parallel/hostaxis.py for one process.
Its drivers call these helpers unconditionally: models/sr.py,
models/scan.py and models/genotype_sr.py (``process_count``,
``is_writer``, ``partition_plan``, ``exchange_owned``, ``barrier``), and
the ``lr`` drivers models/lr.py, models/assemble.py and
models/genotype_lr.py, which also call ``process_index``, ``owner_of``
and ``allgather_obj`` (``owns`` pairs with ``owner_of`` as in the JAX
package). With one process every helper is the identity, so they
partition nothing and exchange nothing. A
torch.distributed host axis comes in a later slice; until then a
request for more than one process is refused instead of silently
running each process over the whole genome.
"""

from __future__ import annotations

import os


def maybe_init() -> bool:
    """Refuse a multi-process request; returns False (one process)."""
    mode = os.environ.get("DELLY_TPU_DIST", "").strip()
    coord = os.environ.get("DELLY_TPU_COORD", "").strip()
    nproc = os.environ.get("DELLY_TPU_NPROC", "").strip()
    if mode or (coord and nproc != "1"):
        raise RuntimeError(
            "multi-process runs (DELLY_TPU_DIST / DELLY_TPU_COORD) are not "
            "yet in the PyTorch port; run a single process")
    return False


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


def is_writer() -> bool:
    return True


def owner_of(k: int) -> int:
    """Owner process of plan slot k: this one."""
    return 0


def owns(k: int) -> bool:
    return True


def partition_plan(plan: list) -> list:
    return list(plan)


def allgather_obj(obj) -> list:
    """Every process's object, in process order: this one's."""
    return [obj]


def exchange_owned(products: dict) -> dict:
    return dict(products)


def barrier(tag: str = "delly") -> None:
    return None
