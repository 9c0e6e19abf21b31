"""One process of a host-axis world of the PyTorch port.

    python -m delly_tpu_torch.testing.hostaxis_worker \\
        <process id> <process count> <port> <outdir> <case>

Sets ``DELLY_TPU_COORD=localhost:<port>``, ``DELLY_TPU_NPROC`` and
``DELLY_TPU_PROC_ID``, forms the gloo world (parallel/hostaxis.py
``maybe_init``) and runs the case, then writes what it saw to
``<outdir>/p<process id>.pkl``. The device is whatever
``DELLY_TPU_TORCH_DEVICE`` says (``cpu`` in the tests, the card in
chip_smoke.py). A case is:

- ``primitives``: the helpers themselves (an all-gather of small,
  empty and large payloads, the plan partition, the writer gate,
  ``exchange_owned``);
- a JSON file holding a list of CLI argv lists: each runs through
  ``delly_tpu_torch.cli.main`` in turn, with ``{out}`` replaced by
  ``<outdir>``, and every process meets at a barrier after each step.
  The result holds each step's exit code and, for each ``-o`` output,
  whether this process sees the file.

tests/test_torch_hostaxis.py runs worlds of 1, 2 and 3 processes
through it and holds their outputs equal; chip_smoke.py runs a world of
2 on one card.
"""

from __future__ import annotations

import json
import os
import pickle
import sys


def primitives(hostaxis) -> dict:
    pid = hostaxis.process_index()
    big = bytes(range(256)) * (40 + 7 * pid)   # past the first bucket
    return {
        "gather": hostaxis.allgather_obj({"pid": pid, "data": [pid] * 3}),
        "empty": hostaxis.allgather_obj(b"" if pid else b"x"),
        "big": [len(b) for b in hostaxis.allgather_obj(big)],
        "plan": hostaxis.partition_plan(list(range(7))),
        "writer": hostaxis.is_writer(),
        "merged": hostaxis.exchange_owned(
            {k: f"p{pid}:{k}" for k in range(7) if hostaxis.owns(k)}),
    }


def run_steps(hostaxis, path: str, outdir: str) -> dict:
    from delly_tpu_torch import cli

    with open(path) as fh:
        steps = json.load(fh)
    rcs, outputs = [], {}
    for k, argv in enumerate(steps):
        argv = [a.replace("{out}", outdir) for a in argv]
        rcs.append(cli.main(argv))
        hostaxis.barrier(f"step-{k}")
        out = argv[argv.index("-o") + 1]
        outputs[os.path.basename(out)] = os.path.exists(out)
    return {"rcs": rcs, "outputs": outputs}


def main(argv) -> int:
    pid, nproc, port, outdir, case = argv
    os.environ["DELLY_TPU_COORD"] = f"localhost:{port}"
    os.environ["DELLY_TPU_NPROC"] = nproc
    os.environ["DELLY_TPU_PROC_ID"] = pid
    from delly_tpu_torch.parallel import hostaxis

    formed = hostaxis.maybe_init()
    out = {"formed": formed, "index": hostaxis.process_index(),
           "count": hostaxis.process_count()}
    if case == "primitives":
        out.update(primitives(hostaxis))
    else:
        out.update(run_steps(hostaxis, case, outdir))
    hostaxis.barrier("done")
    with open(os.path.join(outdir, f"p{pid}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
