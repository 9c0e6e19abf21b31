"""The readings that a cell's limits are set from: for each seed, the
numbers that decide `correct` for the program's outputs (one pass over
the cell's pool, or its first `batches` batches, at the cell's own
sizes) and for the control, the
plain reference computed approximately (the configuration's
`control`) and put in the program's place.

    python3 -m svbench.control --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--batches N]

Prints one JSON line a seed. The control has to come out not correct;
the program's numbers on sound runs are the lower readings.
"""

from __future__ import annotations

import argparse
import json
import sys

from svbench import harness


def readings(workload: str, seed: int, device, control: bool,
             root: str = harness.SVBENCH, batches: int | None = None) -> dict:
    """{"seed", "program": {name: value}, "control": {name: value}} of
    one seed."""
    cell, config = harness.load_cell(workload, root)
    eng = harness.engine_class(cell["engine"])(cell, config, seed, device,
                                               harness.Spans())
    kept = {}
    for i in range(min(len(eng.pool), batches or len(eng.pool))):
        out = eng.collect(eng.enqueue(i))
        kept[i] = [eng.keep(out)]
    eng.release()
    out = {"seed": seed,
           "program": {k: v for k, (v, _l) in eng.check(kept)[0].items()}}
    if control:
        out["control"] = {k: v for k, (v, _l)
                          in eng.check(kept, control=True)[0].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="svbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--batches", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("svbench.control: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        r = readings(args.workload, seed, device,
                     seed in args.control_seeds, batches=args.batches)
        print(json.dumps(dict(r, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
