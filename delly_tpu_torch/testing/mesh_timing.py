"""Times each kernel's job batch without a mesh and split over meshes of
1, 2, 4, ... visible cards (parallel/dispatch.py).

    python -m delly_tpu_torch.testing.mesh_timing [--reps 3]

One seeded batch per engine: K1 (``ops/edist.py
batched_edit_distance``, 32,768 pairs of 256 x 512, HW), K2/K2-tb
(``ops/gotoh_cuda.py gotoh_batch``, 2,048 jobs of ~480 bases) and
K3/K3-tb (``ops/gotoh_banded_cuda.py gotoh_banded_batch``, 384 jobs of
~3,000 bases, band 1,024). Each call is timed on the host clock from
the numpy batch to the numpy results (packing, uploads, launches and
read-back included), after one warm-up call; the median of `--reps` is
printed beside the chunks each card ran, and every mesh's results must
equal the run without a mesh. Prints the cards' names and power limits
first and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np


def _dna(rng, n: int) -> np.ndarray:
    return np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]


def _mutate(rng, s: np.ndarray) -> np.ndarray:
    keep = rng.random(len(s)) > 0.05
    out = s[keep].copy()
    sub = rng.random(len(out)) < 0.05
    out[sub] = _dna(rng, int(sub.sum()))
    return out


def batches(seed: int) -> dict:
    """{engine: a call that runs its batch and returns comparable
    results}."""
    from delly_tpu_torch.ops.edist import batched_edit_distance
    from delly_tpu_torch.ops.gotoh import to_align
    from delly_tpu_torch.ops.gotoh_banded_cuda import gotoh_banded_batch
    from delly_tpu_torch.ops.gotoh_cuda import gotoh_batch

    rng = np.random.default_rng(seed)
    b = 32_768
    q = _dna(rng, b * 256).reshape(b, 256)
    t = _dna(rng, b * 512).reshape(b, 512)
    ql = np.full(b, 256, dtype=np.int32)
    tl = np.full(b, 512, dtype=np.int32)

    def pairs(n, lo, hi):
        out = []
        for _ in range(n):
            s = _dna(rng, int(rng.integers(lo, hi)))
            out.append((to_align(s), to_align(_mutate(rng, s))))
        return out

    msa = pairs(2_048, 450, 500)
    banded = pairs(384, 2_900, 3_100)

    def jobs_out(res):
        return [(int(s), m.tobytes()) for s, m in res]

    return {
        "edist": lambda: batched_edit_distance(q, ql, t, tl, 2).tolist(),
        "gotoh_msa": lambda: jobs_out(gotoh_batch(msa, ac=(True, False))),
        "gotoh_banded": lambda: jobs_out(gotoh_banded_batch(
            banded, ac=(True, True), band=1024)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    import torch

    from delly_tpu_torch.parallel import dispatch
    from delly_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        raise SystemExit("mesh_timing: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="")
    ndev = torch.cuda.device_count()
    sizes = [n for n in (1, 2, 4, 8) if n <= ndev]
    result = {"cards": ndev, "engines": {}}
    for engine, run in batches(args.seed).items():
        want = run()                                   # warm-up, no mesh
        rows = {}
        for n in [0] + sizes:
            mesh = make_mesh(n) if n else None
            times = []
            with dispatch.use_mesh(mesh):
                got = run()                            # warm-up
                dispatch.reset()
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    got = run()
                    times.append(time.perf_counter() - t0)
            hits = {p: h.get(engine, 0)
                    for p, h in dispatch.device_snapshot().items()}
            label = f"mesh {n}" if n else "no mesh"
            rows[label] = {"s": statistics.median(times), "all_s": times,
                           "chunks": hits, "equal": got == want}
            print(f"{engine} {label}: {rows[label]['s']:.4f} s "
                  f"(reps {[round(x, 4) for x in times]}), chunks by card "
                  f"{hits}, equal to no mesh: {got == want}", flush=True)
            if got != want:
                raise SystemExit(f"{engine} {label}: results differ")
        result["engines"][engine] = rows
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
