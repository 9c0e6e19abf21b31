"""svbench: the benchmark of delly_tpu_torch, the PyTorch and CUDA port.

    python3 -m svbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell once on the card: makes the cell's inputs from the seed
and stages them on the card, warms its shapes, measures for `--seconds`
(with `--trace 1` under torch.profiler), checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), device,
with `--trace 1` a breakdown, and last the numbers compared, each with
its limit (also the last lines on standard error).

Exits non-zero, printing no result, without a CUDA card, and when a
module of jax, jaxlib, flax or delly_tpu (the JAX package) is loaded
in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "delly_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: delly_tpu_torch passes."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _cache_dirs(repo: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build into build/kernels)."""
    base = os.path.join(repo, "build", "svbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="svbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from svbench import harness

    _cache_dirs(harness.REPO)
    import torch

    bench = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"svbench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"svbench: this cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found. No result.", file=sys.stderr)
        return 3
    import delly_tpu_torch  # noqa: F401  (fails outside a checkout)

    from svbench.metrics import _peaks

    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device, bench, t_start=T_START)
    card = _peaks.power_limit()
    print(f"svbench: {args.workload} seed {args.seed}, card {card}; peaks "
          f"{_peaks.HBM_BYTES_PER_S:.3e} B/s, {_peaks.INT32_OPS_PER_S:.4e} "
          f"int32 op/s", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"svbench: modules of the JAX package or JAX are loaded: "
              f"{', '.join(bad)}. No result.", file=sys.stderr)
        return 4
    result, checks = out["result"], out["checks"]
    print(f"svbench: loop {json.dumps(result['loop'])}", file=sys.stderr)
    result["device"]["power_limit"] = card
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
