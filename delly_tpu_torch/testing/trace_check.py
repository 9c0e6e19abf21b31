"""Traced CLI runs on the card, one process each, and the card's kernel
records in their traces.

    python -m delly_tpu_torch.testing.trace_check [--seconds 240]

torch.profiler takes the card's kernel and copy records from CUPTI. In a
process that has kept the card busy for a minute or more, its traces of
later runs come back short: kernels that the port's wrappers launched
(parallel/dispatch.py counts them) are missing from the trace, and a run
with one launch may show none at all. This script shows it: it makes
make_lr_sv_dataset and a small make_deep_geno_dataset, then for
`--seconds` alternates 15 s of card work (matrix products and untraced
`lr` runs) with a traced `lr` and a traced `sr -v` in the same process,
and last traces each run again in fresh processes (`start`/`go`/
`finish`). Every traced run prints its launches beside the port's
kernels found in its trace (`port_kernels`); the last line is one JSON
object with the runs whose trace is short, in the long-lived process
and in the fresh ones.

The records' times drift from the profiler's first start in a process
on. utils/profiling.py opens the trace's window a margin around the
run, and the long-lived process still loses records, so profile_run
refuses a second trace in one process; the long-lived process here
lifts that rule before each of its traced runs
(profiling.allow_another_trace). chip_smoke.py therefore traces its
runs through `start`/`go`/
`finish`: each run in a process of its own that first brings CUDA up,
loads every kernel library and starts the profiler once, then waits for
`go`, so that its wall compares with an untraced run in a warm process.
The next process is started about WARMUP_S before the current run is
expected to end (`wait`), so that it is warm then and no older.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the port's kernels by the name their __global__ function has in
# csrc/*.cu (before "_kernel"), to the launch counter of dispatch.py
KERNEL_OF = {"myers_thread": "myers", "myers_lanes": "myers",
             "gotoh": "gotoh", "gotoh_tb": "gotoh_tb",
             "banded": "gotoh_banded", "banded_tb": "gotoh_banded_tb",
             "lcs": "lcs", "gotoh_wide": "gotoh_wide",
             "gotoh_wide_tb": "gotoh_wide_tb"}
COUNTERS = ("myers", "gotoh", "gotoh_tb", "gotoh_banded", "gotoh_banded_tb",
            "lcs", "gotoh_wide", "gotoh_wide_tb")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# seconds that a process of `start` takes to get ready for `go`
WARMUP_S = 20.0


def port_kernels(events) -> dict:
    """{launch counter: kernel records} of the port's kernels among a
    Chrome trace's events (counters with no record left out)."""
    out: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        m = re.search(r"::(\w+?)_kernel\b", e["name"])
        name = KERNEL_OF.get(m.group(1)) if m else None
        if name is not None:
            out[name] = out.get(name, 0) + 1
    return out


def launched(counts: dict) -> dict:
    """The port's kernels that a run launched: {counter: launches}."""
    return {n: counts[n] for n in COUNTERS if counts.get(n)}


def busy_share(trace_path: str, wall_s: float) -> dict:
    """The card's busy share of a traced run: the union of its kernel,
    copy and memset intervals in the Chrome trace that
    DELLY_TPU_PROFILE_TRACE wrote, over the run's wall; with the port's
    kernels found in the trace (port_kernels)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, start, end = 0.0, None, None
    for a, b in spans:
        if start is None or a > end:
            if start is not None:
                busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if start is not None:
        busy += end - start
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_s": busy / 1e6, "share": busy / 1e6 / wall_s,
            "device_events": len(spans),
            "kernels": sum(e.get("cat") == "kernel" for e in events),
            "port_kernels": port_kernels(events),
            "top": [[name[:80], s] for name, s in top]}


def traced_cli(argv, tdir: str, prof: str) -> dict:
    """One CLI run on the card in this process under DELLY_TPU_PROFILE
    and DELLY_TPU_PROFILE_TRACE, between a reset and a read of the launch
    counters: {"rc", "launches", "wall_s" (the run's profile wall),
    "trace" (its Chrome trace)}."""
    import torch

    from delly_tpu_torch.cli import main
    from delly_tpu_torch.parallel import dispatch

    saved = {k: os.environ.get(k) for k in ("DELLY_TPU_PROFILE",
                                            "DELLY_TPU_PROFILE_TRACE")}
    os.environ["DELLY_TPU_PROFILE"] = prof
    os.environ["DELLY_TPU_PROFILE_TRACE"] = tdir
    dispatch.reset()
    try:
        rc = main(list(argv))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counts = dispatch.snapshot()
    with open(prof) as fh:
        wall = json.load(fh)["wall_s"]
    (trace,) = [os.path.join(tdir, f) for f in os.listdir(tdir)]
    return {"rc": rc, "launches": counts, "wall_s": wall, "trace": trace}


def child(job_path: str) -> None:
    """The process of `start`: brings CUDA up, loads every kernel library
    and starts and stops the profiler once (its first start brings CUPTI
    up, which takes seconds), waits for a line on stdin (`go`), runs the
    job's command traced (traced_cli) and writes the result, with the
    seconds from `go` to its end ("traced_s"), to the job's "out"."""
    import torch

    from delly_tpu_torch.ops import _build
    from delly_tpu_torch.utils import profiling

    with open(job_path) as fh:
        job = json.load(fh)
    torch.zeros(1, device="cuda")
    for name in _build.SOURCES:
        _build.load(name)
    profiling._stop_trace(profiling._start_trace())
    sys.stdin.readline()
    t0 = time.time()
    res = traced_cli(job["argv"], job["trace_dir"], job["profile"])
    res["traced_s"] = time.time() - t0
    with open(job["out"], "w") as fh:
        json.dump(res, fh)


def start(argv, stem: str) -> dict:
    """Starts a process that will run `argv` traced (child), its files
    named `stem`.*: it warms up and waits for `go`."""
    job = {"argv": list(argv), "trace_dir": f"{stem}.trace",
           "profile": f"{stem}.profile.json", "out": f"{stem}.out.json"}
    with open(f"{stem}.job.json", "w") as fh:
        json.dump(job, fh)
    with open(f"{stem}.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "delly_tpu_torch.testing.trace_check",
             "--child", f"{stem}.job.json"], cwd=REPO,
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=err,
            text=True)
    return {"proc": proc, "job": job, "stem": stem}


def go(run: dict) -> None:
    """Lets a started process run its command."""
    run["t0"] = time.time()
    run["proc"].stdin.write("\n")
    run["proc"].stdin.close()


def wait(run: dict, seconds: float) -> None:
    """Waits up to `seconds` for a process of `start` that was let go to
    exit."""
    if seconds > 0:
        try:
            run["proc"].wait(timeout=seconds)
        except subprocess.TimeoutExpired:
            pass


def finish(run: dict, timeout: float = 600) -> dict:
    """Waits for a process of `start` that was let go: its result
    (traced_cli) with "call_s", the seconds from `go` to its exit.
    Raises when it did not exit 0 or its command failed."""
    proc = run["proc"]
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    call_s = time.time() - run["t0"]
    if rc != 0:
        with open(f"{run['stem']}.err") as fh:
            raise RuntimeError(f"traced run {run['job']['argv'][:2]} exited "
                               f"{rc}: {fh.read()[-1500:]}")
    with open(run["job"]["out"]) as fh:
        res = json.load(fh)
    if res["rc"] != 0:
        raise RuntimeError(f"traced run {run['job']['argv'][:2]}: the CLI "
                           f"returned {res['rc']}")
    res["call_s"] = call_s
    return res


def stop(run: dict) -> None:
    """Kills a process of `start` that is still running."""
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()


def _measure(seconds: float, fresh: int) -> None:
    import torch

    from delly_tpu_torch.cli import main
    from delly_tpu_torch.ops import _build
    from delly_tpu_torch.testing.synth import (make_deep_geno_dataset,
                                               make_lr_sv_dataset)
    from delly_tpu_torch.utils import profiling

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "")
    os.environ.setdefault("DELLY_TPU_TORCH_DEVICE", "cuda")
    _build.build()
    work = os.path.join(REPO, "build", "trace_check")
    os.makedirs(work, exist_ok=True)
    lr_bam, lr_fa, _ = make_lr_sv_dataset(work)
    dg_bam, dg_fa, _ = make_deep_geno_dataset(
        work, n_contigs=1, contig_len=200_000, dels_per_contig=20,
        coverage=20)
    if main(["sr", "-g", dg_fa, "-o", f"{work}/dg.vcf", dg_bam]):
        raise SystemExit("sr on the deepgeno sites failed")
    cmds = {"lr": ["lr", "-g", lr_fa, "-o", f"{work}/lr.vcf", lr_bam],
            "sr -v": ["sr", "-v", f"{work}/dg.vcf", "-g", dg_fa, "-o",
                      f"{work}/dgv.vcf", dg_bam]}
    rows = []

    def row(where, name, k, res, t):
        b = busy_share(res["trace"], res["wall_s"])
        want = launched(res["launches"])
        rows.append({"where": where, "run": name, "at_s": t,
                     "launches": want, "in_trace": b["port_kernels"],
                     "device_events": b["device_events"],
                     "short": b["port_kernels"] != want})
        print(f"{where} {name} #{k} at {t:.1f}s: launches {want}, in the "
              f"trace {b['port_kernels']}, {b['device_events']} device "
              f"events; wall {res['wall_s']:.3f}s, with the profiler's start "
              f"and export {res.get('traced_s', 0):.3f}s, from go to exit "
              f"{res.get('call_s', 0):.3f}s", flush=True)

    t_start = time.time()
    a = torch.randn(4096, 4096, device="cuda")
    k = 0
    while time.time() - t_start < seconds:
        t1 = time.time()
        while time.time() - t1 < 15:
            (a @ a).sum().item()
            main(cmds["lr"])
        for name, argv in cmds.items():
            stem = f"{work}/inproc{k}_{name.replace(' ', '')}"
            t0 = time.time()
            profiling.allow_another_trace()
            res = traced_cli(argv, f"{stem}.trace", f"{stem}.profile.json")
            res["traced_s"] = time.time() - t0
            row("one process", name, k, res, time.time() - t_start)
        k += 1
    runs = []
    try:
        for i in range(fresh):
            for name, argv in cmds.items():
                runs.append((name, i, start(
                    argv, f"{work}/fresh{i}_{name.replace(' ', '')}")))
        for name, i, run in runs:
            go(run)
            row("fresh process", name, i, finish(run), time.time() - t_start)
    finally:
        for _name, _i, run in runs:
            stop(run)
    print(json.dumps({w: {"runs": sum(r["where"] == w for r in rows),
                          "short": sum(r["short"] for r in rows
                                       if r["where"] == w)}
                      for w in ("one process", "fresh process")}))


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--fresh", type=int, default=6,
                    help="fresh-process traced runs of each command")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.child:
        child(args.child)
    else:
        _measure(args.seconds, args.fresh)


if __name__ == "__main__":
    _cli()
