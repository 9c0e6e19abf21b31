"""svbench's harness: find a cell's files by name, build its pool, warm
it, run the measured window, trace it on request, check the outputs
against the plain reference, and read the metrics.

A cell `<name>` is `svbench/workloads/<name>.json`; it names its
configuration (`svbench/configs/<config>.json`), its engine
(`svbench/engines/<engine>.py`, class `Engine`) and its traffic. The
metrics a run reports are those of BENCHMARK.json whose `workloads`
list the cell, or that list none: end-to-end ones untraced, per-layer
ones traced; each is read by `svbench/metrics/<metric>.py`, whose
`read(rec)` returns a number or None (nothing to read: left out).

The window is a closed loop with two batches in flight: batch i + 1 is
enqueued before the harness waits for batch i's outputs on the host.
Batches cycle over the engine's pool of distinct pre-staged batches.
A traced run records the card's activity alone (no host operators),
between two marker kernels that bound the window.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import time
from collections import deque

import numpy as np

SVBENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SVBENCH)
WORK_DIR = os.path.join(REPO, "build", "svbench")
TRACE_MARGIN_S = 0.5
MARK_CYCLES = 1000       # the window's marker kernels, ~0.5 us each


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = SVBENCH) -> tuple:
    """(cell, config) of the cell `name` under `root`."""
    cell = load_json(os.path.join(root, "workloads", f"{name}.json"))
    config = load_json(os.path.join(root, "configs",
                                    f"{cell['config']}.json"))
    return cell, config


def engine_class(name: str):
    return importlib.import_module(f"svbench.engines.{name}").Engine


def metric_reader(name: str, root: str = SVBENCH):
    """The `read` function of svbench/metrics/<name>.py."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "svbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The BENCHMARK.json entries that this cell reports in this kind of
    run."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


class Spans:
    """Host seconds inside the port's wrappers, around each call before
    its return (svbench's own spans on the host's clock; nothing waits
    for the card, and nothing is recorded in the trace)."""

    def __init__(self):
        self.seconds = 0.0

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0


def _mark(traced: bool) -> None:
    """A marker kernel on the card that bounds the traced window (see
    svbench/trace.py): one short spin, a kernel no cell runs."""
    if traced:
        import torch
        torch.cuda._sleep(MARK_CYCLES)


def _launches():
    from delly_tpu_torch.parallel import dispatch
    return dispatch.snapshot()


class Keeper:
    """Which window outputs the reference checks: the first `head`
    batches (the pool's first two rounds, at most half of `cap`), a
    uniform sample of `cap - head` of the later ones drawn from the seed
    as the window goes (reservoir sampling, so that the sample spreads
    over the whole window whatever its length), and the last batch."""

    def __init__(self, eng, pool: int, cap: int, seed: int):
        self.eng = eng
        self.head = min(2 * pool, cap // 2)
        self.size = max(cap - self.head, 0)
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 99])
        self.first: list = []      # (pool index, output) of the head
        self.sample: list = []     # the reservoir's
        self.seen = 0
        self.last = None

    def offer(self, k: int, i: int, out, last: bool) -> None:
        if k < self.head:
            self.first.append((i, self.eng.keep(out)))
            return
        t = self.seen
        self.seen += 1
        slot = t if t < self.size else int(self.rng.integers(0, t + 1))
        if slot < self.size:
            kept = (i, self.eng.keep(out))
            if slot == len(self.sample):
                self.sample.append(kept)
            else:
                self.sample[slot] = kept
        elif last:
            self.last = (i, self.eng.keep(out))

    def by_pool(self) -> dict:
        """{pool index: [outputs]}."""
        out: dict = {}
        tail = [self.last] if self.last is not None else []
        for i, o in self.first + self.sample + tail:
            out.setdefault(i, []).append(o)
        return out


def window(eng, seconds: float, seed: int, traced: bool = False,
           keep_cap: int = 64) -> dict:
    """Run the closed loop for `seconds`: {batches, cells, window_s,
    latencies_s, work, kept}. Stops enqueueing when the time is up and
    waits for the batches in flight, whose time and work count."""
    P = len(eng.pool)
    keeper = Keeper(eng, P, keep_cap, seed)
    lat, work = [], {}
    cells = 0
    inflight: deque = deque()
    _mark(traced)
    t0 = time.perf_counter()

    def enq(n):
        inflight.append((n, time.perf_counter(), eng.enqueue(n % P)))

    enq(0)
    n = 1
    while inflight:
        if time.perf_counter() - t0 < seconds:
            enq(n)
            n += 1
        k, t, h = inflight.popleft()
        out = eng.collect(h)
        lat.append(time.perf_counter() - t)
        cells += eng.cells(k % P)
        for key, w in eng.work(k % P).items():
            work[key] = work.get(key, 0.0) + w
        keeper.offer(k, k % P, out, not inflight)
    t1 = time.perf_counter()
    _mark(traced)
    return {"batches": len(lat), "cells": cells, "window_s": t1 - t0,
            "latencies_s": lat, "work": work, "kept": keeper.by_pool()}


def _trace_start():
    """torch.profiler with CUDA activity alone: the card's kernels,
    copies and memsets and the CUDA runtime calls, with no record of the
    host's operators and no correlation of them to the card's work, so
    that the traced loop runs near the untraced rate (the profiler still
    costs each runtime call some microseconds)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(
                       disable_external_correlation=True))
    prof.start()
    time.sleep(TRACE_MARGIN_S)
    return prof


def _trace_stop(prof, device) -> dict:
    import torch

    from svbench import trace as trace_mod

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    time.sleep(TRACE_MARGIN_S)
    prof.stop()
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return trace_mod.read(path)
    finally:
        os.remove(path)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        bench: dict, root: str = SVBENCH,
        t_start: float | None = None) -> dict:
    """One run of a cell: {result, checks}. `result` holds every key of
    the printed line but `checks`; `checks` is {name: (value, limit)}."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell, config = load_cell(workload, root)
    spans = Spans()
    eng = engine_class(cell["engine"])(cell, config, seed, device, spans)
    for i in range(len(eng.pool)):
        out = eng.collect(eng.enqueue(i))
        if hasattr(eng, "warmed"):
            eng.warmed(i, out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    spans.seconds = 0.0
    # the card's trace; a run on the host (the tests) has none to read
    on_card = trace and device.type == "cuda"
    prof = _trace_start() if on_card else None
    before = _launches()
    setup_s = time.perf_counter() - t_start
    win = window(eng, seconds, seed, on_card,
                 int(cell.get("keep_cap", 64)))
    after = _launches()
    traced = _trace_stop(prof, device) if on_card else {}
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    eng.release()
    t_check = time.perf_counter()
    checks, failed = eng.check(win["kept"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    check_s = time.perf_counter() - t_check
    rec = {"setup_s": setup_s, "window_s": win["window_s"],
           "batches": win["batches"], "cells": win["cells"],
           "latencies_s": win["latencies_s"], "work": win["work"],
           "wrapper_s": spans.seconds,
           "launches": {k: after[k] - before.get(k, 0) for k in after},
           "trace": traced}
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = metric_reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": win["batches"], "failed": failed,
              "metrics": metrics, "device": dev,
              "loop": {"batches": win["batches"],
                       "window_s": win["window_s"],
                       "batches_per_s": win["batches"] / win["window_s"],
                       "outputs_checked": sum(len(v) for v in
                                              win["kept"].values()),
                       "check_s": check_s}}
    if trace:
        dev["busy_s"] = traced.get("busy_s", 0.0)
        dev["window_s"] = traced.get("window_s", win["window_s"])
        result["breakdown"] = {"device_ops": traced.get("device_ops", []),
                               "idle_gaps": traced.get("idle_gaps", [])}
    return {"result": result, "checks": checks}
