"""Reading a torch.profiler Chrome trace of one window: the card's busy
time, each kernel's time by name, the device operations that took most
time, and the longest idle gaps by what the host was doing.

The trace holds the card's activity alone. The window runs from the end
of the first marker kernel that the harness launches (`spin_kernel`,
torch.cuda._sleep) to the start of the last. An idle gap is labelled by
the CUDA runtime call in progress at its middle, or "host" where the
host was between runtime calls (in Python or the port's wrapper code).
"""

from __future__ import annotations

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels, by the name of their __global__ function in
# delly_tpu_torch/csrc/*.cu (before "_kernel"), to svbench's kernel keys
KERNEL_KEYS = {"myers_thread": "k1", "myers_lanes": "k1", "gotoh": "k2",
               "gotoh_tb": "k2tb", "lcs": "x1"}
_NAME = re.compile(r"\b(\w+?)_kernel\b")
TOP = 10
MARKER = "spin_kernel"
HOST_CATS = ("cuda_runtime", "cuda_driver")


def kernel_key(name: str):
    m = _NAME.search(name)
    return KERNEL_KEYS.get(m.group(1)) if m else None


def _union(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(path: str) -> dict:
    """{window_s, busy_s, kernel_s: {key: s}, device_ops, idle_gaps} of
    the trace at `path`, or {} where it holds no two markers."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    marks = sorted((float(e["ts"]), float(e.get("dur", 0))) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel"
                   and MARKER in str(e.get("name", "")))
    if len(marks) < 2:
        return {}
    w0 = marks[0][0] + marks[0][1]
    w1 = marks[-1][0]
    dev = []
    for e in events:
        if (e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
                and MARKER not in str(e.get("name", ""))):
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
            if b > a:
                dev.append((a, b, e["name"]))
    busy = _union((a, b) for a, b, _n in dev)
    by_name: dict = {}
    kernel_s: dict = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        key = kernel_key(name)
        if key is not None:
            kernel_s[key] = kernel_s.get(key, 0.0) + (b - a) / 1e6
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def doing(a, b):
        mid = (a + b) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        return max(inside, key=lambda h: h[0])[2] if inside else "host"

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_s": kernel_s,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[doing(a, b), (b - a) / 1e6]
                          for a, b in gaps[:TOP]]}
