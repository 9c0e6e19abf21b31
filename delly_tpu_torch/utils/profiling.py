"""Run profiling (role of the reference's optional gperftools hook,
Makefile:44-46 / delly.h:87-89 `#ifdef PROFILE`):

- ``DELLY_TPU_PROFILE=<path>`` wraps a CLI run, converts the pipeline's
  own stage banners into per-stage wall seconds via the log hook and
  writes a JSON profile to ``<path>`` on exit.
- ``DELLY_TPU_PROFILE_TRACE=<dir>`` additionally records a device trace
  of the run with ``torch.profiler`` (the role of the JAX package's
  ``jax.profiler`` trace) and writes it as a Chrome trace,
  ``<dir>/trace.<pid>.json`` (Perfetto, chrome://tracing). It records
  the card's activity: every kernel and copy, with the runtime calls
  that launched them; on a machine without a card, the host's torch
  operators instead. Beside them it holds the port's host spans
  (category ``port``) and the run's stages from banner to banner
  (category ``stage``), on the trace's clock. The busy share of a run
  (the union of its kernel and copy intervals over its wall) is read
  from that file (chip_smoke.py ``busy_share``). A process traces one
  run: ``profile_run`` refuses a second trace in the same process.

Host spans. The kernel wrappers (ops/*_cuda.py), the numpy entry points
that the CLI calls and the kernel libraries' builds and loads
(ops/_build.py) mark where their host time goes: one outer span a call,
named after the kernel's launch counter (parallel/dispatch.py
KERNELS), and children ``<kernel>.<phase>`` (check, plan, alloc,
upload, launch; pack, h2d and d2h in the numpy entry points). Spans
are off by default, and then a wrapper pays one test of two flags a
call. They are on between ``on()`` and ``off()``, and while a
torch.profiler session records: the first outer span that finds the
profiler on turns them on, and the first that finds it off again turns
them off. When on, a span is three numbers (name id, start and end on
``time.perf_counter_ns``) in flat buffers allocated by ``on()``; past
their capacity spans are dropped and counted. ``take()`` returns them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
from torch.autograd import profiler as _torch_profiler

# The profiler keeps a card record only when its time, converted to the
# host's clock, falls inside the trace's window, and the conversion
# drifts from the profiler's first start in a process on: the window
# opens this long before the run and closes this long after it.
TRACE_MARGIN_S = 0.5

# Even so, the later traces of a long-lived process lose card records
# (testing/trace_check.py: one process alternating card work with traced
# runs lost every record of a one-launch run from about 80 s on, while
# fresh processes lost none), so a process traces one run.
_traced = False


def allow_another_trace() -> None:
    """Lifts the one-trace rule for this process's next traced run: for
    a measurement of the records that the rule guards against
    (testing/trace_check.py)."""
    global _traced
    _traced = False


# ---------------------------------------------------------------------------
# Host spans
# ---------------------------------------------------------------------------

# Spans a buffer holds: a 30 s window of the MSA loop (~50 spans a batch
# over eleven launches, ~1,200 batches a second) takes about half
CAPACITY = 1 << 22

ON = False
now = time.perf_counter_ns
NAMES: list = []            # span id -> name
_IDS: dict = {}
_n = 0
_cap = 0
_dropped = 0
_ids = _starts = _ends = None   # memoryviews onto the numpy buffers
_buffers = None
_clock: list = []           # (perf_counter_ns, time_ns) at on() and off()
_following = False


class _Never:
    _is_profiler_enabled = False


# the object whose flag the outer spans follow: torch.autograd.profiler,
# whose `_is_profiler_enabled` every torch.profiler session sets while it
# records (a stand-in that is never on where this torch lacks the flag)
PROFILER = (_torch_profiler if hasattr(_torch_profiler,
                                       "_is_profiler_enabled") else _Never)


def span_id(name: str) -> int:
    """The id of span `name`, registered on first use (at import time
    for the wrappers' spans)."""
    sid = _IDS.get(name)
    if sid is None:
        sid = _IDS[name] = len(NAMES)
        NAMES.append(name)
    return sid


def kernel_spans(kernel: str) -> tuple:
    """Ids of a kernel wrapper's spans: the call, and its phases check,
    plan, alloc, upload and launch."""
    return tuple(span_id(kernel + p) for p in
                 ("", ".check", ".plan", ".alloc", ".upload", ".launch"))


def entry_spans(entry: str) -> tuple:
    """Ids of a numpy entry point's spans: the call, and its phases
    pack, h2d and d2h."""
    return tuple(span_id(entry + p) for p in ("", ".pack", ".h2d", ".d2h"))


def _pair() -> tuple:
    return now(), time.time_ns()


def on(capacity: int = CAPACITY) -> None:
    """Start recording spans into fresh buffers of `capacity` spans,
    dropping what the last ones held."""
    global ON, _n, _cap, _dropped, _ids, _starts, _ends, _buffers, \
        _following
    _buffers = (np.empty(capacity, dtype=np.uint16),
                np.empty(capacity, dtype=np.int64),
                np.empty(capacity, dtype=np.int64))
    _ids, _starts, _ends = (memoryview(b) for b in _buffers)
    _n = _dropped = 0
    _cap = capacity
    _clock[:] = [_pair()]
    _following = False
    ON = True


def off() -> None:
    """Stop recording; the spans stay for ``take()``."""
    global ON, _following
    if ON:
        _clock.append(_pair())
    ON = _following = False


def begin() -> int:
    """The start of an outer span, at sites where ``ON`` or the followed
    profiler's flag is set: turns spans on for a profiler that has just
    started and off for one that has stopped. 0 where spans are off."""
    global _following
    if not ON:
        on()
        _following = True
    elif _following and not PROFILER._is_profiler_enabled:
        off()
        return 0
    return now()


def mark(sid: int, t0: int) -> int:
    """Record span `sid` from `t0` to now; returns now, the start of the
    next phase."""
    global _n, _dropped
    t1 = now()
    n = _n
    if n < _cap:
        _ids[n] = sid
        _starts[n] = t0
        _ends[n] = t1
        _n = n + 1
    else:
        _dropped += 1
    return t1


def record(name: str, t0: int, t1: int) -> None:
    """Record span `name` from `t0` to `t1` where spans are on (for rare
    spans such as a kernel library's load)."""
    global _n, _dropped
    if not ON:
        return
    if _n < _cap:
        _ids[_n] = span_id(name)
        _starts[_n] = t0
        _ends[_n] = t1
        _n += 1
    else:
        _dropped += 1


def take() -> dict:
    """The spans since the last ``on()``: {"names": span names by id,
    "ids", "start_ns", "end_ns": numpy arrays in the order the spans
    ended, "dropped": spans past the capacity, "clock": the
    (perf_counter_ns, time_ns) pairs read at on() and off()}."""
    if _buffers is None:
        empty = np.zeros(0, dtype=np.int64)
        return {"names": list(NAMES), "ids": empty, "start_ns": empty,
                "end_ns": empty, "dropped": 0, "clock": []}
    ids, starts, ends = (b[:_n].copy() for b in _buffers)
    return {"names": list(NAMES), "ids": ids, "start_ns": starts,
            "end_ns": ends, "dropped": _dropped, "clock": list(_clock)}


def to_unix_ns(t, clock: list):
    """Times on perf_counter_ns mapped onto time_ns (torch.profiler's
    host clock) by the clock pairs, linearly between the first and the
    last."""
    (p0, u0), (p1, u1) = clock[0], clock[-1]
    t = np.asarray(t, dtype=np.int64)
    if p1 == p0:
        return t + (u0 - p0)
    slope = (u1 - u0) / (p1 - p0)
    return u0 + np.rint((t - p0) * slope).astype(np.int64)


def chrome_events(spans: dict, base_ns: int, pid: int) -> list:
    """`spans` (``take()``) as Chrome trace "X" events of category
    ``port``, `ts` in us after `base_ns` on the trace's clock."""
    if not len(spans["ids"]):
        return []
    t0 = (to_unix_ns(spans["start_ns"], spans["clock"]) - base_ns) / 1e3
    t1 = (to_unix_ns(spans["end_ns"], spans["clock"]) - base_ns) / 1e3
    names = spans["names"]
    return [{"ph": "X", "cat": "port", "name": names[i], "pid": pid,
             "tid": "port", "ts": float(a), "dur": float(b - a)}
            for i, a, b in zip(spans["ids"].tolist(), t0, t1)]


def add_to_trace(path: str, spans: dict, stages=()) -> None:
    """Append `spans` (``take()``) to the Chrome trace at `path`, and
    `stages` [(time.time(), banner message or None)] as ``stage`` spans
    from each banner to the next, on the trace's clock."""
    with open(path) as fh:
        trace = json.load(fh)
    # ts are us after baseTimeNanoseconds (us of the host clock where the
    # trace has none)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        chrome_events(spans, base, pid) + _stage_events(stages, base, pid))
    with open(path, "w") as fh:
        json.dump(trace, fh)


def _stage_events(pts, base_ns: int, pid: int) -> list:
    """Each banner of `pts` as a ``stage`` span to the next."""
    out = []
    for (ts, msg), (te, _next) in zip(pts, pts[1:]):
        if msg is not None:
            a = (int(ts * 1e9) - base_ns) / 1e3
            out.append({"ph": "X", "cat": "stage", "pid": pid,
                        "tid": "stage", "name": msg.split(",")[0][:60],
                        "ts": a, "dur": (int(te * 1e9) - base_ns) / 1e3 - a})
    return out


# ---------------------------------------------------------------------------
# A profiled run
# ---------------------------------------------------------------------------

def _start_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile

    act = (ProfilerActivity.CUDA if torch.cuda.is_available()
           else ProfilerActivity.CPU)
    prof = profile(activities=[act])
    prof.start()
    time.sleep(TRACE_MARGIN_S)
    return prof


def _stop_trace(prof) -> None:
    import torch

    # CUPTI hands over only the records of finished work: wait for the
    # cards before the profiler flushes them
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    time.sleep(TRACE_MARGIN_S)
    prof.stop()


@contextlib.contextmanager
def profile_run(path: str):
    from delly_tpu_torch.utils import log as _log

    marks: list = []
    old_hook = _log.hook

    def hook(msg: str) -> None:
        if old_hook is not None:
            old_hook(msg)
        marks.append((time.time(), msg))

    trace_dir = os.environ.get("DELLY_TPU_PROFILE_TRACE")
    if trace_dir:
        global _traced
        if _traced:
            raise RuntimeError(
                "DELLY_TPU_PROFILE_TRACE: this process has traced a run "
                "already, and torch.profiler loses the card's kernel records "
                "in the later traces of a long-lived process; trace one run "
                "per process")
        _traced = True
    _log.hook = hook
    prof = _start_trace() if trace_dir else None
    if prof is not None:
        on()
    t0 = time.time()
    try:
        yield
    finally:
        t1 = time.time()
        _log.hook = old_hook
        pts = [(t0, "startup")] + marks + [(t1, None)]
        if prof is not None:
            _stop_trace(prof)
            off()
            os.makedirs(trace_dir, exist_ok=True)
            out = os.path.join(trace_dir, f"trace.{os.getpid()}.json")
            prof.export_chrome_trace(out)
            add_to_trace(out, take(), pts)
        stages: dict = {}
        for (ts, msg), (te, _next) in zip(pts, pts[1:]):
            if msg is not None:
                key = msg.split(",")[0][:60]
                stages[key] = round(stages.get(key, 0.0) + (te - ts), 4)
        try:
            with open(path, "w") as fh:
                json.dump({"wall_s": round(t1 - t0, 4),
                           "stages": stages}, fh, indent=1)
                fh.write("\n")
        except OSError:
            pass
