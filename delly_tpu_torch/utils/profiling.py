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
  operators instead. The busy share of a run (the union of its kernel
  and copy intervals over its wall) is read from that file
  (chip_smoke.py ``busy_share``). A process traces one run:
  ``profile_run`` refuses a second trace in the same process.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

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
    t0 = time.time()
    try:
        yield
    finally:
        t1 = time.time()
        _log.hook = old_hook
        if prof is not None:
            _stop_trace(prof)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, f"trace.{os.getpid()}.json"))
        stages: dict = {}
        pts = [(t0, "startup")] + marks + [(t1, None)]
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
