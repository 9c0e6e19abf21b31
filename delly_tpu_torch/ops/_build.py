"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into a
shared library with a plain C interface under ``build/kernels/`` at
the repository root, named by a hash of the source and of the headers
beside it (csrc/*.cuh), and bound with
ctypes. Every C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; ``check`` raises when that is not 0.
Nothing here runs at import time: the CPU tests import every module
on a machine with no ``nvcc``.

``loads`` keeps, for each library a process loads, the set-up it paid
once: ``load_s``, the build (where the library was not built yet) and
the load, and ``first_launch_s``, from the end of the load to the end
of the first launch (which holds CUDA's lazy load of the kernels'
module). Where host spans are on (utils/profiling.py) builds and loads
are also spans ``build.<name>`` and ``load.<name>``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from delly_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("myers", "gotoh", "gotoh_tb", "gotoh_banded", "gotoh_banded_tb",
           "lcs", "gotoh_wide", "gotoh_wide_tb")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_lock = threading.Lock()
build_log: dict = {}
loads: dict = {}
_first: dict = {}           # name -> the end of its load, until it launches


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    key = hashlib.sha256(" ".join(FLAGS).encode())
    for src in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC)
                                       if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as fh:
            key.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one nvcc
    process each, all started together. Returns {name: seconds}; the
    compiler's output (the ``-Xptxas -v`` register and spill lines) is
    kept in ``build_log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.time()
    t0_ns = time.perf_counter_ns()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.time() - t0
        profiling.record(f"build.{name}", t0_ns, time.perf_counter_ns())
        build_log[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The kernel library for csrc/<name>.cu, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter_ns()
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = _libs[name] = ctypes.CDLL(path)
            t1 = time.perf_counter_ns()
            profiling.record(f"load.{name}", t0, t1)
            loads[name] = {"load_s": (t1 - t0) / 1e9}
            _first[name] = t1
        return lib


def check(rc: int, name: str) -> None:
    """Raises where launch `name` returned an error; the first launch of
    each library also ends its set-up in ``loads``."""
    if _first:
        t0 = _first.pop(name, None)
        if t0 is not None:
            loads[name]["first_launch_s"] = (time.perf_counter_ns()
                                             - t0) / 1e9
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
