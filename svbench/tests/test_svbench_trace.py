"""Reading a Chrome trace: the window between the marker kernels, busy
time as a union inside it, kernel time by name, idle gaps labelled by
the CUDA runtime call in progress, and the readers that find nothing to
read."""

import json

import pytest

from svbench import harness, trace


def _x(name, ts, dur, cat=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur}
    if cat:
        e["cat"] = cat
    return e


MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_read(tmp_path):
    events = [
        _x(MARK, 90.0, 10.0, "kernel"),            # the window: [100, 1100]
        _x(MARK, 1100.0, 5.0, "kernel"),
        _x("void (anonymous namespace)::myers_thread_kernel<2>(Args)", 50.0,
           100.0, "kernel"),                       # 50 us inside
        _x("(anonymous namespace)::gotoh_tb_kernel(unsigned char const*)",
           300.0, 100.0, "kernel"),
        _x("Memcpy DtoH (Device -> Pinned)", 350.0, 100.0, "gpu_memcpy"),
        _x("void (anonymous namespace)::gotoh_kernel<4, 1>(int const*)",
           1000.0, 200.0, "kernel"),               # 100 us inside
        _x("cudaEventSynchronize", 150.0, 150.0, "cuda_runtime"),
        _x("cudaLaunchKernel", 450.0, 100.0, "cuda_runtime"),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = trace.read(str(path))
    assert r["window_s"] == pytest.approx(1000e-6)
    # busy: [100, 150] + [300, 450] + [1000, 1100]; the markers are not
    assert r["busy_s"] == pytest.approx(300e-6)
    assert r["kernel_s"] == pytest.approx({"k1": 50e-6, "k2tb": 100e-6,
                                           "k2": 100e-6})
    # gaps: [450, 1000] 550 us (no runtime call at 725: host),
    # [150, 300] 150 us (in cudaEventSynchronize)
    assert r["idle_gaps"][0] == ["host", pytest.approx(550e-6)]
    assert r["idle_gaps"][1] == ["cudaEventSynchronize",
                                 pytest.approx(150e-6)]
    assert r["device_ops"][0][1] == pytest.approx(100e-6)
    assert all(MARK not in n for n, _s in r["device_ops"])


def test_read_without_markers(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _x(MARK, 90.0, 10.0, "kernel"),
        _x("void (anonymous namespace)::myers_thread_kernel<2>(Args)", 50.0,
           100.0, "kernel")]}))
    assert trace.read(str(path)) == {}


def test_kernel_keys():
    assert trace.kernel_key("void (anonymous namespace)::myers_lanes_kernel"
                            "<256>(Args)") == "k1"
    assert trace.kernel_key("(anonymous namespace)::lcs_kernel(Args)") == "x1"
    assert trace.kernel_key("void gotoh_wide_kernel<8>()") is None


def test_readers_without_a_trace():
    rec = {"batches": 4, "window_s": 2.0, "cells": 8e9, "setup_s": 3.0,
           "latencies_s": [0.001] * 4, "work": {"k1": 0.5}, "wrapper_s": 0.004,
           "launches": {"myers": 8, "rowscan": 1}, "trace": {}}
    read = harness.metric_reader
    assert read("gcups")(rec) == pytest.approx(4.0)
    assert read("launches_per_batch")(rec) == 2.0
    assert read("wrapper_host_ms")(rec) == pytest.approx(1.0)
    assert read("batch_p95_ms")(rec) == pytest.approx(1.0)
    assert read("roofline.k1")(rec) is None
    assert read("idle_share")(rec) is None
    rec["trace"] = {"kernel_s": {"k1": 1.0}, "busy_s": 1.5, "window_s": 2.0}
    assert read("roofline.k1")(rec) == pytest.approx(50.0)
    assert read("idle_share")(rec) == pytest.approx(25.0)
