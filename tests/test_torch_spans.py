"""The port's host spans (utils/profiling.py): off by default and then
recording nothing; nested and named when on; dropped and counted past
the buffers' capacity; turned on and off by a torch.profiler session;
the span set of each kernel wrapper and numpy entry point on the host;
the trace that DELLY_TPU_PROFILE_TRACE writes, with the spans and the
stages on the trace's clock; and the kernel libraries' set-up record
(ops/_build.py loads)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from delly_tpu_torch.ops import _build, gotoh_cuda, lcs_cuda, msa, myers_cuda
from delly_tpu_torch.ops.gotoh import DnaScore, to_align
from delly_tpu_torch.ops.myers import alphabet_lut, alphabet_size
from delly_tpu_torch.utils import profiling
from torch_card import torch_cpu  # noqa: F401


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off."""
    profiling.off()
    yield
    profiling.off()


def _spans():
    """[(name, start_ns, end_ns)] of take(), in the order they ended."""
    got = profiling.take()
    return [(got["names"][i], a, b) for i, a, b in
            zip(got["ids"].tolist(), got["start_ns"].tolist(),
                got["end_ns"].tolist())]


def _myers_args(b=6, m=20, n=24):
    rng = np.random.default_rng(5)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = letters[rng.integers(0, 4, size=(b, m))]
    t = letters[rng.integers(0, 4, size=(b, n))]
    ql = np.full(b, m, dtype=np.int32)
    tl = np.full(b, n, dtype=np.int32)
    lut = alphabet_lut(q, t)
    args = [torch.from_numpy(x) for x in (q, ql, t, tl, lut)]
    return args + [2, alphabet_size(lut)]


def _call_myers():
    return myers_cuda.myers(*_myers_args())


def _call_lcs():
    rng = np.random.default_rng(6)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    a = letters[rng.integers(0, 4, size=(5, 30))]
    b = letters[rng.integers(0, 4, size=(5, 40))]
    al = np.full(5, 30, dtype=np.int32)
    bl = np.array([40, 10, 25, 40, 1], dtype=np.int32)
    lut, nalpha = lcs_cuda.letter_lut(b, bl)
    return lcs_cuda.lcs(*(torch.from_numpy(x) for x in (a, al, b, bl, lut)),
                        nalpha, host_lengths=(al, bl))


def _gotoh_inputs():
    two = np.frombuffer(b"ACGTACACGTTC", dtype=np.uint8).reshape(2, 6)
    jobs = [(to_align(two), to_align("ACGAC")),
            (to_align("TTGCA"), to_align("TTGGCA"))]
    return [torch.from_numpy(x)
            for x in gotoh_cuda.pack_bucket(jobs, 128, DnaScore())]


def _call_gotoh():
    return gotoh_cuda.gotoh_forward(*_gotoh_inputs(), True, True, -10, -1)


def _call_gotoh_tb():
    prof, wc2, d2, ml, nl = _gotoh_inputs()
    _best, bits = gotoh_cuda.gotoh_forward_plain(prof, wc2, d2, ml, nl, True,
                                                 True, -10, -1)
    return gotoh_cuda.gotoh_traceback(bits, ml, nl)


CELL_WRAPPERS = {"myers": _call_myers, "lcs": _call_lcs,
                 "gotoh": _call_gotoh, "gotoh_tb": _call_gotoh_tb}


def test_off_records_nothing():
    assert not profiling.ON
    profiling.on()
    profiling.off()
    _call_myers()
    _call_lcs()
    got = profiling.take()
    assert len(got["ids"]) == 0 and got["dropped"] == 0
    assert len(got["clock"]) == 2


def test_on_gives_nested_named_ordered_spans():
    profiling.on()
    _call_myers()
    _call_myers()
    profiling.off()
    spans = _spans()
    assert [n for n, _a, _b in spans] == ["myers.check", "myers"] * 2
    for (child, c0, c1), (outer, o0, o1) in zip(spans[::2], spans[1::2]):
        assert o0 <= c0 <= c1 <= o1
    assert all(a <= b for _n, a, b in spans)
    # the second call starts after the first ended
    assert spans[1][2] <= spans[3][1]


def test_spans_past_the_capacity_are_dropped_and_counted():
    profiling.on(capacity=3)
    for _ in range(3):
        _call_myers()
    profiling.off()
    got = profiling.take()
    assert len(got["ids"]) == 3
    assert got["dropped"] == 3
    profiling.on()
    assert profiling.take()["dropped"] == 0


@pytest.mark.parametrize("kernel", sorted(CELL_WRAPPERS))
def test_cell_wrapper_on_the_host_records_call_and_check(kernel):
    """A CPU-tensor call runs the plain version: its outer span and its
    check span, and no launch."""
    profiling.on()
    CELL_WRAPPERS[kernel]()
    profiling.off()
    names = [n for n, _a, _b in _spans()]
    assert names == [f"{kernel}.check", kernel]


@pytest.mark.parametrize("entry", ["batched_edit_distance_myers",
                                   "lcs_pairs", "gotoh_batch"])
def test_numpy_entry_points_record_pack_h2d_d2h(entry, torch_cpu):  # noqa: F811
    """The numpy entry points of the CLI: one outer span with pack, h2d
    and d2h children, and the kernel wrapper's spans inside."""
    profiling.on()
    if entry == "batched_edit_distance_myers":
        args = _myers_args()
        myers_cuda.batched_edit_distance_myers(
            *(x.numpy() for x in args[:4]), mode=2)
        kernel = "myers"
    elif entry == "lcs_pairs":
        msa.lcs_pairs([("ACGTAC", "ACGAC"), ("TTGCA", "TTGGCAT")])
        kernel = "lcs"
    else:
        gotoh_cuda.gotoh_batch([("ACGTAC", "ACGAC"), ("TTGCA", "TTGGCA")])
        kernel = "gotoh_tb"
    profiling.off()
    spans = _spans()
    names = [n for n, _a, _b in spans]
    assert names[-1] == entry
    for phase in ("pack", "h2d", "d2h"):
        assert names.count(f"{entry}.{phase}") == 1
    assert kernel in names and f"{kernel}.check" in names
    _n, o0, o1 = spans[-1]
    assert all(o0 <= a <= b <= o1 for _n, a, b in spans)


def test_spans_follow_a_torch_profiler(monkeypatch):
    """The first outer span inside a torch.profiler session turns spans
    on; the first after it stopped turns them off and records nothing.
    Where torch has no profiler flag they stay off."""
    from torch.profiler import ProfilerActivity, profile

    _call_myers()
    assert not profiling.ON
    with profile(activities=[ProfilerActivity.CPU]):
        _call_myers()
        assert profiling.ON
    _call_myers()
    assert not profiling.ON
    assert [n for n, _a, _b in _spans()] == ["myers.check", "myers"]
    monkeypatch.setattr(profiling, "PROFILER", profiling._Never)
    with profile(activities=[ProfilerActivity.CPU]):
        _call_myers()
    assert not profiling.ON
    assert len(_spans()) == 2


def test_clock_map_is_linear_between_the_pairs():
    clock = [(1_000, 5_000_000), (3_000, 5_002_004)]
    got = profiling.to_unix_ns([1_000, 2_000, 3_000], clock)
    assert got.tolist() == [5_000_000, 5_001_002, 5_002_004]
    assert profiling.to_unix_ns([7], clock[:1]).tolist() == [4_999_007]


def test_record_function_lands_inside_its_program_span(tmp_path):
    """One clock with torch.profiler's trace: a record_function range
    opened inside a program span lies inside that span once the span is
    mapped onto the trace's clock (2 ms of slack on each side)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sid = profiling.span_id("test.outer")
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    profiling.on()
    t0 = profiling.now()
    time.sleep(0.002)
    with record_function("probe"):
        time.sleep(0.002)
    time.sleep(0.002)
    profiling.mark(sid, t0)
    profiling.off()
    prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    profiling.add_to_trace(path, profiling.take())
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    probe = [e for e in events if e.get("name") == "probe"]
    outer = [e for e in events if e.get("cat") == "port"]
    assert len(probe) == 1 and [e["name"] for e in outer] == ["test.outer"]
    p, o = probe[0], outer[0]
    assert o["ts"] <= p["ts"]
    assert p["ts"] + p["dur"] <= o["ts"] + o["dur"]


def test_profile_run_writes_port_and_stage_events(tmp_path, monkeypatch,
                                                  torch_cpu):  # noqa: F811
    from delly_tpu_torch.utils import log

    monkeypatch.setattr(profiling, "_traced", False)
    monkeypatch.setenv("DELLY_TPU_PROFILE_TRACE", str(tmp_path / "t"))
    with profiling.profile_run(str(tmp_path / "p.json")):
        log.stage("First stage, 2 samples")
        _call_myers()
        log.stage("Second stage")
        _call_lcs()
    assert not profiling.ON
    with open(tmp_path / "p.json") as fh:
        assert sorted(json.load(fh)) == ["stages", "wall_s"]
    with open(tmp_path / "t" / f"trace.{os.getpid()}.json") as fh:
        events = json.load(fh)["traceEvents"]
    port = {e["name"]: e for e in events if e.get("cat") == "port"}
    stage = {e["name"]: e for e in events if e.get("cat") == "stage"}
    assert {"myers", "myers.check", "lcs", "lcs.check"} <= set(port)
    assert set(stage) == {"startup", "First stage", "Second stage"}

    def inside(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]

    assert inside(port["myers"], stage["First stage"])
    assert inside(port["lcs"], stage["Second stage"])


def test_first_launch_ends_a_library_setup(monkeypatch):
    """_build.check closes the set-up record of a library's first
    launch, once, and still raises on a failed launch."""
    monkeypatch.setattr(_build, "loads", {"x": {"load_s": 0.5}})
    monkeypatch.setattr(_build, "_first",
                        {"x": time.perf_counter_ns() - 2_000_000})
    _build.check(0, "y")
    assert "first_launch_s" not in _build.loads["x"]
    _build.check(0, "x")
    first = _build.loads["x"]["first_launch_s"]
    assert first >= 0.002 and _build._first == {}
    with pytest.raises(RuntimeError, match="cudaError 2"):
        _build.check(2, "x")
    assert _build.loads["x"]["first_launch_s"] == first
