"""The readers of the program's own spans (svbench/metrics/_spans.py):
per batch sums of the kernel wrappers' outer and launch spans, nothing
without a card trace, a dropped span or a program without spans, and
the kernel libraries' set-up."""

import numpy as np
import pytest

from svbench import harness

NAMES = ["myers", "myers.check", "myers.launch", "lcs", "lcs.launch",
         "lcs_pairs"]


def _took(spans, dropped=0):
    ids = np.array([NAMES.index(n) for n, _a, _b in spans], dtype=np.uint16)
    return {"names": list(NAMES), "ids": ids,
            "start_ns": np.array([a for _n, a, _b in spans], dtype=np.int64),
            "end_ns": np.array([b for _n, _a, b in spans], dtype=np.int64),
            "dropped": dropped, "clock": [(0, 0), (1, 1)]}


def _rec(batches=4, trace=None):
    return {"batches": batches,
            "trace": {"busy_s": 1.0, "window_s": 2.0} if trace is None
            else trace}


@pytest.fixture
def spans(monkeypatch):
    from delly_tpu_torch.utils import profiling

    def use(took):
        monkeypatch.setattr(profiling, "take", lambda: took)
    return use


def test_wrapper_and_launch_ms_per_batch(spans):
    # two batches' worth of calls: outer spans of 1 ms and 3 ms, their
    # launches 0.25 ms and 0.5 ms, a check, and an entry point's span,
    # which is no kernel wrapper's
    spans(_took([("myers.check", 0, 100_000), ("myers.launch", 500_000,
                                               750_000),
                 ("myers", 0, 1_000_000), ("lcs.launch", 2_000_000,
                                           2_500_000),
                 ("lcs", 1_000_000, 4_000_000),
                 ("lcs_pairs", 0, 9_000_000)]))
    rec = _rec(batches=2)
    for name, want in (("wrapper_span_ms", 2.0), ("wrapper_span_ms.msa", 2.0),
                       ("wrapper_launch_ms", 0.375),
                       ("wrapper_launch_ms.msa", 0.375)):
        assert harness.metric_reader(name)(rec) == pytest.approx(want)


def test_no_reading_without_spans_trace_or_with_drops(spans, monkeypatch):
    from delly_tpu_torch.utils import profiling

    read = harness.metric_reader("wrapper_span_ms")
    launch = harness.metric_reader("wrapper_launch_ms")
    spans(_took([("myers", 0, 1_000_000)]))
    assert read(_rec()) == pytest.approx(0.25)
    # no launch span: a CPU call, which runs the plain version
    assert launch(_rec()) is None
    assert read(_rec(trace={})) is None
    assert read(_rec(batches=0)) is None
    spans(_took([("myers", 0, 1_000_000)], dropped=1))
    assert read(_rec()) is None
    spans(_took([]))
    assert read(_rec()) is None
    # a program without spans (the parent of the change that added them)
    monkeypatch.delattr(profiling, "take")
    assert read(_rec()) is None and launch(_rec()) is None


def test_spans_of_real_calls_on_the_host():
    """The port's own recorder: a call of the K1 wrapper on the host
    reads as its outer span and no launch."""
    import torch

    from delly_tpu_torch.ops.myers import alphabet_lut
    from delly_tpu_torch.ops.myers_cuda import myers
    from delly_tpu_torch.utils import profiling

    q = np.frombuffer(b"ACGTACGTAA" * 4, dtype=np.uint8).reshape(4, 10).copy()
    lens = torch.full((4,), 10, dtype=torch.int32)
    lut = torch.from_numpy(alphabet_lut(q, q))
    profiling.on()
    try:
        t0 = profiling.now()
        myers(torch.from_numpy(q), lens, torch.from_numpy(q), lens, lut, 2)
        outside = profiling.now() - t0
    finally:
        profiling.off()
    got = harness.metric_reader("wrapper_span_ms")(_rec(batches=1))
    assert 0 < got <= outside / 1e6
    assert harness.metric_reader("wrapper_launch_ms")(_rec()) is None


def test_kernel_load_ms(monkeypatch):
    from delly_tpu_torch.ops import _build

    read = harness.metric_reader("kernel_load_ms")
    monkeypatch.setattr(_build, "loads", {})
    assert read(_rec()) is None
    monkeypatch.setattr(_build, "loads", {
        "myers": {"load_s": 0.002, "first_launch_s": 0.030},
        "lcs": {"load_s": 0.001}})
    assert read(_rec()) == pytest.approx(33.0)
    monkeypatch.delattr(_build, "loads")
    assert read(_rec()) is None
