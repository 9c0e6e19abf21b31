"""The port's device trace on the host: DELLY_TPU_PROFILE_TRACE writes a
Chrome trace beside the stage profile, and delly_tpu_torch/testing/
trace_check.py finds the port's kernels and the card's busy intervals in
such a trace."""

import json
import os

import pytest

from torch_card import torch_cpu  # noqa: F401

# kernel names as the card's traces print them (the port's six kernels
# and torch's own), with the launch counter each belongs to
NAMES = [
    ("void (anonymous namespace)::myers_thread_kernel<2>((anonymous "
     "namespace)::Args)", "myers"),
    ("void (anonymous namespace)::myers_lanes_kernel<256>((anonymous "
     "namespace)::Args)", "myers"),
    ("void (anonymous namespace)::gotoh_kernel<4, 1>(int const*, int const*, "
     "int const*)", "gotoh"),
    ("void (anonymous namespace)::gotoh_tb_kernel(unsigned char const*, int "
     "const*)", "gotoh_tb"),
    ("void (anonymous namespace)::banded_kernel<512>(unsigned char const*)",
     "gotoh_banded"),
    ("void (anonymous namespace)::banded_tb_kernel(unsigned char const*)",
     "gotoh_banded_tb"),
    ("void (anonymous namespace)::lcs_kernel((anonymous namespace)::Args)",
     "lcs"),
    ("void at::native::tensor_kernel_scan_innermost_dim_with_indices<long, "
     "std::greater<long> >(long const*)", None),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda>(int)", None),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_"
     "contig<at::native::(anonymous namespace)::OpaqueType<4u> >()", None),
]


def _events():
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * i, "dur": 4.0}
          for i, (n, _c) in enumerate(NAMES)]
    # a copy overlapping the first kernel, a memset inside the second and
    # a host event, which is no device activity
    ev += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2.0,
            "dur": 4.0},
           {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 11.0,
            "dur": 1.0},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": 0.0, "dur": 500.0}]
    return ev


def test_port_kernels_by_counter():
    from delly_tpu_torch.testing import trace_check

    want = {}
    for _n, c in NAMES:
        if c is not None:
            want[c] = want.get(c, 0) + 1
    assert trace_check.port_kernels(_events()) == want
    assert trace_check.launched({"myers": 2, "gotoh": 0, "host_routes": 5,
                                 "gotoh_banded_tb": 1, "lcs": 1}) == {
        "myers": 2, "gotoh_banded_tb": 1, "lcs": 1}


def test_busy_share_is_the_union_of_device_intervals(tmp_path):
    from delly_tpu_torch.testing import trace_check

    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    b = trace_check.busy_share(str(path), 0.001)
    # ten kernels of 4 us at 10 us apart; the copy stretches the first
    # to [0, 6); the memset lies inside the second
    busy_us = 6.0 + 4.0 * (len(NAMES) - 1)
    assert b["busy_s"] == busy_us / 1e6
    assert b["share"] == busy_us / 1e6 / 0.001
    assert b["device_events"] == len(NAMES) + 2
    assert b["kernels"] == len(NAMES)
    assert b["port_kernels"]["myers"] == 2


def test_traced_cli_run_on_the_host(tmp_path, torch_cpu):  # noqa: F811
    from delly_tpu_torch.testing import trace_check
    from delly_tpu_torch.testing.synth import make_deep_geno_dataset

    bam, fa, _truth = make_deep_geno_dataset(
        str(tmp_path), n_contigs=1, contig_len=100_000, dels_per_contig=5,
        coverage=10)
    before = {k: os.environ.get(k) for k in ("DELLY_TPU_PROFILE",
                                             "DELLY_TPU_PROFILE_TRACE")}
    res = trace_check.traced_cli(
        ["sr", "-g", fa, "-o", str(tmp_path / "out.vcf"), bam],
        str(tmp_path / "trace"), str(tmp_path / "profile.json"))
    assert res["rc"] == 0
    assert {k: os.environ.get(k) for k in before} == before
    # the stage profile keeps its form; the trace lies in the directory
    with open(tmp_path / "profile.json") as fh:
        prof = json.load(fh)
    assert sorted(prof) == ["stages", "wall_s"]
    assert res["wall_s"] == prof["wall_s"] > 0
    assert "startup" in prof["stages"]
    assert os.path.dirname(res["trace"]) == str(tmp_path / "trace")
    assert os.path.basename(res["trace"]) == f"trace.{os.getpid()}.json"
    # on the host the trace holds torch's operators and no device work
    with open(res["trace"]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert trace_check.busy_share(res["trace"], res["wall_s"])[
        "device_events"] == 0
    assert trace_check.launched(res["launches"]) == {}
    with open(tmp_path / "out.vcf") as fh:
        assert sum(not line.startswith("#") for line in fh) > 0


def test_profile_run_traces_one_run_per_process(tmp_path, monkeypatch,
                                                torch_cpu):  # noqa: F811
    """A second DELLY_TPU_PROFILE_TRACE trace in one process raises before
    it starts (the later traces of a long-lived process lose the card's
    records); a stage profile without a trace still runs, and
    allow_another_trace (trace_check's long-lived measurement) lifts the
    rule for the next run."""
    from delly_tpu_torch.testing import trace_check
    from delly_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_traced", False)
    monkeypatch.setenv("DELLY_TPU_PROFILE_TRACE", str(tmp_path / "t1"))
    with profiling.profile_run(str(tmp_path / "p1.json")):
        pass
    assert os.listdir(tmp_path / "t1") == [f"trace.{os.getpid()}.json"]
    monkeypatch.setenv("DELLY_TPU_PROFILE_TRACE", str(tmp_path / "t2"))
    with pytest.raises(RuntimeError, match="trace one run per process"):
        with profiling.profile_run(str(tmp_path / "p2.json")):
            pass
    assert not (tmp_path / "p2.json").exists()
    assert not (tmp_path / "t2").exists()
    monkeypatch.delenv("DELLY_TPU_PROFILE_TRACE")
    with profiling.profile_run(str(tmp_path / "p3.json")):
        pass
    with open(tmp_path / "p3.json") as fh:
        assert sorted(json.load(fh)) == ["stages", "wall_s"]
    from delly_tpu_torch import cli

    def traced_main(argv):
        with profiling.profile_run(os.environ["DELLY_TPU_PROFILE"]):
            return 0

    monkeypatch.setattr(cli, "main", traced_main)
    with pytest.raises(RuntimeError, match="trace one run per process"):
        trace_check.traced_cli([], str(tmp_path / "t3"),
                               str(tmp_path / "p4.json"))
    profiling.allow_another_trace()
    res = trace_check.traced_cli([], str(tmp_path / "t3"),
                                 str(tmp_path / "p4.json"))
    assert res["rc"] == 0
    assert os.path.basename(res["trace"]) == f"trace.{os.getpid()}.json"
