"""The PyTorch port's multi-device dispatch, on a mesh of the CPU listed
three times (the counterpart of the JAX tests' virtual CPU devices).

- K1, K2/K2-tb and K3/K3-tb through their batch entry points (the plain
  versions on the CPU) and the CNV window math (parallel/depth_step.py),
  on batches whose size is not a multiple of 3: the results under the
  mesh equal those without one, and every device of the mesh ran a
  chunk (``dispatch.hits``).
- The CLI with DELLY_TPU_TORCH_DEVICE=cpu under DELLY_TPU_MESH=3 and with
  the mesh off, in one process: `sr`, `sr -v`, `lr`, `asm` and `cnv`
  with its coverage file. Every output equals the JAX package's without
  a mesh apart from ##fileDate (BCF decoded, gzip decompressed), every
  device that a batch reached ran chunks, and the `cnv` run logs its
  mesh read-depth windows.
- ``run_sr_on_mesh`` (parallel/genotype_step.py) gives the CLI's calls.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_card import depth_windows, output_lines, run_cli
from torch_card import torch_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mesh3(torch_cpu):  # noqa: F811
    import torch

    from delly_tpu_torch.parallel import dispatch
    from delly_tpu_torch.parallel.mesh import make_mesh

    dispatch.reset()
    yield make_mesh(3, devices=[torch.device("cpu")] * 3)
    dispatch.reset()


def _split_equals_one_device(mesh, engine, fn):
    """fn() under the mesh equals fn() without one; every device ran."""
    from delly_tpu_torch.parallel import dispatch

    want = fn()
    assert dispatch.device_snapshot() == {}
    with dispatch.use_mesh(mesh):
        got = fn()
    hits = dispatch.device_snapshot()
    assert sorted(hits) == [0, 1, 2]
    assert all(hits[p].get(engine, 0) > 0 for p in range(3)), hits
    return want, got


def test_cuts_cover_in_order():
    from delly_tpu_torch.parallel import dispatch

    for n in (0, 1, 2, 3, 7, 37):
        parts = dispatch.cuts(n, 3)
        assert [lo for lo, _ in parts][0] == 0 and parts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        sizes = [hi - lo for lo, hi in parts]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_k1_split_matches_one_device(mesh3, mode):
    from delly_tpu_torch.ops.edist import batched_edit_distance

    rng = np.random.default_rng(7 + mode)
    n = 37
    q = rng.integers(0, 4, size=(n, 70)).astype(np.uint8) + 65
    t = rng.integers(0, 4, size=(n, 128)).astype(np.uint8) + 65
    ql = rng.integers(20, 71, size=n).astype(np.int32)
    tl = rng.integers(60, 129, size=n).astype(np.int32)
    want, got = _split_equals_one_device(
        mesh3, "edist",
        lambda: batched_edit_distance(q, ql, t, tl, mode))
    assert got.dtype == np.int32 and np.array_equal(got, want)


def _dna(rng, k):
    return "".join(rng.choice(list("ACGT"), size=k))


def _mutate(rng, s, rate=0.08):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(_dna(rng, 1) if r < 2 * rate / 3 else ch)
        if r > 1 - rate / 3:
            out.append(_dna(rng, 1))
    return "".join(out)


@pytest.mark.parametrize("ac", [(False, False), (True, True)])
def test_k2_split_matches_one_device(mesh3, ac):
    from delly_tpu_torch.ops.gotoh import to_align
    from delly_tpu_torch.ops.gotoh_cuda import gotoh_batch

    rng = np.random.default_rng(11)
    jobs = []
    for k in range(11):
        base = _dna(rng, int(rng.integers(60, 200)))
        a1 = to_align(np.frombuffer(_mutate(rng, base).encode(), np.uint8))
        a2 = to_align(np.frombuffer(_mutate(rng, base).encode(), np.uint8))
        jobs.append((a1, a2))
    want, got = _split_equals_one_device(
        mesh3, "gotoh_msa", lambda: gotoh_batch(jobs, ac=ac))
    assert len(got) == len(want) == len(jobs)
    for (s1, m1), (s2, m2) in zip(want, got):
        assert s1 == s2 and np.array_equal(m1, m2)


def test_k3_split_matches_one_device(mesh3):
    from delly_tpu_torch.ops.gotoh import to_align
    from delly_tpu_torch.ops.gotoh_banded_cuda import gotoh_banded_batch
    from delly_tpu_torch.parallel import dispatch

    rng = np.random.default_rng(13)
    jobs = []
    for k in range(10):
        base = _dna(rng, int(rng.integers(270, 300)))
        jobs.append((to_align(np.frombuffer(base.encode(), np.uint8)),
                     to_align(np.frombuffer(_mutate(rng, base).encode(),
                                            np.uint8))))
    bands = [512] * 8 + [1024] * 2
    routes = dispatch.snapshot()["host_routes"]
    want, got = _split_equals_one_device(
        mesh3, "gotoh_banded",
        lambda: gotoh_banded_batch(jobs, ac=(True, False), band=bands))
    assert dispatch.snapshot()["host_routes"] == routes
    for (s1, m1), (s2, m2) in zip(want, got):
        assert s1 == s2 and np.array_equal(m1, m2)


def test_depth_windows_split_matches_numpy(mesh3):
    """The window math split over the mesh equals the numpy route
    without a mesh bit for bit; the tallies are exact."""
    from delly_tpu_torch.ops.depth_math import window_depth
    from delly_tpu_torch.parallel.depth_step import depth_windows_on_mesh

    rng = np.random.default_rng(17)
    w = 137
    covsum = np.floor(rng.gamma(20.0, 8.0, size=w))
    expcov = rng.gamma(20.0, 8.0, size=w)
    expcov[rng.random(w) < 0.05] = 0.0
    ok = rng.random(w) > 0.1
    cn_h, logr_h = window_depth(np, covsum, np.where(ok, expcov, 0.0),
                                2.0, 0.9, 2.0, 2.0)
    cn, logr, (n_call, cov_tot) = depth_windows_on_mesh(
        mesh3, covsum, expcov, ok, 2.0, 0.9, 2.0, 2.0)
    assert cn.dtype == logr.dtype == np.float64
    assert cn.tobytes() == cn_h.tobytes()
    assert logr.tobytes() == logr_h.tobytes()
    assert n_call == int(ok.sum()) and cov_tot == float(covsum[ok].sum())


@pytest.mark.parametrize("purity", [1.0, 0.9])
def test_depth_windows_split_on_rounding_boundaries(mesh3, purity):
    """The same on 200,000 windows, half of them on a %g rounding
    boundary of their logR or cn (tests/torch_card.py depth_windows):
    cn and logR bit-equal to window_depth in numpy."""
    from delly_tpu_torch.ops.depth_math import window_depth
    from delly_tpu_torch.parallel.depth_step import depth_windows_on_mesh

    covsum, expcov, ok = depth_windows(np.random.default_rng(43), 200_000)
    cn_h, logr_h = window_depth(np, covsum, np.where(ok, expcov, 0.0),
                                2.0, purity, 2.0, 2.0)
    cn, logr, _tot = depth_windows_on_mesh(mesh3, covsum, expcov, ok, 2.0,
                                           purity, 2.0, 2.0)
    assert cn.tobytes() == cn_h.tobytes()
    assert logr.tobytes() == logr_h.tobytes()


# Runs each (DELLY_TPU_MESH, argv) step through the port's cli.main in
# one process and prints each step's exit code and per-device hits.
_DRIVER = """
import json, os, sys
from delly_tpu_torch.cli import main
from delly_tpu_torch.parallel import dispatch
out = []
for mesh, argv in json.load(open(sys.argv[1])):
    os.environ["DELLY_TPU_MESH"] = mesh
    dispatch.reset()
    rc = main(argv)
    out.append([rc, dispatch.device_snapshot(), dispatch.snapshot()])
print("STEPS=" + json.dumps(out))
print("LEAKED=" + json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "delly_tpu"))))
"""


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    from bamsynth import (make_lr_sv_dataset, make_multi_contig_del_dataset,
                          make_multi_sv_dataset)

    from delly_tpu_torch.testing.synth import make_asm_split_dataset

    d = tmp_path_factory.mktemp("torch_multidevice")
    bam, fa, _ = make_multi_sv_dataset(str(d), n_contigs=2,
                                       contig_len=200_000,
                                       pairs_per_contig=3000)
    lbam, lfa, _ = make_lr_sv_dataset(str(d))
    abams, afa, _ = make_asm_split_dataset(str(d), name="fam")
    cbam, cfa, _ = make_multi_contig_del_dataset(
        str(d), n_contigs=2, contig_len=120_000, pairs_per_contig=2500,
        name="cc1")

    def steps(tag):
        o = lambda name: str(d / f"{name}.{tag}")  # noqa: E731
        return {
            "sr": ["sr", "-g", fa, "-o", o("sr.vcf"), bam],
            "sr -v": ["sr", "-g", fa, "-v", o("sr.vcf"), "-o",
                      o("regeno.vcf"), bam],
            "lr": ["lr", "-g", lfa, "-o", o("lr.vcf"), lbam],
            "asm": ["asm", "-g", afa, "-o", o("asm.vcf"), *abams],
            "cnv": ["cnv", "-g", cfa, "-c", o("cov.gz"), "-o",
                    o("cnv.bcf"), cbam],
        }

    port_steps = [[mesh, argv] for mesh, tag in (("off", "off"), ("3", "m3"))
                  for argv in steps(tag).values()]
    path = str(d / "port_steps.json")
    with open(path, "w") as fh:
        json.dump(port_steps, fh)
    env = dict(os.environ, DELLY_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("DELLY_TPU_MESH", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = subprocess.Popen([sys.executable, "-c", _DRIVER, path], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        jax = run_cli("delly_tpu", list(steps("jax").values()), d,
                      timeout=400)
        so, se = port.communicate(timeout=400)
    finally:
        if port.poll() is None:
            port.kill()
            port.wait()
    assert port.returncode == 0, se[-3000:]
    lines = dict(ln.split("=", 1) for ln in so.splitlines() if "=" in ln)
    return d, list(steps("jax")), jax, json.loads(lines["STEPS"]), \
        json.loads(lines["LEAKED"]), se, (bam, fa)


def test_cli_mesh_runs_exit_zero(cli_runs):
    _d, names, jax, port, leaked, _se, _sr = cli_runs
    assert jax["rcs"] == [0] * len(names)
    assert [p[0] for p in port] == [0] * 2 * len(names)
    assert leaked == []


@pytest.mark.parametrize("word", ["sr", "sr -v", "lr", "asm", "cnv"])
def test_cli_mesh_matches_jax(cli_runs, word):
    """Mesh of 3 == mesh off == the JAX package without a mesh, and under
    the mesh every device that a batch reached ran chunks; launch
    counters (host routes, row-scan batches) do not change with the
    mesh."""
    d, names, _jax, port, _leaked, _se, _sr = cli_runs
    k = names.index(word)
    off, m3 = port[k], port[len(names) + k]
    assert off[1] == {}
    # asm's K1 batches hold two pairs each (a strand check per contig
    # pair): a chunk for devices 0 and 1, none for device 2
    ran = ["0", "1"] if word == "asm" else ["0", "1", "2"]
    assert sorted(m3[1]) == ran, m3[1]
    assert all(sum(m3[1][p].values()) > 0 for p in ran)
    assert m3[2] == off[2]
    outs = {"sr": ["sr.vcf"], "sr -v": ["regeno.vcf"], "lr": ["lr.vcf"],
            "asm": ["asm.vcf"], "cnv": ["cnv.bcf", "cov.gz"]}[word]
    for name in outs:
        want = output_lines(str(d / f"{name}.jax"))
        assert want
        assert output_lines(str(d / f"{name}.off")) == want, name
        assert output_lines(str(d / f"{name}.m3")) == want, name


def test_cli_cnv_mesh_windows(cli_runs):
    """`cnv` under the mesh runs its window math on all three devices and
    logs it; without the mesh it takes the numpy route."""
    _d, names, _jax, port, _leaked, se, _sr = cli_runs
    hits = port[len(names) + names.index("cnv")][1]
    assert all(hits[p].get("cnv_depth", 0) > 0 for p in ("0", "1", "2"))
    assert "Mesh read-depth windows" in se
    assert "devices=3" in se


def test_run_sr_on_mesh_matches_cli(cli_runs, mesh3):
    """parallel/genotype_step.py run_sr_on_mesh: the whole `sr` pipeline
    with its batches split over the mesh gives the calls of the CLI
    without a mesh."""
    from delly_tpu_torch.parallel import dispatch
    from delly_tpu_torch.parallel.genotype_step import run_sr_on_mesh

    d, *_rest, (bam, fa) = cli_runs
    text = run_sr_on_mesh(mesh3, bam, fa)
    hits = dispatch.device_snapshot()
    assert all(sum(hits[p].values()) > 0 for p in range(3)), hits

    def body(lines):
        return [ln for ln in lines if ln and not ln.startswith("#")]

    want = body(output_lines(str(d / "sr.vcf.off")))
    assert want and body(text.splitlines()) == want
