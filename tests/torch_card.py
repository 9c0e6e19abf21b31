"""Shared fixtures of the PyTorch port's tests (tests/test_torch_*.py)."""

import os
import shutil

import pytest


@pytest.fixture
def card():
    """cuda:0, or a skip where there is no GPU or no nvcc. Decided here,
    at run time, never while a test module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the port's kernels")
    return torch.device("cuda", 0)


@pytest.fixture
def torch_cpu(monkeypatch):
    """Run the port on the host: DELLY_TPU_TORCH_DEVICE=cpu."""
    from delly_tpu_torch.utils import torchenv

    monkeypatch.setenv(torchenv.ENV, "cpu")
    torchenv.reset()
    yield
    torchenv.reset()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs each argv of a JSON list through `<package>.cli.main` in one
# process (one interpreter start for a whole workflow), then prints each
# step's exit code, the jax/delly_tpu modules the process imported, and
# the port's launch counters.
_CLI_DRIVER = """
import json, sys, traceback
from {pkg}.cli import main
rcs = []
for argv in json.load(open(sys.argv[1])):
    try:
        rcs.append(main(argv))
    except BaseException:
        traceback.print_exc()
        rcs.append(-1)
print('RCS=' + json.dumps(rcs))
print('LEAKED=' + json.dumps(sorted(
    m for m in sys.modules if m.split('.')[0] in ('jax', 'delly_tpu'))))
if '{pkg}' == 'delly_tpu_torch':
    from delly_tpu_torch.parallel import dispatch
    print('COUNTS=' + json.dumps(dispatch.snapshot()))
"""


def run_cli(pkg, steps, workdir, timeout=300):
    """Run the CLI steps (a list of argv lists) of `pkg` (``delly_tpu``
    under JAX_PLATFORMS=cpu, or ``delly_tpu_torch`` with
    DELLY_TPU_TORCH_DEVICE=cpu and one torch thread) in one process.
    Returns {"rcs": [...], "leaked": [...], "counts": {...}, "stderr": str}.
    """
    import json
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if pkg == "delly_tpu":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env.update(DELLY_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    path = os.path.join(str(workdir), f"steps.{pkg}.json")
    with open(path, "w") as fh:
        json.dump(steps, fh)
    p = subprocess.run(
        [sys.executable, "-c", _CLI_DRIVER.format(pkg=pkg), path], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    out = {"stderr": p.stderr, "counts": {}}
    for line in p.stdout.splitlines():
        for key in ("RCS", "LEAKED", "COUNTS"):
            if line.startswith(key + "="):
                out[key.lower()] = json.loads(line[len(key) + 1:])
    assert len(out["rcs"]) == len(steps)
    return out


def run_port(steps, workdir, timeout=300):
    """run_cli for the port; its process must end with neither jax nor
    any delly_tpu module imported, and with no torch row-scan batch."""
    out = run_cli("delly_tpu_torch", steps, workdir, timeout)
    assert out["leaked"] == []
    assert out["counts"]["rowscan"] == 0
    return out


def run_ok(pkg, steps, workdir, timeout=300):
    """run_cli, or run_port for the port, with every step required to
    exit 0."""
    out = (run_port(steps, workdir, timeout) if pkg == "delly_tpu_torch"
           else run_cli(pkg, steps, workdir, timeout))
    assert out["rcs"] == [0] * len(steps), out["stderr"][-3000:]
    return out


def output_lines(path):
    """An output's lines for comparison: BCF decoded to VCF text, a gzip
    file decompressed (a .cov.gz header holds its write time), the
    ##fileDate line dropped."""
    import gzip

    from delly_tpu.io.bcf import bcf_to_vcf_text

    with open(path, "rb") as fh:
        data = fh.read()
    if path.endswith(".bcf"):
        text = bcf_to_vcf_text(data)
    elif data[:2] == b"\x1f\x8b":
        text = gzip.decompress(data).decode()
    else:
        text = data.decode()
    return [ln for ln in text.splitlines() if not ln.startswith("##fileDate")]


def run_both(cases, workdir, timeout=300):
    """Run every case through the JAX package, then through the port.

    `cases(src, dst)` gives {case: [argv, ...]} for outputs tagged `dst`
    from inputs tagged `src`; the JAX package runs cases("jax", "jax")
    and the port cases("jax", "port"), so each port step reads the JAX
    package's output of the step before. Returns {case: (JAX exit codes,
    port exit codes, [(JAX output, port output), ...])} and the port's
    run (run_port)."""
    jcases, pcases = cases("jax", "jax"), cases("jax", "port")
    jax = run_cli("delly_tpu", [s for st in jcases.values() for s in st],
                  workdir, timeout)
    port = run_port([s for st in pcases.values() for s in st], workdir,
                    timeout)
    jrcs, prcs = iter(jax["rcs"]), iter(port["rcs"])
    out = {}
    for case, steps in jcases.items():
        pairs = [(js[js.index("-o") + 1], ps[ps.index("-o") + 1])
                 for js, ps in zip(steps, pcases[case])]
        out[case] = ([next(jrcs) for _ in steps],
                     [next(prcs) for _ in steps], pairs)
    return out, port


def check_case(result, port, case):
    """Both exit codes 0 at every step, every port output equal to the
    JAX package's; returns the JAX outputs' record lines."""
    jrcs, prcs, pairs = result[case]
    assert jrcs == [0] * len(jrcs)
    assert prcs == [0] * len(prcs), port["stderr"][-3000:]
    for want, got in pairs:
        assert output_lines(got) == output_lines(want), (case, got)
    return [[ln for ln in output_lines(w) if not ln.startswith("#")]
            for w, _ in pairs]


def depth_windows(rng, n, boundary_share=0.5):
    """Seeded CNV window inputs (covsum, expcov, ok) for the window math
    (ops/depth_math.window_depth): integer fragment sums, GC-expected
    coverages with a few zeros, ~10% of windows not callable. A share
    of the windows is solved so that their logR (or, every fourth of
    those, their cn at expected_cn 2, purity 1 and ctrl_ploidy 2) lies
    on a rounding boundary of the coverage file's %g: halfway between
    two six-digit values, where the last bit of a float64 decides the
    printed digit."""
    import numpy as np

    covsum = np.floor(rng.gamma(20.0, 8.0, n))
    expcov = rng.gamma(20.0, 8.0, n)
    expcov[rng.random(n) < 0.02] = 0.0
    ok = rng.random(n) > 0.1
    k = int(n * boundary_share)
    half = ((rng.integers(100_000, 1_000_000, k) + 0.5)
            * 10.0 ** rng.integers(-7, -4, k).astype(np.float64))
    sign = np.where(rng.random(k) < 0.5, -1.0, 1.0)
    c = covsum[:k]
    exp_logr = (c + 1.0) / np.exp2(sign * half) - 1.0
    exp_cn = 2.0 * c / half
    pick = np.arange(k) % 4 == 0
    sol = np.where(pick, exp_cn, exp_logr)
    keep = np.isfinite(sol) & (sol > 0)
    expcov[:k][keep] = sol[keep]
    return covsum, expcov, ok
