"""Fixtures of svbench's tests: tiny copies of the cells for the CPU,
and the card, decided inside a fixture (never at import)."""

import json
import os
import shutil

import pytest

from svbench import harness

# each cell at a size the CPU runs in seconds: the same files, a few
# keys overridden
TINY = {
    "sr1kg.geno": {"jobs_per_batch": 48, "pool_batches": 2},
    "ont.cons": {"calls": 2, "frozen": {"msa_calls": [
        {"msa": "edlib", "lengths": [300, 420, 500, 500], "count": 1},
        {"msa": "wfa", "lengths": [900, 900], "count": 1}]}},
    "sr1kg.asm": {"svs": 12, "pool_batches": 1, "check_merges": 32},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped here otherwise)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu(monkeypatch):
    """The port's plain versions on the host."""
    import torch

    from delly_tpu_torch.utils import torchenv

    monkeypatch.setenv(torchenv.ENV, "cpu")
    torchenv.reset()
    yield torch.device("cpu")
    torchenv.reset()


@pytest.fixture
def bench():
    return harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of svbench's configs, cells and metrics with every cell at
    its TINY size."""
    for sub in ("configs", "metrics"):
        shutil.copytree(os.path.join(harness.SVBENCH, sub), tmp_path / sub)
    os.makedirs(tmp_path / "workloads")
    for name, over in TINY.items():
        cell = harness.load_json(os.path.join(harness.SVBENCH, "workloads",
                                              f"{name}.json"))
        cell.update(over)
        with open(tmp_path / "workloads" / f"{name}.json", "w") as fh:
            json.dump(cell, fh)
    return str(tmp_path)
