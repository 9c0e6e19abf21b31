"""The PyTorch port stands alone: no module of delly_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package delly_tpu.
Also the port's device and host-axis rules."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "delly_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_delly_tpu_imports():
    files = _port_files()
    assert len(files) > 40
    bad = [(os.path.relpath(p, REPO), mod) for p in files
           for mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "delly_tpu")]
    assert bad == []


def test_cuda_device_without_card_raises(monkeypatch):
    import torch

    from delly_tpu_torch.utils import torchenv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in ("cuda", ""):
        monkeypatch.setenv(torchenv.ENV, value)
        torchenv.reset()
        with pytest.raises(RuntimeError):
            torchenv.device()
    monkeypatch.setenv(torchenv.ENV, "auto")
    torchenv.reset()
    with pytest.raises(ValueError):
        torchenv.device()
    monkeypatch.setenv(torchenv.ENV, "cpu")
    torchenv.reset()
    assert torchenv.device().type == "cpu"
    torchenv.reset()


def test_host_axis_is_single_process(monkeypatch):
    from delly_tpu_torch.parallel import hostaxis

    for var in ("DELLY_TPU_DIST", "DELLY_TPU_COORD", "DELLY_TPU_NPROC"):
        monkeypatch.delenv(var, raising=False)
    assert hostaxis.maybe_init() is False
    assert hostaxis.process_count() == 1 and hostaxis.is_writer()
    assert hostaxis.exchange_owned({1: "a"}) == {1: "a"}
    monkeypatch.setenv("DELLY_TPU_COORD", "localhost:1234")
    monkeypatch.setenv("DELLY_TPU_NPROC", "2")
    with pytest.raises(RuntimeError):
        hostaxis.maybe_init()


def test_other_words_not_ported(capsys):
    from delly_tpu_torch.cli import NOT_PORTED, main

    for word in NOT_PORTED:
        assert main([word, "x"]) == 1
    assert "not yet in the PyTorch port" in capsys.readouterr().err


@pytest.mark.parametrize("name,args", [
    ("process_index", ()), ("process_count", ()), ("is_writer", ()),
    ("owner_of", (5,)), ("owns", (5,)), ("partition_plan", ([3, 1, 2],)),
    ("allgather_obj", ({"sv": 1},)), ("exchange_owned", ({2: "b"},)),
    ("barrier", ("lr-done",)),
])
def test_host_axis_identities_match_jax(monkeypatch, name, args):
    """Every host-axis helper the sr and lr drivers call gives, in one
    process, what the JAX package's gives outside a process world."""
    from delly_tpu.parallel import hostaxis as jhostaxis
    from delly_tpu_torch.parallel import hostaxis

    for var in ("DELLY_TPU_DIST", "DELLY_TPU_COORD", "DELLY_TPU_NPROC"):
        monkeypatch.delenv(var, raising=False)
    assert getattr(hostaxis, name)(*args) == getattr(jhostaxis, name)(*args)
