"""A run with the timed path broken underneath the harness comes out
not correct: an answer altered where it is produced, and half of the
batch left out (its answers never computed)."""

import pytest
import torch


def _altered(fn, pick):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        pick(first)
        return out
    return broken


def _one_off(x):
    x.view(-1)[0] += 1


def _half_missing(x):
    x.view(x.shape[0], -1)[x.shape[0] // 2:] = 0


FAULTS = {"altered": _one_off, "half_batch": _half_missing}
TARGETS = [("sr1kg.geno", "delly_tpu_torch.ops.myers_cuda", "myers"),
           ("ont.cons", "delly_tpu_torch.ops.myers_cuda", "myers"),
           ("sr1kg.asm", "delly_tpu_torch.ops.lcs_cuda", "lcs"),
           ("sr1kg.asm", "delly_tpu_torch.ops.gotoh_cuda", "gotoh_forward"),
           ("sr1kg.asm", "delly_tpu_torch.ops.gotoh_cuda", "gotoh_traceback")]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell,module,fn", TARGETS)
def test_a_broken_path_is_not_correct(cell, module, fn, fault, tiny_root,
                                      cpu, bench, monkeypatch):
    import importlib

    from svbench import harness

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, fn, _altered(getattr(mod, fn), FAULTS[fault]))
    out = harness.run(cell, 77, 0.05, False, cpu, bench, root=tiny_root)
    assert out["result"]["correct"] is False
    assert out["result"]["failed"] >= 1
    assert any(v > lim for v, lim in out["checks"].values())
