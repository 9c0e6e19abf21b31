"""The traffic makers: repeatable by seed, the same sizes for every
seed, and the port's own packing."""

import numpy as np
import pytest
import torch

from svbench import harness
from svbench.gen import dna, msa_rounds

CELLS = ("sr1kg.geno", "ont.cons", "sr1kg.asm")


def _flat(pool):
    out = []
    for b in pool:
        for k in sorted(b):
            v = b[k]
            if isinstance(v, dict):
                out += _flat([v])
            elif isinstance(v, list):
                out += _flat(v)
            elif isinstance(v, torch.Tensor):
                out.append(v.cpu().numpy())
            elif isinstance(v, np.ndarray):
                out.append(v)
    return out


def _pool(name, root, seed, cpu):
    cell, config = harness.load_cell(name, root)
    return harness.engine_class(cell["engine"])(
        cell, config, seed, cpu, harness.Spans()).pool


@pytest.mark.parametrize("name", CELLS)
def test_makers_repeat_by_seed(name, tiny_root, cpu):
    a = _flat(_pool(name, tiny_root, 2**33 + 1, cpu))
    b = _flat(_pool(name, tiny_root, 2**33 + 1, cpu))
    c = _flat(_pool(name, tiny_root, 2**33 + 2, cpu))
    assert len(a) == len(b) == len(c)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c)
                   if x.shape == y.shape)


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_sizes(name, tiny_root, cpu):
    cell, config = harness.load_cell(name, tiny_root)

    def sizes(seed):
        eng = harness.engine_class(cell["engine"])(
            cell, config, seed, cpu, harness.Spans())
        return sorted(eng.cells(i) for i in range(len(eng.pool)))

    assert sizes(11) == sizes(2**31 + 7)


def test_quota_is_exact():
    assert dna.quota([1, 1, 1], 10).tolist() == [4, 3, 3]
    assert dna.quota([0.2, 0.8], 7).sum() == 7


def test_noisy_copy_rates():
    g = dna.generator(5, "cpu")
    tmpl = dna.random_codes(g, (64, 2000), "cpu")
    out, lens = dna.noisy_copy(g, tmpl, 0.05, 0.0, 2000)
    assert (lens == 2000).all()
    assert 0.04 < float((out != tmpl).float().mean()) < 0.06
    out, lens = dna.noisy_copy(g, tmpl, 0.0, 0.05, 2200)
    # as many insertions as deletions: the copies keep about their length
    assert abs(float(lens.float().mean()) - 2000) < 10
    assert len(set(lens.tolist())) > 1
    out, lens = dna.noisy_copy(g, tmpl, 0.05, 0.05, 1900)
    assert (lens == 1900).all()


def test_msa_packing_equals_the_ports_pack_bucket(tiny_root, cpu):
    from delly_tpu_torch.ops.gotoh import DnaScore
    from delly_tpu_torch.ops.gotoh_cuda import pack_bucket

    cell, config = harness.load_cell("sr1kg.asm", tiny_root)
    pool = msa_rounds.make(cell, config, 9, cpu)
    multi = 0
    for grp in pool[0]["groups"]:
        jobs = [(grp["a1"][g, :int(grp["r1"][g]), :int(grp["m"][g])].numpy(),
                 grp["a2"][g, :int(grp["r2"][g]), :int(grp["n"][g])].numpy())
                for g in range(len(grp["m_h"]))]
        want = pack_bucket(jobs, grp["K"], DnaScore())
        for w, key in zip(want, ("prof", "wc2", "d2", "ml", "nl")):
            assert np.array_equal(w, grp[key].numpy()), key
        multi += int(grp["multi"].sum())
    assert multi > 0
