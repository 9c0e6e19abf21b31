"""Which window outputs the reference checks: the pool's first two
rounds, a sample spread over the whole window, and the last batch."""

import numpy as np
import pytest

from svbench import harness


class _Eng:
    def keep(self, out):
        return out


def _kept(batches, pool, cap, seed=5):
    k = harness.Keeper(_Eng(), pool, cap, seed)
    for n in range(batches):
        k.offer(n, n % pool, n, n == batches - 1)
    return k.by_pool()


@pytest.mark.parametrize("batches", [3, 40, 100_000])
def test_head_sample_and_last(batches):
    kept = _kept(batches, 4, 64)
    got = sorted(o for outs in kept.values() for o in outs)
    assert len(got) <= 65
    assert got[:min(8, batches)] == list(range(min(8, batches)))
    assert got[-1] == batches - 1
    assert all(o % 4 == i for i, outs in kept.items() for o in outs)
    if batches > 64:
        assert len(got) in (64, 65)


def test_the_sample_spreads_over_the_window():
    got = np.array(sorted(o for outs in _kept(100_000, 1024, 128).values()
                          for o in outs))
    later = got[got >= 64]
    # a uniform sample of the batches past the head: each quarter of the
    # window holds some of it
    assert len(later) >= 64
    assert all(((later >= q * 25_000) & (later < (q + 1) * 25_000)).sum() >= 5
               for q in range(4))


def test_the_sample_follows_the_seed():
    assert _kept(5000, 4, 32, 1) == _kept(5000, 4, 32, 1)
    assert _kept(5000, 4, 32, 1) != _kept(5000, 4, 32, 2)
