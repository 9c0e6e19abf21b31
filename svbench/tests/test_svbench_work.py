"""Cells, operations and bytes on hand-worked batches."""

import pytest

from svbench.metrics import _peaks, _work


def test_myers_counts():
    # a 30-row query (one word) and a 40-row one (two), targets 100 and 50
    ops, nbytes = _work.myers([30, 40], [100, 50], mode=0)
    assert ops == 10 * 100 + (10 + 11) * 50
    assert nbytes == 30 + 40 + 100 + 50 + 12 * 2 + 256
    ops_hw, _ = _work.myers([30, 40], [100, 50], mode=2)
    assert ops_hw == ops + 4 * 150


def test_gotoh_counts():
    ops, nbytes = _work.gotoh([100, 110], [100, 120], [False, True])
    assert ops == (11 + 2) * 100 * 100 + (11 + 7) * 110 * 120
    assert nbytes == (24 * 200 + 12 + 10000) + (24 * 230 + 12 + 13200)


def test_walk_and_lcs_counts():
    assert _work.gotoh_tb([150, 200]) == (3 * 350, 2 * 350 + 24)
    assert _work.lcs(1000, [100, 100], [100, 130]) == (
        6 * 1000, 200 + 230 + 24 + 256)


def test_bound_takes_the_larger():
    assert _work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert _work.bound_s(_peaks.INT32_OPS_PER_S, 1) == pytest.approx(1.0)
    assert _peaks.INT32_OPS_PER_S == pytest.approx(1.6727e13, rel=1e-4)


def test_k1_engine_cells_and_bound(tiny_root, cpu):
    from svbench import harness

    cell, config = harness.load_cell("sr1kg.geno", tiny_root)
    eng = harness.engine_class("k1")(cell, config, 3, cpu, harness.Spans())
    b = eng.pool[0]
    assert eng.cells(0) == int((b["qlens"] * b["tlens"]).sum())
    assert eng.work(0)["k1"] == pytest.approx(_work.bound_s(
        *_work.myers(b["qlens"], b["tlens"], 2)))
