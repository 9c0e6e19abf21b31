"""The plain references against brute force and against the port's
host oracle, and their imports."""

import ast
import itertools
import os

import numpy as np
import pytest
import torch

from svbench.reference import edit, gotoh, lcs

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")


def brute_edit(q, t, mode):
    m, n = len(q), len(t)
    D = [[0] * (n + 1) for _ in range(m + 1)]
    for j in range(n + 1):
        D[0][j] = j if mode == edit.NW else 0
    for i in range(1, m + 1):
        D[i][0] = i
        for j in range(1, n + 1):
            D[i][j] = min(D[i - 1][j - 1] + (q[i - 1] != t[j - 1]),
                          D[i - 1][j] + 1, D[i][j - 1] + 1)
    return D[m][n] if mode == edit.NW else min(D[m])


def brute_lcs(a, b):
    L = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    for i, j in itertools.product(range(1, len(a) + 1), range(1, len(b) + 1)):
        L[i][j] = (L[i - 1][j - 1] + 1 if a[i - 1] == b[j - 1]
                   else max(L[i - 1][j], L[i][j - 1]))
    return L[-1][-1]


def _batch(rng, n, M, N, alpha=b"ACGT"):
    q = np.zeros((n, M), np.uint8)
    t = np.zeros((n, N), np.uint8)
    ql = rng.integers(1, M + 1, n)
    tl = rng.integers(0, N + 1, n)
    letters = np.frombuffer(alpha, np.uint8)
    for k in range(n):
        q[k, :ql[k]] = letters[rng.integers(0, len(letters), ql[k])]
        t[k, :tl[k]] = letters[rng.integers(0, len(letters), tl[k])]
    return q, ql, t, tl


@pytest.mark.parametrize("mode", [edit.NW, edit.HW])
def test_edit_distance_matches_brute_force(mode):
    rng = np.random.default_rng(3)
    q, ql, t, tl = _batch(rng, 40, 12, 17)
    got = edit.edit_distance(torch.from_numpy(q), torch.from_numpy(ql),
                             torch.from_numpy(t), torch.from_numpy(tl), mode)
    want = [brute_edit(list(q[k, :ql[k]]), list(t[k, :tl[k]]), mode)
            for k in range(len(q))]
    assert got.tolist() == want


def test_banded_edit_distance_is_an_upper_bound():
    rng = np.random.default_rng(4)
    q, ql, t, tl = _batch(rng, 40, 30, 30)
    args = [torch.from_numpy(x) for x in (q, ql, t, tl)]
    exact = edit.edit_distance(*args, edit.NW)
    banded = edit.edit_distance(*args, edit.NW, band=2)
    assert (banded >= exact).all() and (banded > exact).any()


def test_lcs_matches_brute_force():
    rng = np.random.default_rng(5)
    a, al, b, bl = _batch(rng, 40, 15, 21)
    got = lcs.lcs_length(*(torch.from_numpy(x) for x in (a, al, b, bl)))
    want = [brute_lcs(list(a[k, :al[k]]), list(b[k, :bl[k]]))
            for k in range(len(a))]
    assert got.tolist() == want


def _alignment(rng, rows, cols):
    a = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, cols))]
    if rows > 1:
        a = a.copy()
        a[rng.random((rows, cols)) < 0.2] = ord("-")
        for r in range(rows):
            a[r, :rng.integers(0, cols // 3)] = ord("-")
    return a


@pytest.mark.parametrize("rows", [(1, 1), (1, 3), (4, 2)])
def test_gotoh_matches_the_ports_host_oracle(rows):
    """Score and merged alignment equal ops/gotoh.py gotoh(), the port's
    host copy of delly's gotoh.h, with end gaps free on both sides."""
    from delly_tpu_torch.ops.gotoh import create_alignment_codes
    from delly_tpu_torch.ops.gotoh import gotoh as oracle

    rng = np.random.default_rng(sum(rows))
    jobs = [(_alignment(rng, rows[0], int(rng.integers(5, 30))),
             _alignment(rng, rows[1], int(rng.integers(5, 30))))
            for _ in range(12)]
    G = len(jobs)
    R1, R2 = rows
    M = max(a.shape[1] for a, _ in jobs)
    N = max(b.shape[1] for _, b in jobs)
    a1 = np.zeros((G, R1, M), np.uint8)
    a2 = np.zeros((G, R2, N), np.uint8)
    for g, (x, y) in enumerate(jobs):
        a1[g, :, :x.shape[1]] = x
        a2[g, :, :y.shape[1]] = y
    m = torch.tensor([x.shape[1] for x, _ in jobs])
    n = torch.tensor([y.shape[1] for _, y in jobs])
    best, codes, lens = gotoh.merge(torch.from_numpy(a1), torch.full(
        (G,), R1), m, torch.from_numpy(a2), torch.full((G,), R2), n)
    for g, (x, y) in enumerate(jobs):
        score, merged = oracle(x, y, ac=(True, True))
        assert int(best[g]) == score
        fwd = codes[g, :int(lens[g])].numpy()[::-1].astype(np.int64)
        assert np.array_equal(create_alignment_codes(fwd, x, y), merged)


def test_reference_imports_nothing_of_the_program():
    banned = {"jax", "jaxlib", "flax", "delly_tpu", "delly_tpu_torch"}
    for name in sorted(os.listdir(REF_DIR)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF_DIR, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, (name, mod)
