"""The control, the plain reference computed approximately (a band of
diagonals, the configurations' `control`) and put in the program's
place, comes out not correct, while the program's outputs compare
exactly: at a size the CPU holds here, and at the cells' own sizes on
the card (`python3 -m svbench.control` prints the same readings)."""

import pytest

from svbench import control

CELLS = ("sr1kg.geno", "ont.cons", "sr1kg.asm")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_on_the_host(name, tiny_root, cpu):
    hits = 0
    for seed in (1, 2, 3):
        r = control.readings(name, seed, cpu, True, root=tiny_root)
        assert all(v == 0 for v in r["program"].values())
        hits += any(v > 0 for v in r["control"].values())
    assert hits == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    for seed in (101, 102, 103):
        r = control.readings(name, seed, card, True)
        assert all(v == 0 for v in r["program"].values())
        assert any(v > 0 for v in r["control"].values())
