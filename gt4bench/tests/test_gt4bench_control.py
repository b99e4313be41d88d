"""The control of each configuration, the plain reference in the
program's place with one guarantee broken, comes out wrong; the same
comparison passes the program."""

import pytest

from gt4bench import control, manifest
from gt4bench.tests import tiny


@pytest.mark.parametrize("seed", [1, 2, (1 << 31) + 3])
@pytest.mark.parametrize("name", sorted(tiny.OVERRIDES))
def test_control_comes_out_wrong(name, seed):
    cell = manifest.cell(name)
    # the small lane's counts pass 255 only over many passes
    passes = 400 if cell.config["driver"] == "gmer_counter" else 2
    got = control.readings(cell, seed, passes, "cpu", tiny.OVERRIDES[name])
    assert got and all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("name", sorted(tiny.OVERRIDES))
def test_program_comes_out_right(name):
    r = tiny.run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"
