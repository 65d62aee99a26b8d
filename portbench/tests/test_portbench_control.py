"""The control comes out as not correct, the program as correct, at a
size a test run holds (the cell sizes run on the card through
``portbench/control.py``)."""
import pytest

import smoke
from portbench import control
from portbench.harness import spec


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", [smoke.VISION, smoke.LM])
def test_control_fails_program_passes(root, cell):
    limits = spec.resolve(root, cell).limits["limits"]
    rows = list(control.readings(root, cell, [21, 22, 23], 0.2, "cpu"))
    assert [r["kind"] for r in rows] == ["program", "control"] * 3
    for r in rows:
        ok = all(r[k] <= v for k, v in limits.items())
        assert ok == (r["kind"] == "program"), r
