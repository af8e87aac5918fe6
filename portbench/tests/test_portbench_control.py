"""Each cell's control comes out not correct: on the CPU at a small size
(the program's plain kernel versions; at small frames few values lie off,
so the program's ratio rests on a few dozen and is only held below its
control), and (marked ``card``) on the card at the cell's own
size, where the program comes out correct. The control of a bfloat16
configuration is the program's own int8 path; that of the int8
configuration the reference with 4-bit convs."""

import pytest

from portbench import control, spec
from portbench.tests.util import cpu, tiny

CELLS = ["bf16-1080p-x2", "int8-1080p-x2"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_cpu(name):
    parts = tiny(name, 128, 192, pool_batches=1)
    r = control.readings(parts, 2 ** 31 + 3, 0.3, cpu())
    lim = parts["limits"]["off2_ratio"]
    assert r["program"] < r["control"] and lim < r["control"], (r, lim)


@pytest.mark.card
@pytest.mark.parametrize("name", [c["name"] for c in spec.benchmark()["workloads"]])
def test_control_fails_and_program_passes_on_card(name, card):
    parts = spec.cell(name)
    r = control.readings(parts, 2 ** 31 + 5, 2.0, card)
    lim = parts["limits"]["off2_ratio"]
    assert r["program"] <= lim < r["control"], (r, lim)
