"""The control fails: the reference put in the program's place and computed
in TF32, the precision below the float32 the configuration states, reads
past a limit, at the cell's own size, on one card. Needs the
card (TF32 exists only there); run it as the README says."""

from __future__ import annotations

import pytest

from port_bench import checks, harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hdce_train.p128_6q"])
def test_the_tf32_control_is_not_correct(cell, card):
    man = harness.manifest()
    drv = harness.driver_for(cell, 4000000007, float(man["run_seconds"]), card, man=man)
    drv.make_inputs()
    ok, judged = checks.judge(drv.control("tf32"), checks.load_limits(cell))
    assert not ok, judged
