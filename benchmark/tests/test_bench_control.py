"""The correctness control: the reference itself, every product rounded to
TF32 (the step below the float32 the configurations state), put in the
program's place, fails each cell's limits; the program passes them.  The
adaptive cell runs its own configuration (the trained asset at its
geometry, which is what sets its readings) at batch 2; the others run tiny."""

from __future__ import annotations

import pytest

from conftest import WORKLOADS, drive_tiny


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes(workload):
    widths = workload == "tante_adaptive-k8-trl"
    _, check, limits = drive_tiny(workload, seconds=0.01 if widths else 0.05, widths=widths)
    program, control = check(), check("tf32")
    assert all(v <= limits[k] for k, v in program.items()), program
    assert any(not v <= limits[k] for k, v in control.items()), control
