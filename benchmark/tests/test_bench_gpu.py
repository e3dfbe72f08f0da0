"""On the card, at each cell's own size: a short run of the program passes
the cell's limits, and the TF32 control fails them (the readings the limits
were set from come from ``calibrate.py`` over a dozen seeds and more)."""

from __future__ import annotations

import io
import time
from types import SimpleNamespace

import pytest

from conftest import WORKLOADS


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload):
    import torch

    from harness import core

    spec = core.load_spec()
    cell = core.find_cell(spec, workload)
    config, traffic = core.config_of(cell), core.traffic_of(cell)
    ctx = SimpleNamespace(config=config, traffic=traffic, adapter=core.adapter_of(config),
                          seed=2 ** 31 + 17, seconds=4.0, trace=False, device=card,
                          t0=time.perf_counter(),
                          peaks=core.peaks_for(torch.cuda.get_device_name(0)), log=io.StringIO())
    rec, check = core.runner_of(traffic).run(ctx)
    limits = core.limits_of(workload)
    program, control = check(), check("tf32")
    assert rec.failed == 0
    assert all(v <= limits[k] for k, v in program.items()), program
    assert any(not v <= limits[k] for k, v in control.items()), control
