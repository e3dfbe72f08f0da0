"""CPU tests of the benchmark's harness, reference and counts; the tests that
need the card carry the ``gpu`` marker and skip inside the ``card``
fixture.  Run from the checkout's root:

    python -m pytest benchmark/tests -p no:randomly          # here, on the CPU
    python -m pytest benchmark/tests -m gpu -p no:xdist      # on the card
"""

from __future__ import annotations

import copy
import io
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


def tiny(workload: str, widths: bool = False):
    """(spec, config, traffic, limits) of a cell at a size the CPU runs in
    seconds: batches of 2, 3 batches, and, unless ``widths``, 32 x 64 frames,
    width 32, 4 heads, 5 rollout steps and seeded weights (with ``widths``:
    the configuration as it is, its geometry and weights).  The cell's own
    limits."""
    from harness import core

    spec = core.load_spec()
    cell = core.find_cell(spec, workload)
    cfg = copy.deepcopy(core.config_of(cell))
    tf = copy.deepcopy(core.traffic_of(cell))
    tf.update(batch=2, batches=3, check_batches=2)
    tf["warmup"] = min(tf.get("warmup", 3), 3)
    if not widths:
        cfg["geometry"]["resolution"] = [32, 64]
        cfg["model"].update(embed_dim=32, n_head=4)
        cfg["weights"] = {"asset": None}
        tf["n_steps"] = 5
        if "max_frames_per_call" in tf:
            tf["max_frames_per_call"] = 3
    return spec, cfg, tf, core.limits_of(workload)


def run_tiny(workload: str, seed: int = 2 ** 33 + 5, seconds: float = 0.2) -> dict:
    """A whole run of the cell at ``tiny`` size on the CPU, past the look
    for a card: its result line."""
    import run as bench_run

    spec, cfg, tf, limits = tiny(workload)
    out, log = io.StringIO(), io.StringIO()
    rc = bench_run.run_cell(spec, workload, seed, seconds, False, "cpu", time.perf_counter(),
                            config=cfg, traffic=tf, limits=limits, out=out, log=log)
    assert rc == 0, log.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


WORKLOADS = ("tante-fixed16-trl", "tante_adaptive-k8-trl")


def drive_tiny(workload: str, seed: int = 2 ** 33 + 7, seconds: float = 0.05,
               widths: bool = False):
    """The cell's runner at ``tiny`` size on the CPU: (record, check, limits)."""
    from types import SimpleNamespace

    from harness import core

    _, cfg, tf, limits = tiny(workload, widths)
    ctx = SimpleNamespace(config=cfg, traffic=tf, adapter=core.adapter_of(cfg), seed=seed,
                          seconds=seconds, trace=False, device="cpu", t0=time.perf_counter(),
                          peaks=None, log=io.StringIO())
    rec, check = core.runner_of(tf).run(ctx)
    return rec, check, limits
