"""What every cell of the benchmark shares: finding a cell's files by name,
the statistics, derived seeds, the import check and the result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix.  The harness finds, by those names alone:

- ``configs[].file``: the configuration as it is run; its ``family`` names
  the adapter ``benchmark/models/<family>.py`` that builds the program and
  the plain reference for it;
- ``benchmark/traffic/<traffic>.json``: the traffic mix; its ``kind`` names
  the runner ``benchmark/harness/<kind>.py`` that generates and times it;
- ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(run)``
  -> a number, or None where the run holds nothing to read (a metric
  ``<quantity>.<part>`` without a file of its own is read by
  ``<quantity>.py``);
- ``benchmark/limits/<workload>.json``: the limit of each number that
  decides ``correct``.

So a later change adds a configuration, a traffic mix, a metric or a cell
by adding files and ``BENCHMARK.json`` entries.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List, Optional, Sequence

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# Top-level module names that no run may load: the JAX stack and the JAX
# package beside the port (whose own name only starts with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "tante_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def find_cell(spec: dict, workload: str) -> dict:
    """The cell's ``workloads`` entry, its ``configs`` entry and the
    metrics that apply to it."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return {"workload": cell, "config": configs[cell["config"]]}


def metrics_for(spec: dict, workload: str, trace: bool) -> List[dict]:
    """``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
    per-layer metrics (those that list it, or list no cells and move an
    end-to-end metric the cell reports)."""
    def applies(m: dict) -> bool:
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import a file of the benchmark by its path."""
    name = name or "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_of(cell: dict, root: Path = ROOT) -> dict:
    return read_json(root / cell["config"]["file"])


def traffic_of(cell: dict) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{cell['workload']['traffic']}.json")


def limits_of(workload: str) -> dict:
    return read_json(BENCH_DIR / "limits" / f"{workload}.json")


def adapter_of(config: dict) -> ModuleType:
    return load_module(BENCH_DIR / "models" / f"{config['family']}.py")


def runner_of(traffic: dict) -> ModuleType:
    return load_module(BENCH_DIR / "harness" / f"{traffic['kind']}.py")


def reader_of(metric: str) -> ModuleType:
    """The reader ``metrics/<metric>.py``, or for a metric ``<quantity>.<part>``
    without a reader of its own, ``metrics/<quantity>.py``: one quantity
    split over cells that report different end-to-end metrics."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = BENCH_DIR / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    return load_module(path)


def synchronize(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- seeds ---------------------------------------------------------------------

def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: any
    whole number, negative or past 64 bits included."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


# -- statistics -----------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default rule)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def worst(a: float, b: float) -> float:
    """The larger of two readings, where NaN is the largest of all."""
    if a != a or b != b:
        return float("nan")
    return max(a, b)


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| of two tensors, in float64."""
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm())


# -- the import check --------------------------------------------------------

def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The names whose top-level part (before the first dot) is one of
    ``FORBIDDEN`` as a whole word: ``tante_tpu.ops`` is, ``tante_tpu_torch``
    is not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


# -- the result line ---------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, checks: Dict[str, dict], breakdown: Optional[dict] = None,
                roofline_bounds: Optional[Dict[str, str]] = None) -> str:
    """The contract's last line of standard output; ``roofline_bounds``
    names, for each group of kernels with a roofline share, the bound that
    sets it ("operations" or "bytes"); ``checks`` (each number compared,
    with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if roofline_bounds:
        out["roofline_bounds"] = roofline_bounds
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: Dict[str, dict], stream=sys.stderr) -> None:
    """Each number compared beside its limit, one line each."""
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {verdict}", file=stream,
              flush=True)


# -- one run's record, which the metric readers read --------------------------

@dataclass
class Run:
    """What a run measured, unit by unit (a unit is one rollout)."""

    kind: str
    config: dict
    traffic: dict
    adapter: ModuleType
    peaks: Optional[dict]
    setup_s: float = float("nan")
    window_s: float = float("nan")
    attempted: int = 0
    failed: int = 0
    latencies_s: List[float] = field(default_factory=list)  # call to its synchronise
    enqueue_s: List[float] = field(default_factory=list)    # call to its return
    frames_per_unit: int = 0
    calls: List[int] = field(default_factory=list)          # model calls a unit (traced runs)
    ops: List[float] = field(default_factory=list)          # the algorithm's operations a unit
    trace: Optional[object] = None                          # harness.trace.Trace
    trace_block_bound_s: float = float("nan")
    roofline_bounds: Dict[str, str] = field(default_factory=dict)  # kernels -> their bound

    @property
    def units(self) -> int:
        return self.attempted - self.failed


def peaks_for(kind: str) -> Optional[dict]:
    """The card's published peaks (``harness/peaks.json``) by its name."""
    table = read_json(BENCH_DIR / "harness" / "peaks.json")
    for key, row in table.items():
        if key in kind:
            return row
    return None
