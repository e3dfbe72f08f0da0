"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell, its configuration, traffic mix, metrics and limits are
found by name (``harness/core.py``).  Set-up (building the program,
drawing weights and inputs, warming up every shape the traffic uses) is
timed from the start of this process; then the window runs for
``--seconds``; then the answers are checked against the plain reference.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced run.  The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.

Exit codes: 0 with a result; 2 without the card(s) the cell needs; 3 when a
forbidden module (the JAX stack or the JAX package) is loaded; 4 when the
traced run's profile held no device operation.
"""

import time

T0 = time.perf_counter()  # noqa: E402 -- set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
# The harness's own modules, and the checkout's root, which holds the program.
sys.path[:0] = [str(HERE), str(HERE.parent)]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t0: float, config=None, traffic=None, limits=None, out=sys.stdout,
             log=sys.stderr) -> int:
    """Set-up, window, check, result line.  ``config``, ``traffic`` and
    ``limits`` default to the cell's files."""
    import torch

    from harness import core

    cell = core.find_cell(spec, workload)
    config = config or core.config_of(cell)
    traffic = traffic or core.traffic_of(cell)
    limits = limits or core.limits_of(workload)
    on_card = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    ctx = SimpleNamespace(config=config, traffic=traffic, adapter=core.adapter_of(config),
                          seed=seed, seconds=seconds, trace=bool(trace), device=device, t0=t0,
                          peaks=core.peaks_for(kind), log=log)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    rec, check = core.runner_of(traffic).run(ctx)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = rec.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in core.metrics_for(spec, workload, bool(trace)):
        value = core.reader_of(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell["workload"]["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        if rec.trace is None:
            print("the traced window's profile held no device operation", file=log)
            return 4
        dev["busy_s"], dev["window_s"] = rec.trace.busy_s, rec.trace.window_s
        breakdown = rec.trace.breakdown()
    found = core.forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=log, flush=True)
        return 3
    core.print_checks(checks, log)
    print(core.result_line(correct, rec.attempted, rec.failed, metrics, dev, checks, breakdown,
                           rec.roofline_bounds if trace else None), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import core

    spec = core.load_spec()
    chips = core.find_cell(spec, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    return run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)


if __name__ == "__main__":
    sys.exit(main())
