"""A cell's traced run with the program's own spans and counters recorded,
on the card, in one process:

    python3 benchmark/program_trace.py --workload <name> --seed <n> [--turns 8]

The cell's set-up (weights, the program, inputs, the warm-up) runs inside
``profiling.record()``; then ``trace_units`` rollouts are profiled as a
traced run profiles them, the program recorded and its record cut per unit,
its spans joined to the harness's own host spans where the device's idle
gaps are labelled (``harness/program.py``); then the same rollouts are timed
without the profiler, with recording off and on in turns (off, on, on, off,
...), for what recording costs.  Prints one JSON line: the set-up's seconds,
the per-layer readings of ``metrics/`` that read the program beside the
harness's own ones they stand beside, the breakdown, and the turns.  The
cell's answers are not checked here: ``run.py`` checks them.
"""

import time

T0 = time.perf_counter()  # noqa: E402 -- set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

# Readers of the program's record, and the harness's own readings beside them.
PROGRAM_READERS = ("host_syncs", "program_calls", "sync_wait_ms", "launch_idle_ms",
                   "model_setup_s", "kernel_load_s")
HARNESS_READERS = ("model_calls", "device_idle", "launches", "block_kernel_ms",
                   "other_device_ms")


def setup(cfg: dict, tf: dict, seed: int, dev: str):
    """The runner's set-up (``harness/rollout.py``): -> (program, call,
    histories)."""
    from harness import core, waves

    ad = core.adapter_of(cfg)
    res, _ = ad.geometry(cfg)
    w = ad.weights(cfg, seed, dev)
    program = ad.predictor(cfg, w, dev)
    hist = waves.trajectories(tf, seed, res, tf["history"], dev)
    call = ad.rollout_call(program, tf)
    for i in range(tf["warmup"]):
        call(hist[i % len(hist)])
        core.synchronize(dev)
    return program, call, hist


def profiled(program, call, hist, tf: dict, dev: str, prog):
    """``trace_units`` rollouts under the profiler with the program recorded
    into ``prog`` (a ``harness.program.Program``): -> (the trace, model
    calls a unit by the harness's wrapper)."""
    from harness import core, trace
    from harness.program import host_spans
    from tante_tpu_torch.utils import profiling

    spans = trace.Spans(program.model)
    calls = []
    n = len(hist)
    with profiling.record() as rec:
        def unit(j):
            if j == 0:  # a profile taken again starts its units again
                prog.units.clear()
                calls.clear()
            with spans.span("rollout"):
                call(hist[j % n])
            with spans.span("sync"):
                core.synchronize(dev)
            unit_spans, counters = rec.take()
            spans.spans.extend(host_spans(unit_spans))
            prog.units.append((unit_spans, counters))
            calls.append(len(spans.take()))

        rec.take()
        got = trace.profile_units(unit, tf["trace_units"], spans)
    spans.remove()
    return got, calls


def turns(call, hist, m: int, n_turns: int, dev: str) -> dict:
    """Rollouts timed call to synchronise, ``m`` a turn, with recording off
    and on in turns (off, on, on, off, ...); each turn's mean ms."""
    from harness import core
    from tante_tpu_torch.utils import profiling

    out = {"off": [], "on": []}
    for t in range(n_turns):
        on = t % 4 in (1, 2)
        times = []
        with profiling.record() if on else contextlib.nullcontext() as rec:
            for j in range(m):
                t0 = time.perf_counter()
                call(hist[j % len(hist)])
                core.synchronize(dev)
                times.append(time.perf_counter() - t0)
                if rec is not None:
                    rec.take()
        out["on" if on else "off"].append(1e3 * statistics.mean(times))
    off, on = statistics.median(out["off"]), statistics.median(out["on"])
    return {"turn_ms": out, "off_ms": off, "on_ms": on, "on_cost_pct": 100.0 * (on - off) / off}


def idle_span_ns(n: int = 200_000) -> float:
    """Host nanoseconds of one ``span`` entered and left with nothing
    recording (the cost every span has on the untraced path)."""
    from tante_tpu_torch.utils.profiling import span

    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("tante.blocks"):
            pass
    return (time.perf_counter_ns() - t0) / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", type=int, default=8)
    args = p.parse_args(argv)
    import torch

    from harness import core
    from harness.program import Program, seconds_in
    from tante_tpu_torch.ops import _build
    from tante_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = "cuda:0"
    spec = core.load_spec()
    cell = core.find_cell(spec, args.workload)
    cfg, tf = core.config_of(cell), core.traffic_of(cell)
    with profiling.record() as rec:
        program, call, hist = setup(cfg, tf, args.seed, dev)
    setup_s = time.perf_counter() - T0
    prog = Program(*rec.take())
    kind = torch.cuda.get_device_name(0)
    run = core.Run(kind="rollout", config=cfg, traffic=tf, adapter=core.adapter_of(cfg),
                   peaks=core.peaks_for(kind), setup_s=setup_s)
    run.program = prog
    run.trace, run.calls = profiled(program, call, hist, tf, dev, prog)
    if run.trace is None:
        print("the profile held no device operation", file=sys.stderr)
        return 4
    readings = {name: core.reader_of(name).read(run)
                for name in PROGRAM_READERS + HARNESS_READERS}
    tr = run.trace
    out = {
        "workload": args.workload, "seed": args.seed, "device": kind, "setup_s": setup_s,
        "setup_spans": {name: seconds_in(prog.setup_spans, (name,))
                        for name in sorted({s.name for s in prog.setup_spans})},
        "builds": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                   for k, v in _build._build_info.items()},
        "readings": readings,
        "traced_idle_ms_a_unit": 1e3 * (tr.window_s - tr.busy_s) / tr.units,
        "traced_window_ms_a_unit": 1e3 * tr.window_s / tr.units,
        "idle_gaps_ms_a_unit": {k: 1e3 * v / tr.units
                                for k, v in sorted(tr.idle.items(), key=lambda kv: -kv[1])},
        "breakdown": tr.breakdown(),
        "recording": turns(call, hist, tf["trace_units"], args.turns, dev),
        "idle_span_ns": idle_span_ns(),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
