"""The program's own spans and counters in the benchmark
(``harness/program.py``, the readers that read them, ``program_trace.py``):
the readers on synthetic runs, the idle gaps labelled by the innermost open
span once the program's spans join the harness's own, a tiny cell recorded
on the CPU, and on the card the program's spans on the device trace's
clock."""

from __future__ import annotations

import time
from collections import Counter

import pytest

from conftest import BENCH, WORKLOADS, tiny

from harness import core, trace
from harness.program import Program, host_spans, seconds_in
from tante_tpu_torch.utils import profiling
from tante_tpu_torch.utils.profiling import Span

PROGRAM_READERS = ("host_syncs", "program_calls", "sync_wait_ms", "launch_idle_ms",
                   "model_setup_s", "kernel_load_s")
S = 1_000_000_000  # nanoseconds a second


def _tool():
    return core.load_module(BENCH / "program_trace.py")


def _run(program=None, idle=None):
    rec = core.Run(kind="rollout", config={}, traffic={}, adapter=None, peaks=None)
    if idle is not None:
        rec.trace = trace.Trace(units=2, window_s=1.0, busy_s=0.5, device_s=0.5,
                                kernel_count=0, idle=idle)
    if program is not None:
        rec.program = program
    return rec


def _program():
    setup = [
        Span("tante.init", 0, 2 * S, -1),
        Span("serve.load_weights", 3 * S, 4 * S, -1),
        Span("serve.place", 4 * S, 5 * S, -1),
        Span("tante.head", 6 * S, 9 * S, -1),  # the warm-up's first call
        Span("tante.blocks", 6 * S, 8 * S, 3),
        Span("ops.load", 6 * S, 7 * S, 4),
        Span("ops.load", 6 * S, 6 * S + S // 2, 5),  # nested in the first: counted once
        Span("ops.load", 8 * S, 8 * S + S // 4, 3),
    ]
    unit = [Span("serve.rollout", 0, 100, -1), Span("rollout.read_rt", 10, 20, 0),
            Span("rollout.read_rt", 30, 50, 0), Span("serve.read_log", 90, 99, 0)]
    units = [(unit, Counter(host_syncs=4, model_calls=3)),
             (unit[:2], Counter(host_syncs=2, model_calls=1))]
    return Program(setup, Counter(model_calls=2), units)


def test_readers_of_the_program_record():
    run = _run(_program(), idle={"tante.blocks": 0.004, "tante.head": 0.002, "bench.head": 1.0,
                                 "bench.sync": 0.5})
    got = {name: core.reader_of(name).read(run) for name in PROGRAM_READERS}
    assert got["host_syncs"] == 3 and got["program_calls"] == 2
    assert got["sync_wait_ms"] == pytest.approx(1e-6 * (10 + 20 + 9 + 10) / 2)
    assert got["launch_idle_ms"] == pytest.approx(1e3 * 0.006 / 2)
    assert got["model_setup_s"] == pytest.approx(4.0)
    assert got["kernel_load_s"] == pytest.approx(1.25)
    # Each metric of a cell is read by its quantity's reader.
    for name in ("host_syncs.adaptive", "program_calls.rollout", "launch_idle_ms.rollout"):
        assert core.reader_of(name).__file__.endswith(name.split(".")[0] + ".py")


def test_readers_read_nothing_without_the_program():
    """A run that did not record the program (as every run of a program
    without these spans): every reader gives None and raises nothing."""
    run = _run(idle={"bench.head": 1.0})
    assert all(core.reader_of(n).read(run) is None for n in PROGRAM_READERS)
    empty = _run(Program([], Counter()))
    assert core.reader_of("host_syncs").read(empty) is None
    assert core.reader_of("launch_idle_ms").read(empty) is None  # no trace
    assert core.reader_of("model_setup_s").read(empty) == 0.0


def test_seconds_in_counts_a_nested_span_once():
    spans = _program().setup_spans
    assert seconds_in(spans, ("ops.load",)) == pytest.approx(1.25)
    assert seconds_in(spans, ("tante.head", "ops.load")) == pytest.approx(3.0)
    assert seconds_in(spans, ("nothing",)) == 0.0


def test_idle_gaps_take_the_innermost_program_span():
    """Four gaps of the device in a unit: inside ``tante.blocks`` inside the
    harness's ``bench.head`` (the program span names it), inside
    ``tante.head`` alone (twice), and after the program's spans have closed
    (the harness's label stays)."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": 10.0}
          for a in (0.0, 20.0, 50.0, 80.0)]
    bench = [("bench.rollout", 0.0, 95.0), ("bench.head", 12.0, 75.0)]
    prog = [("serve.rollout", 1.0, 94.0), ("tante.head", 13.0, 74.0),
            ("tante.blocks", 14.0, 35.0)]
    joined = trace.reduce_events(ev, 1, (0.0, 100.0), bench + prog)
    assert joined.idle == pytest.approx({"tante.blocks": 10e-6, "tante.head": 40e-6,
                                         "bench.rollout": 10e-6})
    alone = trace.reduce_events(ev, 1, (0.0, 100.0), bench)
    assert alone.idle == pytest.approx({"bench.head": 50e-6, "bench.rollout": 10e-6})
    run = _run(Program([], Counter()))
    run.trace = joined
    assert core.reader_of("launch_idle_ms").read(run) == pytest.approx(0.05)
    assert joined.busy_s == alone.busy_s and joined.kernels == alone.kernels


def test_host_spans_keep_the_wall_clock():
    spans = [Span("a", 5, 9, -1), Span("b", 6, 7, 0)]
    assert host_spans(spans) == [("a", 5, 9), ("b", 6, 7)]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tiny_cell_recorded_on_the_cpu(monkeypatch, workload):
    """``program_trace.py``'s set-up and profiled units, the profiler
    replaced by a plain loop: the set-up's spans once each, each unit one
    request, the program's calls equal to the harness's count, and one
    device-to-host read a call and one for the log (adaptive) or none."""
    tool = _tool()
    _, cfg, tf, _ = tiny(workload)
    tf["trace_units"] = 3
    with profiling.record() as rec:
        program, call, hist = tool.setup(cfg, tf, 2 ** 33 + 3, "cpu")
    prog = Program(*rec.take())
    names = [s.name for s in prog.setup_spans]
    for name in ("tante.init", "serve.load_weights", "serve.place"):
        assert names.count(name) == 1
    run = _run(prog)
    assert 0 < core.reader_of("model_setup_s").read(run) < 60
    assert core.reader_of("kernel_load_s").read(run) == 0.0  # no kernel on the CPU

    joined = []

    def profile_units(unit, n, spans, attempts=3):
        for _ in range(2):  # a profile taken again starts its units again
            spans.spans.clear()
            for i in range(n):
                unit(i)
        joined.extend(spans.spans)
        return trace.reduce_events([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0,
                                     "dur": 1.0}], n)

    monkeypatch.setattr(trace, "profile_units", profile_units)
    run.trace, run.calls = tool.profiled(program, call, hist, tf, "cpu", prog)
    assert len(prog.units) == len(run.calls) == 3
    assert "head" not in vars(program.model)  # the harness's wrappers are gone
    calls = core.reader_of("program_calls").read(run)
    assert calls == core.reader_of("model_calls").read(run) >= 1
    adaptive = tf["api"] == "rollout_adaptive"
    assert core.reader_of("host_syncs").read(run) == (calls + 1 if adaptive else 0)
    assert (core.reader_of("sync_wait_ms").read(run) > 0) == adaptive
    labels = {name for name, _, _ in joined}
    assert {"bench.rollout", "bench.sync", "bench.head", "serve.rollout", "tante.head",
            "tante.blocks", "tante.encode"} <= labels
    for spans, _ in prog.units:
        assert spans[0].name == "serve.rollout" and spans[0].parent == -1
        assert all(s.parent >= 0 for s in spans[1:])


@pytest.mark.gpu
def test_program_spans_on_the_device_clock(card):
    """A rollout of the fixed cell (its widths, batch 2) traced with the
    program recorded: on the Chrome trace's clock each ``tante.blocks``
    span opens before the first block kernel launched in it starts, and
    every device operation ends before the host's synchronise returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tool = _tool()
    _, cfg, tf, _ = tiny(WORKLOADS[0], widths=True)
    program, call, hist = tool.setup(cfg, tf, 2 ** 31 + 29, card)
    ad = core.adapter_of(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, profiling.record() as rec:
        w0 = time.time_ns()
        call(hist[0])
        torch.cuda.synchronize()
        w1 = time.time_ns()
    events, base = trace._chrome_events(prof)
    assert base is not None

    def us(ns):
        return (ns - base) / 1e3

    blocks = [s for s in rec.spans if s.name == "tante.blocks"]
    kernels = sorted(float(e["ts"]) for e in events
                     if e.get("cat") == "kernel" and ad.BLOCK_KERNELS.search(e["name"]))
    assert blocks and kernels and len(kernels) % len(blocks) == 0
    per = len(kernels) // len(blocks)
    for i, s in enumerate(blocks):
        assert us(s.start_ns) <= kernels[i * per], (i, us(s.start_ns), kernels[i * per])
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS]
    assert device and max(b for _, b in device) <= us(w1)
    assert us(w0) <= min(us(s.start_ns) for s in rec.spans)
