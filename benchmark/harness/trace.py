"""The traced window: ``torch.profiler`` over a fixed number of units of
work, reduced to what the per-layer readers need.

The profiler records the device's activity alone (CUDA): recording every
host operator as well costs microseconds an operator, which doubled a
training step of ~7,800 launches and read as idle device time.  The host's
side comes from the benchmark's own spans (``Spans``: wall-clock
nanoseconds around each unit, its synchronise and the model's ``encode`` and
``head``), placed on the trace's clock by its ``baseTimeNanoseconds``.  The
profile is exported as a Chrome trace (to the run's ``TMPDIR``, deleted at
once) and read back.  From it:

- ``window_s``: the traced window, from before the first unit to after the
  last one's synchronise;
- ``busy_s``: the time in that window in which some device operation
  (kernel, copy, set) ran: the union of their intervals;
- ``device_s``: the sum of the device operations' durations, ``ops`` that
  sum by name, ``kernels`` the kernels' by name, ``kernel_count`` their events;
- ``idle``: the device's idle time in the window by the innermost host span
  open at each gap's midpoint ("bench.loop" outside every span).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LOOP = "bench.loop"


@dataclass
class Trace:
    units: int
    window_s: float
    busy_s: float
    device_s: float
    kernel_count: int
    kernels: Dict[str, float] = field(default_factory=dict)  # kernel name -> seconds
    ops: Dict[str, float] = field(default_factory=dict)      # device op name -> seconds
    idle: Dict[str, float] = field(default_factory=dict)     # host span -> idle seconds

    def breakdown(self, top: int = 10) -> dict:
        def largest(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": largest(self.ops), "idle_gaps": largest(self.idle)}


class Spans:
    """The benchmark's host spans, in wall-clock nanoseconds: ``span(name)``
    around what the harness calls, and, on a model instance, wrappers of its
    ``encode`` and ``head`` (instance attributes that shadow the methods,
    installed in traced runs only).  Each head call's r_t (the first
    sample's, kept on the device until its unit has synchronised) is kept
    for the unit's count of calls."""

    def __init__(self, model=None, names=("encode", "head")):
        self.spans: List[Tuple[str, int, int]] = []
        self.heads: List[object] = []
        self._installed = []
        for name in names if model is not None else ():
            fn = getattr(model, name)

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                with self.span(_name):
                    out = _fn(*args, **kwargs)
                if _name == "head":
                    self.heads.append(out[1][:1].detach() if isinstance(out, tuple) else None)
                return out

            setattr(model, name, wrapped)
            self._installed.append((model, name))

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((f"bench.{name}", start, time.time_ns()))

    def take(self) -> List[object]:
        """The head calls since the last take (their first-sample r_t, or
        None for a fixed-step model)."""
        out, self.heads = self.heads, []
        return out

    def remove(self) -> None:
        for model, name in self._installed:
            delattr(model, name)
        self._installed = []


def profile_units(unit: Callable[[int], None], n: int, spans: Spans,
                  attempts: int = 3) -> Optional[Trace]:
    """Profile ``unit(0) .. unit(n - 1)`` (each ends in a synchronise).  A
    profile that holds no device operation is taken again, up to
    ``attempts`` times; then None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        spans.spans.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.time_ns()
            for i in range(n):
                unit(i)
            torch.cuda.synchronize()
            w1 = time.time_ns()
        events, base = _chrome_events(prof)
        if base is None:  # no clock to place the host's spans on: the device's own span
            host, window = [], None
        else:
            host = [(name, (a - base) / 1e3, (b - base) / 1e3) for name, a, b in spans.spans]
            window = ((w0 - base) / 1e3, (w1 - base) / 1e3)
        trace = reduce_events(events, n, window, host)
        if trace is not None:
            return trace
    return None


def _chrome_events(prof) -> Tuple[List[dict], Optional[int]]:
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    base = doc.get("baseTimeNanoseconds")
    return doc.get("traceEvents", []), (int(base) if base is not None else None)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict], units: int,
                  window: Optional[Tuple[float, float]] = None,
                  host: List[Tuple[str, float, float]] = ()) -> Optional[Trace]:
    """A Chrome trace's events (times in microseconds) -> a ``Trace``, or
    None without a device operation in the window.  ``window`` defaults to
    the span of the device operations; ``host``: (name, start, end) spans on
    the trace's clock."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    w0, w1 = window if window is not None else (min(a for a, _, _ in dev),
                                                max(b for _, b, _ in dev))
    inside = [(max(a, w0), min(b, w1), e) for a, b, e in dev if a < w1 and b > w0]
    if not inside:
        return None
    busy = _union([(a, b) for a, b, _ in inside])
    kernels: Counter = Counter()
    ops: Counter = Counter()
    n_kernels = 0
    for a, b, e in inside:
        ops[e["name"]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernels[e["name"]] += (b - a) * 1e-6
            n_kernels += 1
    idle: Counter = Counter()
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_spans = [s for s in host if s[1] <= mid <= s[2]]
        # The innermost open span is the one that started last.
        label = max(open_spans, key=lambda s: s[1])[0] if open_spans else LOOP
        idle[label] += (b - a) * 1e-6
    return Trace(units=units, window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 device_s=sum(ops.values()), kernel_count=n_kernels,
                 kernels=dict(kernels), ops=dict(ops), idle=dict(idle))
