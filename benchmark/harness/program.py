"""The program's own spans and counters (``tante_tpu_torch.utils.profiling``)
in a traced run, as ``program_trace.py`` records them: from the start of
the set-up through the warm-up, and during the profiled units, cut per unit
with ``Record.take()``; never in a timed window.

The program's spans are on ``time.time_ns()``, the clock of the harness's
own ``trace.Spans``, so they join those spans where ``trace.reduce_events``
labels the device's idle gaps: a gap inside ``tante.blocks`` inside the
harness's ``bench.head`` reads ``tante.blocks`` (the innermost open span),
and a gap where no program span is open keeps its ``bench.*`` label.

The readers ``metrics/{host_syncs,program_calls,sync_wait_ms,
launch_idle_ms,model_setup_s,kernel_load_s}.py`` read ``run.program``, a
``Program``; without one (a run that did not record the program, such as
every run of ``run.py`` so far) they read nothing.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple

# What the program's spans and counters are named (tante_tpu_torch's own
# names: the readers below depend on them).
MODEL_SETUP = ("tante.init", "serve.load_weights", "serve.place")
KERNEL_LOAD = ("ops.load",)
SYNC_WAIT = ("rollout.read_rt", "serve.read_log")
MODEL_PREFIX = "tante."


@dataclass
class Program:
    """What a run recorded of the program: the set-up's spans and counters,
    and each profiled unit's (``Span(name, start_ns, end_ns, parent)`` lists
    and ``Counter`` s, as ``Record.take()`` hands them over)."""

    setup_spans: list
    setup_counters: Counter
    units: List[Tuple[list, Counter]] = field(default_factory=list)


def host_spans(spans: Iterable) -> List[Tuple[str, int, int]]:
    """A unit's program spans as the harness's own host spans are kept:
    (name, start_ns, end_ns)."""
    return [(s.name, s.start_ns, s.end_ns) for s in spans]


def seconds_in(spans: Sequence, names: Sequence[str]) -> float:
    """Seconds spent in the spans named; a span inside another of them
    counts once, in its outermost one."""
    names = set(names)

    def nested(s) -> bool:
        while s.parent >= 0:
            s = spans[s.parent]
            if s.name in names:
                return True
        return False

    return 1e-9 * sum(s.end_ns - s.start_ns for s in spans if s.name in names and not nested(s))
