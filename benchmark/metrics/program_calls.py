"""Model calls per rollout by the program's own ``model_calls`` counter
(once a ``TANTE.head`` call), the mean over the profiled units of a run
that recorded the program."""

from statistics import mean


def read(run):
    if run.kind != "rollout" or getattr(run, "program", None) is None or not run.program.units:
        return None
    return mean(counters["model_calls"] for _, counters in run.program.units)
