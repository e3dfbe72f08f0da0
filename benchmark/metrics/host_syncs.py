"""The program's device-to-host reads per rollout (its ``host_syncs``
counter: ``_emit``'s read of r_t, ``serve.read_log``, ``_any_active``),
the mean over the profiled units of a run that recorded the program."""

from statistics import mean


def read(run):
    if run.kind != "rollout" or getattr(run, "program", None) is None or not run.program.units:
        return None
    return mean(counters["host_syncs"] for _, counters in run.program.units)
