"""Device idle milliseconds per rollout in the gaps whose innermost open host
span is one of the model's (``tante.*``): the card waiting on the host's
enqueue of model work, in the profiled units of a run that recorded the
program (whose spans then label the idle gaps)."""

from harness.program import MODEL_PREFIX


def read(run):
    if run.kind != "rollout" or run.trace is None or getattr(run, "program", None) is None:
        return None
    idle = sum(s for name, s in run.trace.idle.items() if name.startswith(MODEL_PREFIX))
    return 1e3 * idle / run.trace.units
