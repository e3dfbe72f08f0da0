"""Host milliseconds per rollout spent in the program's device-to-host reads
(its ``rollout.read_rt`` and ``serve.read_log`` spans: the wait for the card
and the copy), the mean over the profiled units of a run that recorded the
program."""

from statistics import mean

from harness.program import SYNC_WAIT, seconds_in


def read(run):
    if run.kind != "rollout" or getattr(run, "program", None) is None or not run.program.units:
        return None
    return 1e3 * mean(seconds_in(spans, SYNC_WAIT) for spans, _ in run.program.units)
