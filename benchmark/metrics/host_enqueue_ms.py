"""Mean host milliseconds from a rollout's call to its return, before its
synchronise (traced runs, whose window has the benchmark's host spans)."""

from statistics import mean


def read(run):
    if run.kind != "rollout" or run.trace is None or not run.enqueue_s:
        return None
    return 1e3 * mean(run.enqueue_s)
