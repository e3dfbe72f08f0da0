"""The 95th percentile of every rollout's latency in the window, from its
call to the end of its synchronise, in milliseconds."""

from harness.core import percentile


def read(run):
    if run.kind != "rollout" or not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
