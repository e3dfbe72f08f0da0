"""Kernel events on the device per rollout in the traced window."""


def read(run):
    if run.kind != "rollout" or run.trace is None:
        return None
    return run.trace.kernel_count / run.trace.units
