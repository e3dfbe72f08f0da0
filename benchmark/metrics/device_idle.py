"""The share of the traced window in which no operation ran on the device, in %."""


def read(run):
    if run.kind != "rollout" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
