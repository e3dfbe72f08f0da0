"""Model calls (``head``) per rollout in the window, counted by the traced
run's wrapper on the model instance."""

from statistics import mean


def read(run):
    if run.kind != "rollout" or not run.calls:
        return None
    return mean(run.calls)
