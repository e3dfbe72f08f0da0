"""Frames of the rollouts completed in the window, over the window's seconds."""


def read(run):
    if run.kind != "rollout" or run.units == 0:
        return None
    return run.units * run.frames_per_unit / run.window_s
