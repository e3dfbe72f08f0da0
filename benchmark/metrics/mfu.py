"""The model's share of the card's peak over the window, in %: the
algorithm's operations of every rollout completed (counted from the
configuration's shapes) over the window's seconds, against the dense TF32
rate (the fastest at which the card takes float32 operands)."""


def read(run):
    if run.kind != "rollout" or not run.ops or not run.peaks:
        return None
    return 100.0 * sum(run.ops) / run.window_s / run.peaks["tf32_flops"]
