"""The f32 block kernels' share of their roofline in the traced window, in %:
the least time their work could take on the card (each launch the larger of
its operations at the dense TF32 rate and its bytes at the HBM bandwidth,
``models/<family>_count.py``) over their measured time."""


def read(run):
    if run.kind != "rollout" or run.trace is None or not run.peaks:
        return None
    pattern = run.adapter.BLOCK_KERNELS
    seconds = sum(s for name, s in run.trace.kernels.items() if pattern.search(name))
    if seconds <= 0:
        return None
    return 100.0 * run.trace_block_bound_s / seconds
