"""Device milliseconds per rollout of every operation that is not an f32
block kernel (the plain PyTorch work of the model call) in the traced window."""


def read(run):
    if run.kind != "rollout" or run.trace is None:
        return None
    pattern = run.adapter.BLOCK_KERNELS
    blocks = sum(s for name, s in run.trace.kernels.items() if pattern.search(name))
    return 1e3 * (run.trace.device_s - blocks) / run.trace.units
