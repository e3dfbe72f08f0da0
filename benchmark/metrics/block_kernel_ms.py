"""Device milliseconds per rollout of the f32 block kernels (by symbol,
``BLOCK_KERNELS`` of the configuration's adapter) in the traced window."""


def block_seconds(run):
    pattern = run.adapter.BLOCK_KERNELS
    return sum(s for name, s in run.trace.kernels.items() if pattern.search(name))


def read(run):
    if run.kind != "rollout" or run.trace is None:
        return None
    seconds = block_seconds(run)
    return 1e3 * seconds / run.trace.units if seconds > 0 else None
