"""Seconds of the run's set-up in the program's ``ops.load`` spans: each
kernel library's first load in the process (its hash, ``nvcc`` where the
build was missing, ``CDLL``, the binding of its entry points)."""

from harness.program import KERNEL_LOAD, seconds_in


def read(run):
    if getattr(run, "program", None) is None:
        return None
    return seconds_in(run.program.setup_spans, KERNEL_LOAD)
