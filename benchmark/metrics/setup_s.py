"""Seconds from the start of the process to the first timed call: imports,
the card's context, building or loading the kernels, weights, inputs and the
warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
