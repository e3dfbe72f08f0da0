"""Seconds of the run's set-up in the program's model set-up spans:
building the model (``tante.init``), loading its weights
(``serve.load_weights``) and placing it on the card (``serve.place``)."""

from harness.program import MODEL_SETUP, seconds_in


def read(run):
    if getattr(run, "program", None) is None:
        return None
    return seconds_in(run.program.setup_spans, MODEL_SETUP)
