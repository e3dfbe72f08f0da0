"""Seeding, logging and checkpointing (counterpart of ``tante_tpu/utils``)."""
