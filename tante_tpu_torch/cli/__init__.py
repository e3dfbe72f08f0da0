"""The train and eval entry points, ``python -m tante_tpu_torch.cli.train``
and ``python -m tante_tpu_torch.cli.eval`` (counterparts of
``tante_tpu/cli/``)."""
