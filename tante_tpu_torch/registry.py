"""``_target_`` resolution (counterpart of ``tante_tpu/registry.py``).

The shipped configs name their classes as the reference does
(``data.TanteDataModule``, ``models.TANTE``, ``trainer.MSE``,
``torch.optim.AdamW``, ``optim.schedulers.LinearWarmupCosineAnnealingLR``).
Those names resolve to the port's classes through this table, which is read
before any dotted import: ``torch.optim.AdamW`` is the port's AdamW spec
(``train/optimizers.py``), which the trainers bind to their parameters, never
``torch.optim.AdamW`` itself.  Any other dotted name (e.g.
``tante_tpu_torch.data.WaveDataModule``) is imported.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

MODELS = ("TANTE", "FNO", "TFNO", "UNO", "AViT", "CViT", "AFNO", "DPOT", "UNetConvNext",
          "AttentionUNet")
METRICS = ("MSE", "NMSE", "L2RE", "NNMSE", "RMSE", "NRMSE", "VMSE", "VRMSE")
TRAINERS = ("Trainer", "R_Trainer", "Evaler", "R_Evaler")

_table: Dict[str, Callable[..., Any]] = {}


def _names() -> Dict[str, Callable[..., Any]]:
    """The reference names, built on first use (the modules behind them
    import the whole training stack)."""
    if not _table:
        from tante_tpu_torch import models, train
        from tante_tpu_torch.data.datamodule import TanteDataModule

        _table["data.TanteDataModule"] = TanteDataModule
        for name in MODELS:
            _table[f"models.{name}"] = getattr(models, name)
        for name in METRICS + TRAINERS:
            _table[f"trainer.{name}"] = getattr(train, name)
        _table["torch.optim.AdamW"] = train.AdamW
        _table["optim.schedulers.LinearWarmupCosineAnnealingLR"] = (
            train.LinearWarmupCosineAnnealingLR)
    return _table


def resolve(target: str) -> Callable[..., Any]:
    """A target name -> its constructor: the table first, then a dotted
    import of ``module.attr``; KeyError when neither resolves it."""
    table = _names()
    if target in table:
        return table[target]
    if "." in target:
        module_name, attr = target.rsplit(".", 1)
        try:
            return getattr(importlib.import_module(module_name), attr)
        except (ImportError, AttributeError) as e:
            raise KeyError(f"Cannot resolve target '{target}': {e}") from e
    raise KeyError(f"Unknown target '{target}'")
