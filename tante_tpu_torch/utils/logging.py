"""Observability: metric logging and throughput reporting (counterpart of
``tante_tpu/utils/logging.py``).

``MetricLogger`` (a) always writes an append-only ``metrics.jsonl``, (b)
mirrors the reference's ``saved_loss.txt`` / ``saved_rt.txt`` files and (c)
forwards to wandb when asked and available.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class MetricLogger:
    def __init__(self, checkpoint_folder: str, project: Optional[str] = None,
                 group: Optional[str] = None, name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None, use_wandb: bool = False):
        self.checkpoint_folder = checkpoint_folder
        os.makedirs(checkpoint_folder, exist_ok=True)
        self.jsonl_path = os.path.join(checkpoint_folder, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                wandb.init(dir=checkpoint_folder, project=project, group=group, name=name,
                           config=config, resume=True)
                self._wandb = wandb
            except Exception as e:  # pragma: no cover - wandb optional
                logger.warning("wandb unavailable (%s); falling back to JSONL only", e)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"_time": time.time(), "_step": step}
        record.update({k: _to_py(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)

    def append_scalar_file(self, filename: str, value: float) -> None:
        """Reference-parity append-only scalar files (saved_loss.txt etc.)."""
        with open(os.path.join(self.checkpoint_folder, filename), "a") as f:
            f.write(str(value) + "\n")

    def finish(self) -> None:
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()


def _to_py(v: Any) -> Any:
    if hasattr(v, "item"):
        try:
            return v.item()
        except (ValueError, RuntimeError):  # more than one element
            return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_to_py(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_py(x) for k, x in v.items()}
    return v


class StepTimer:
    """steps/sec/chip throughput reporter."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = max(1, n_chips)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n_steps: int = 1) -> None:
        self._steps += n_steps

    @property
    def steps_per_sec_per_chip(self) -> float:
        dt = time.perf_counter() - self._t0
        if dt <= 0:
            return 0.0
        return self._steps / dt / self.n_chips
