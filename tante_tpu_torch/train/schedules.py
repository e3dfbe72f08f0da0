"""LR schedules as pure functions of the epoch (counterpart of
``tante_tpu/train/schedules.py``).

``LinearWarmupCosineAnnealingLR``: linear warmup from ``warmup_start_lr`` to
``lr`` over ``warmup_epochs``, then cosine anneal to ``eta_min``; epoch ``e``
(1-indexed) trains with ``closed_form(e - 1)``.  The trainer turns it into a
function of the optimizer step with ``as_step_schedule(steps_per_epoch)``: a
staircase that is constant within an epoch.
"""

from __future__ import annotations

import math
from typing import Callable


class LinearWarmupCosineAnnealingLR:
    """Callable epoch -> lr. Construct with the config's kwargs."""

    def __init__(self, warmup_epochs: int, max_epochs: int, lr: float = 1e-3,
                 warmup_start_lr: float = 0.0, eta_min: float = 0.0):
        self.warmup_epochs = warmup_epochs
        self.max_epochs = max_epochs
        self.base_lr = lr
        self.warmup_start_lr = warmup_start_lr
        self.eta_min = eta_min

    def __call__(self, epoch) -> float:
        """Closed-form LR at integer ``epoch`` (0-indexed)."""
        epoch = float(epoch)
        if epoch < self.warmup_epochs:
            return self.warmup_start_lr + epoch * (self.base_lr - self.warmup_start_lr) / max(
                1, self.warmup_epochs - 1)
        denom = max(1, self.max_epochs - self.warmup_epochs)
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1.0 + math.cos(math.pi * (epoch - self.warmup_epochs) / denom))

    def as_step_schedule(self, steps_per_epoch: int) -> Callable[[int], float]:
        """optimizer step -> lr (per-epoch staircase)."""
        spe = max(1, int(steps_per_epoch))
        return lambda step: self(int(step) // spe)
