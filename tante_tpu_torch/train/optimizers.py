"""Optimizer factory with the config's surface (counterpart of
``tante_tpu/train/optimizers.py``).

``AdamW`` is a lightweight spec; ``make`` binds it to a module's parameters
and returns the ``torch.optim.AdamW`` together with the gradient clip the
trainer applies before each step: global-norm clip for ``Trainer``, value
clip for the adaptive trainer.  optax's ``adamw`` and ``torch.optim.AdamW``
compute the same update (decoupled weight decay scaled by the learning
rate, bias-corrected moments, eps outside the square root).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch


@dataclass
class AdamW:
    lr: float = 5e-5
    weight_decay: float = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def make(self, params: Iterable[torch.nn.Parameter], learning_rate: Optional[float] = None,
             grad_clip: Optional[str] = "norm", clip_value: float = 1.0, mesh=None):
        """-> (optimizer, clip): ``clip(params)`` clips the gradients in
        place and returns the global gradient norm before clipping (over the
        whole model under a tensor-parallel ``mesh``)."""
        params = list(params)
        opt = torch.optim.AdamW(
            params, lr=self.lr if learning_rate is None else learning_rate,
            betas=(self.b1, self.b2), eps=self.eps, weight_decay=self.weight_decay,
        )
        return opt, make_clip(grad_clip, clip_value, mesh)


def global_norm(params: Iterable[torch.nn.Parameter], mesh=None) -> torch.Tensor:
    """The L2 norm of all gradients.  Under a mesh with 'tp' > 1 the squares
    of the split parameters' gradients (``tp_dim``, ``parallel/sharding.py``)
    are summed over 'tp' and the replicated ones counted once, so the norm is
    the unsplit model's (take it after the Trainer's dp all-reduce)."""
    params = [p for p in params if p.grad is not None]
    if mesh is None or mesh.size("tp") == 1:
        grads = [p.grad for p in params]
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    from tante_tpu_torch.parallel.collectives import all_reduce

    def sq(ps):
        return sum((p.grad.float().square().sum() for p in ps),
                   torch.zeros((), device=params[0].grad.device))

    split = sq(p for p in params if hasattr(p, "tp_dim"))
    whole = sq(p for p in params if not hasattr(p, "tp_dim"))
    return torch.sqrt(all_reduce(split, mesh.group("tp")) + whole)


def make_clip(grad_clip: Optional[str], clip_value: float = 1.0, mesh=None) -> Callable:
    """"norm": scale all gradients by ``clip_value / max(norm, clip_value)``
    (``optax.clip_by_global_norm``); "value": clamp each entry to
    +-clip_value (``optax.clip``); None: leave them."""
    if grad_clip not in ("norm", "value", None):
        raise ValueError(f"Unknown grad_clip '{grad_clip}'")

    @torch.no_grad()
    def clip(params):
        params = [p for p in params if p.grad is not None]
        norm = global_norm(params, mesh)
        if grad_clip == "norm":
            scale = clip_value / torch.clamp(norm, min=clip_value)
            for p in params:
                p.grad.mul_(scale)
        elif grad_clip == "value":
            for p in params:
                p.grad.clamp_(-clip_value, clip_value)
        return norm

    return clip
