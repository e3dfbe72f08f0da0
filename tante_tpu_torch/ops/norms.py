"""flax's normalisation layers where PyTorch's differ (the zoo's
``nn.BatchNorm`` and ``nn.GroupNorm``), channels-last.

``BatchNorm`` is flax ``nn.BatchNorm``, not ``torch.nn.BatchNorm2d``:
momentum 0.99 on the running statistics (torch: 0.1 the other way round),
epsilon 1e-5, and the running variance takes the BIASED batch variance
(torch: the unbiased one).  Batch statistics are one-pass, mean and E[x^2]
in f32 or wider (flax's fast variance, ``force_float32_reductions``).  The
parameters are flax's ``scale`` and ``bias``; the running statistics are
buffers under flax's ``batch_stats`` names ``mean`` and ``var``, so a
state_dict carries them and ``convert.load_jax_variables`` fills them from a
flax ``batch_stats`` tree.

Which statistics a call uses is the caller's ``train`` flag (the models pass
``not deterministic``, as flax's ``use_running_average=not train``), not
``Module.training``: with ``train`` the batch's, and the running ones move
once per call; without, the running ones.  ``group`` (a process group, set by
the Trainer under a mesh) makes the batch statistics the global batch's: the
mean and E[x^2] are summed over the group inside autograd
(``parallel/collectives.py:psum``), so the backward through them is global
too.  Every rank of the group must hold as many elements, as the mesh's even
splits give.
"""

from __future__ import annotations

import torch
from torch import nn

from tante_tpu_torch.parallel.collectives import psum


class BatchNorm(nn.Module):
    seed_rules = {"scale": "gain"}

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.group = None
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def batch_stats(self, x: torch.Tensor):
        """(mean, biased variance) over every axis but the last, in f32 or
        wider; the global batch's over ``group``."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.ndim - 1))
        m = torch.stack([xf.mean(axes), (xf * xf).mean(axes)])
        if self.group is not None:
            m = psum(m, self.group) / torch.distributed.get_world_size(self.group)
        mean, mean2 = m
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x.to(self.dtype) - mean.to(self.dtype)) * mul.to(self.dtype)
        return y + self.bias.to(self.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` on (B, ..., C): statistics per
    sample and channel group over every other axis, one-pass in f32,
    epsilon 1e-6 (flax's default; torch's is 1e-5); ``scale`` / ``bias`` per
    channel."""

    seed_rules = {"scale": "gain"}

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels do not split into {num_groups} groups")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xg = x.float().reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = xg.mean((1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean((1, 3), keepdim=True) - mean * mean, min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.scale + self.bias).to(self.dtype)
