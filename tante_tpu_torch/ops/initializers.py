"""Seeded torch-default initializers (counterpart of
``tante_tpu/ops/initializers.py``).

Same distributions as the JAX package, which mirrors PyTorch's defaults:
``nn.Linear``/``nn.Conv2d`` kernels and biases ~ U(-1/sqrt(fan_in),
1/sqrt(fan_in)) with fan_in counting kernel taps, attention projections
xavier-uniform.  Kernels keep flax's layouts: Dense ``(in, out)``, conv HWIO
``(ph, pw, ci, co)``, so fan_in is the product of all dims but the last.
Every draw takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def torch_kernel_init(shape, gen: torch.Generator) -> torch.Tensor:
    fan_in = math.prod(shape[:-1])
    return _uniform(shape, 1.0 / math.sqrt(max(fan_in, 1)), gen)


def torch_bias_init(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    return _uniform(shape, 1.0 / math.sqrt(max(fan_in, 1)), gen)


def torch_xavier_init(shape, gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = math.prod(shape[:-1]), shape[-1]
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), gen)
