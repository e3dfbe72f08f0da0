"""GELU forms (counterpart of ``tante_tpu/ops/activations.py``).

``gelu``: exact erf-GELU under f32, tanh-GELU under bf16 (the deviation is
below bf16's quantization step; PARITY.md "Deliberate numerical
deviations").  ``gelu_tanh_f32`` is the block MLP's tanh form, written out
as the JAX package writes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(z: torch.Tensor) -> torch.Tensor:
    """erf-GELU (f32) / tanh-GELU (bf16), gated on the tensor dtype."""
    return F.gelu(z, approximate="tanh" if z.dtype == torch.bfloat16 else "none")


def gelu_tanh_f32(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h**3)))
