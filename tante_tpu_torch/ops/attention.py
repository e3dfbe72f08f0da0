"""Multi-head attention (counterpart of ``tante_tpu/ops/attention.py``),
``torch.nn.MultiheadAttention`` semantics with flax parameter names.

Separate q / k / v projections (xavier-uniform kernels, zero biases) and a
torch-default ``out_proj`` (zero bias), computed in the module's ``dtype``.
Three branches, gated as in the JAX package:

- packed: self-attention with no bias and no active dropout, and
  ``heads * L <= PACKED_ATTENTION_MAX_TOKENS`` (``TANTE_PACKED_MAX``'s default,
  128, fixed by the kernel's envelope):
  ``packed_head_attention`` (``ops/fused_attention.py``).  On CUDA tensors this
  ALWAYS launches the hand-written kernel, where the JAX package takes its XLA
  form unless ``TANTE_PACKED_IMPL=pallas`` (a TPU speed choice; same function,
  and the kernel keeps f32 scores where the XLA form rounds them to the
  compute dtype);
- unpacked self-attention: per-head scores in the compute dtype, an f32
  softmax (``TANTE_UNPACKED_SOFTMAX``'s default), weights back in the compute
  dtype;
- general: an additive ``attn_bias``, cross-attention, and dropout on the
  attention weights drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tante_tpu_torch.ops.fused_attention import (
    PACKED_ATTENTION_MAX_TOKENS,
    packed_head_attention,
)
from tante_tpu_torch.ops.initializers import torch_kernel_init, torch_xavier_init

__all__ = ["Dense", "MultiheadAttention", "attention_weights", "dropout",
           "packed_head_attention"]


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keep with probability
    1 - rate, scale the kept by 1 / (1 - rate).  The mask is drawn from
    ``generator``, which lives on ``x``'s device and belongs to the caller."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``(in, out)``, optional bias ``(out,)``,
    input and parameters cast to ``dtype`` at use."""

    def __init__(self, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(kernel)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def attention_weights(q: torch.Tensor, k: torch.Tensor, causal: bool = False,
                      attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-head attention weights of (..., L, heads, D) projections: scores in
    the compute dtype (plus ``attn_bias``; causal entries filled with the
    dtype's min), an f32 softmax, the weights back in the compute dtype:
    (..., heads, Lq, Lk)."""
    logits = torch.einsum("...qhd,...khd->...hqk", q * q.shape[-1] ** -0.5, k)
    if attn_bias is not None:
        logits = logits + attn_bias
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((lq, lk), dtype=torch.bool, device=logits.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    return torch.softmax(logits.float(), dim=-1).to(logits.dtype)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = True, dtype=torch.float32, gen=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        c = embed_dim
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        self.dtype = dtype

        def bias():
            return torch.zeros(c) if use_bias else None

        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Dense(torch_xavier_init((c, c), gen), bias(), dtype))
        self.out_proj = Dense(torch_kernel_init((c, c), gen), bias(), dtype)

    def forward(self, q_in: torch.Tensor, k_in: Optional[torch.Tensor] = None,
                v_in: Optional[torch.Tensor] = None, causal: bool = False,
                attn_bias: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L, C) -> (B, L, C); cross-attention when k_in / v_in differ."""
        k_in = q_in if k_in is None else k_in
        v_in = k_in if v_in is None else v_in
        h, d = self.num_heads, self.embed_dim // self.num_heads

        def split(t):
            return t.reshape(*t.shape[:-1], h, d)

        q, k, v = split(self.q_proj(q_in)), split(self.k_proj(k_in)), split(self.v_proj(v_in))
        drop = self.dropout > 0.0 and not deterministic
        simple = (k_in is q_in and v_in is k_in and attn_bias is None and not drop
                  and q.dim() == 4)
        if simple and h * q.shape[-3] <= PACKED_ATTENTION_MAX_TOKENS:
            out = packed_head_attention(q, k, v, causal)
        else:
            weights = attention_weights(q, k, causal, attn_bias)
            if drop:
                if generator is None:
                    raise ValueError("dropout is active: pass the torch.Generator to draw "
                                     "masks from")
                weights = dropout(weights, self.dropout, generator)
            out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return self.out_proj(out.reshape(*out.shape[:-2], self.embed_dim))
