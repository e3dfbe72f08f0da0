"""Shared model building blocks (counterpart of ``tante_tpu/models/common.py``).

Module and parameter names are the flax ones, so a flax param path
``a/b/c`` is the torch state-dict key ``a.b.c`` (``convert.py``).  Dense
kernels keep flax's ``(in, out)`` layout; parameters are stored in f32 and
cast to the module's compute dtype at use, as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tante_tpu_torch.ops.fused_block import BlockParams, fused_block_apply
from tante_tpu_torch.ops.initializers import (
    torch_bias_init,
    torch_kernel_init,
    torch_xavier_init,
)


class _Dense(nn.Module):
    """flax ``nn.Dense`` parameters: kernel (in, out), bias (out,)."""

    def __init__(self, in_features: int, features: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(torch_kernel_init((in_features, features), gen))
        self.bias = nn.Parameter(torch_bias_init((features,), in_features, gen))


class TorchDense(nn.Module):
    """Dense layer with torch ``nn.Linear`` default init, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32, gen=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = _Dense(in_features, features, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.Dense_0
        return x.to(self.dtype) @ d.kernel.to(self.dtype) + d.bias.to(self.dtype)


class FusedTransformerBlock(nn.Module):
    """Pre-LN transformer block with the flat 16-tensor parameter layout,
    run by ``fused_block_apply`` (the CUDA kernel on the card, the plain
    PyTorch block on the CPU).  Inference only: the dropout sites of the
    JAX training path are not ported."""

    def __init__(self, embed_dim: int, n_head: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, gen=None):
        super().__init__()
        c = embed_dim
        hidden = int(c * mlp_ratio)
        self.n_head = n_head
        self.dtype = dtype
        P = nn.Parameter
        self.ln1_scale = P(torch.ones(c))
        self.ln1_bias = P(torch.zeros(c))
        self.wq = P(torch_xavier_init((c, c), gen))
        self.bq = P(torch.zeros(c))
        self.wk = P(torch_xavier_init((c, c), gen))
        self.bk = P(torch.zeros(c))
        self.wv = P(torch_xavier_init((c, c), gen))
        self.bv = P(torch.zeros(c))
        self.wo = P(torch_kernel_init((c, c), gen))
        self.bo = P(torch.zeros(c))
        self.ln2_scale = P(torch.ones(c))
        self.ln2_bias = P(torch.zeros(c))
        self.w1 = P(torch_kernel_init((c, hidden), gen))
        self.b1 = P(torch_bias_init((hidden,), c, gen))
        self.w2 = P(torch_kernel_init((hidden, c), gen))
        self.b2 = P(torch_bias_init((c,), hidden, gen))

    def block_params(self) -> BlockParams:
        """The flat weight tuple in the compute dtype (cast only where the
        stored dtype differs: this runs for every block of every call)."""
        dt, ps = self.dtype, self._parameters
        return BlockParams(*(
            t if t.dtype == dt else t.to(dt) for t in (ps[f] for f in BlockParams._fields)
        ))

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        return fused_block_apply(x, self.block_params(), x.shape[-2], self.n_head, causal)


class Film(nn.Module):
    """FiLM conditioning ``x + (x * scale(t) + shift(t))``: token tensors
    (B, L, C) with condition (B,), grid tensors (B, T, H, W, C) with (T,)."""

    def __init__(self, h_dim: int, in_dim: int = 1, dtype=torch.float32, gen=None):
        super().__init__()
        self.dtype = dtype
        # scale MLP = TorchDense_0/1, shift MLP = TorchDense_2/3 (flax auto-names)
        self.TorchDense_0 = TorchDense(in_dim, h_dim // 2, dtype, gen)
        self.TorchDense_1 = TorchDense(h_dim // 2, h_dim, dtype, gen)
        self.TorchDense_2 = TorchDense(in_dim, h_dim // 2, dtype, gen)
        self.TorchDense_3 = TorchDense(h_dim // 2, h_dim, dtype, gen)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        cond = t[..., None].to(x.dtype)
        scale = self.TorchDense_1(torch.relu(self.TorchDense_0(cond)))
        shift = self.TorchDense_3(torch.relu(self.TorchDense_2(cond)))
        if x.ndim == 3:  # (B, L, C), cond (B, C)
            scale, shift = scale[:, None, :], shift[:, None, :]
        elif x.ndim == 5:  # (B, T, H, W, C), cond (T, C)
            scale, shift = scale[None, :, None, None, :], shift[None, :, None, None, :]
        return x + (x * scale + shift)


# --------------------------------------------------------------------------
# Position embeddings and the relative time series (numpy, as in JAX)
# --------------------------------------------------------------------------


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    return get_1d_sincos_pos_embed_from_grid(embed_dim, np.arange(length))[None]


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: Sequence[int], *, flatten: bool = False
) -> np.ndarray:
    """(1, H, W, D) (or (1, H*W, D)); keeps the reference's reshape-not-
    transpose quirk for non-square grids (see the JAX docstring)."""
    h, w = grid_size
    mesh_w, mesh_h = np.meshgrid(
        np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64), indexing="ij"
    )
    grid = np.stack([mesh_h, mesh_w], axis=0).reshape(2, 1, h, w)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if flatten:
        return pos[None]
    return pos.reshape(h, w, embed_dim)[None]


def t_series(in_t: int, frame_interval: float) -> np.ndarray:
    """Relative time sequence for the FiLM time encoder, with the
    reference's quirk: T=4 gives [-2d, -d, 0, 0]."""
    seq = [0.0] + [-i * frame_interval for i in range(in_t - 1)]
    seq.reverse()
    return np.asarray(seq, dtype=np.float32)
