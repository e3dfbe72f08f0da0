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
import torch.nn.functional as F
from torch import nn

from tante_tpu_torch.ops.activations import gelu_tanh_f32
from tante_tpu_torch.ops.attention import Dense, MultiheadAttention, dropout
from tante_tpu_torch.ops.fused_block import (
    BlockParams,
    cast_weight,
    fused_block_apply,
    fused_block_apply_tp,
    ln,
    tp_fusable,
)
from tante_tpu_torch.ops.initializers import (
    torch_bias_init,
    torch_kernel_init,
    torch_xavier_init,
)
from tante_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp


class TorchDense(nn.Module):
    """Dense layer with torch ``nn.Linear`` default init, computed in ``dtype``.

    ``cw=True`` applies the same (Cin, Cout) kernel over axis -2 of a
    channel-major ``(..., C, W)`` tensor (the parameters are identical to
    the channels-last form)."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32, gen=None,
                 cw: bool = False):
        super().__init__()
        self.dtype = dtype
        self.cw = cw
        self.Dense_0 = Dense(torch_kernel_init((in_features, features), gen),
                             torch_bias_init((features,), in_features, gen), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.Dense_0
        if self.cw:  # (..., Cin, W) -> (..., Cout, W)
            return d.kernel.to(self.dtype).t() @ x.to(self.dtype) + d.bias.to(self.dtype)[:, None]
        return d(x)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-5 as the blocks set it; the zoo
    passes flax's default 1e-6): ``scale`` and ``bias`` over the last axis,
    statistics in f32, the result in ``dtype``."""

    seed_rules = {"scale": "gain"}
    f32_params = ("scale", "bias")  # flax does not cast them to ``dtype``

    def __init__(self, dim: int, dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln(x.float(), self.scale, self.bias, self.eps).to(self.dtype)


class Mlp(nn.Module):
    """Linear -> GELU (tanh form by default) -> Linear; ``fc1`` / ``fc2``."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 approximate_gelu: bool = True, dtype=torch.float32, gen=None):
        super().__init__()
        self.approximate = "tanh" if approximate_gelu else "none"
        self.fc1 = TorchDense(in_features, hidden_features, dtype, gen)
        self.fc2 = TorchDense(hidden_features, out_features, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block: LN -> MHA -> +res, LN -> MLP -> +res, with
    the dropout sites of the JAX block (attention weights, post-attention,
    post-MLP) drawn from the caller's ``generator`` when active."""

    def __init__(self, embed_dim: int, n_head: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.1, dtype=torch.float32, gen=None):
        super().__init__()
        self.dropout = dropout
        self.ln1 = LayerNorm(embed_dim, dtype)
        self.attn = MultiheadAttention(embed_dim, n_head, dropout=dropout, dtype=dtype, gen=gen)
        self.ln2 = LayerNorm(embed_dim, dtype)
        self.mlp = Mlp(embed_dim, int(embed_dim * mlp_ratio), embed_dim, dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor, causal: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        def drop(t):
            if deterministic or self.dropout == 0.0:
                return t
            if generator is None:
                raise ValueError("dropout is active: pass the torch.Generator to draw masks from")
            return dropout(t, self.dropout, generator)

        y = self.attn(self.ln1(x), causal=causal, deterministic=deterministic,
                      generator=generator)
        x = x + drop(y)
        return x + drop(self.mlp(self.ln2(x)))


class FusedTransformerBlock(nn.Module):
    """Pre-LN transformer block with the flat 16-tensor parameter layout.

    ``fused_block_apply`` (the CUDA kernel on the card, in bf16 or f32 as
    the block's dtype says; the plain PyTorch block on the CPU) runs it when
    ``deterministic`` or ``dropout == 0``; otherwise the plain path with the
    three dropout sites of the JAX training path (attention weights,
    post-attention, post-MLP) runs, drawing from the caller's ``generator``.
    ``use_kernel=False`` (the JAX block's ``use_kernel``, set by
    ``AttnBackbone(fused=False)``) takes that plain path always, with the
    dropout sites only when dropout is active; the parameters are the same
    either way, so checkpoints are interchangeable.  Gradients of the kernel path
    recompute the plain block (``ops/fused_block.py``).

    ``tp_mesh`` (a ``parallel.Mesh`` with a 'tp' axis): once
    ``parallel.shard_params`` has left this rank's shards in the block, the
    kernel path is ``fused_block_apply_tp`` (two half kernels, an
    all-reduce after each) and the dropout path is the same split in plain
    PyTorch.  Its attention-weight masks are drawn for all heads and cut to
    the local ones, and the post-attention and post-MLP masks act after the
    all-reduce: every tp rank draws the same numbers from a generator
    seeded alike (``utils/seeding.py:rank_seed``), so the replicas agree
    and the masks are the unsplit block's."""

    def __init__(self, embed_dim: int, n_head: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.1, dtype=torch.float32, gen=None, tp_mesh=None,
                 use_kernel: bool = True):
        super().__init__()
        c = embed_dim
        hidden = int(c * mlp_ratio)
        self.embed_dim = c
        self.n_head = n_head
        self.dropout = dropout
        self.dtype = dtype
        self.tp_mesh = tp_mesh
        self.use_kernel = use_kernel
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
        stored dtype differs: this runs for every block of every call).  The
        cast is an autograd op, so gradients reach the f32 parameters, and
        each copy is marked with its parameter, under which the kernels'
        re-laid weights are cached (``cast_weight``)."""
        dt, ps = self.dtype, self._parameters
        return BlockParams(*(cast_weight(ps[f], dt) for f in BlockParams._fields))

    def tp_shardable(self, tp: int) -> bool:
        """Whether ``parallel.shard_params`` splits this block over ``tp``
        ranks: it runs under a ``tp_mesh`` and its geometry splits evenly."""
        return (self.tp_mesh is not None
                and tp_fusable(self.embed_dim, self.n_head, self.w1.shape[1], tp))

    def forward(self, x: torch.Tensor, causal: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        p = self.block_params()
        l = x.shape[-2]
        split = self.tp_mesh is not None and self.wq.shape[1] != self.embed_dim  # shards held
        active = not (deterministic or self.dropout == 0.0)  # dropout draws masks
        if not active and self.use_kernel:
            if split:
                return fused_block_apply_tp(x, p, l, self.n_head, causal, self.tp_mesh)
            return fused_block_apply(x, p, l, self.n_head, causal)
        if active and generator is None:
            raise ValueError("dropout is active: pass the torch.Generator to draw masks from")

        # block_ref's math with the three dropout sites (identities unless
        # dropout is active); split, the Megatron pair around this rank's
        # heads and hidden columns (identities when the group is None).
        g, tp, r = ((self.tp_mesh.group("tp"), self.tp_mesh.size("tp"), self.tp_mesh.index("tp"))
                    if split else (None, 1, 0))
        heads = self.n_head // tp
        d = self.embed_dim // self.n_head
        rate = self.dropout

        def drop(t):
            return dropout(t, rate, generator) if active else t

        xn = ln(copy_to_tp(x, g), copy_to_tp(p.ln1_scale, g), copy_to_tp(p.ln1_bias, g))
        q = ((xn @ p.wq) + p.bq) * (d**-0.5)
        k = (xn @ p.wk) + p.bk
        v = (xn @ p.wv) + p.bv
        q, k, v = (t.reshape(*t.shape[:-1], heads, d) for t in (q, k, v))
        logits = torch.einsum("blhd,bmhd->bhlm", q, k).float()
        if causal:
            m = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
            logits = torch.where(m, logits, torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        if active:
            # The unsplit block's mask over all heads; this rank keeps its own.
            u = torch.rand((*w.shape[:-3], self.n_head, l, l), generator=generator,
                           device=x.device)
            keep = u[..., r * heads:(r + 1) * heads, :, :] >= rate
            w = torch.where(keep, w / (1.0 - rate),
                            torch.zeros((), dtype=w.dtype, device=w.device))
        attn = torch.einsum("bhlm,bmhd->blhd", w, v).reshape(*x.shape[:-1], heads * d)
        x = x + drop(reduce_from_tp(attn @ p.wo, g) + p.bo)
        yn = ln(copy_to_tp(x, g), copy_to_tp(p.ln2_scale, g), copy_to_tp(p.ln2_bias, g))
        h1 = gelu_tanh_f32(((yn @ p.w1) + p.b1).float()).to(x.dtype)
        return x + drop(reduce_from_tp(h1 @ p.w2, g) + p.b2)


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
