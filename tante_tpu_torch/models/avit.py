"""AViT baseline (counterpart of ``tante_tpu/models/avit.py``): the MPP axial
space-time ViT.

Per-batch instance normalisation over (T, H, W) under stop-gradient,
re-applied at the output; a Dense lift (``space_bag``); a 3-stage hMLP conv
patch embed (4 * 2 * 2 = 16) with RMS instance norms; N space-time blocks
(temporal attention per pixel with a T5-bucketed relative position bias and
q / k LayerNorms, then row and column attention averaged, LayerScale,
stochastic depth); the hMLP head; and the reference's output quirk: the last
``min(4, T)`` frames, whatever ``out_steps`` says.

Both axial attentions of a block go through ``packed_head_attention`` (the
hand-written kernel on the card) whenever ``heads * L <= 128``: q and k leave
their LayerNorms as new tensors, v and the column views go in as strided
views of the projection, and the two outputs are added in place of the
JAX package's rearranges.  The temporal attention has a position bias and
takes the plain path.  AViT has no compute dtype: it runs in f32, and asking
for another (``Trainer(enable_amp=True)``) is a ``TypeError``, as
``model.clone(dtype=...)`` is in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.common import LayerNorm, TorchDense
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.attention import Dense, attention_weights
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.convs import PatchConv, PatchConvTranspose
from tante_tpu_torch.ops.fused_attention import (
    PACKED_ATTENTION_MAX_TOKENS,
    packed_head_attention,
)
from tante_tpu_torch.ops.initializers import torch_kernel_init
from tante_tpu_torch.utils.remat import remat


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth (``DropPath``): drop the residual branch per sample
    with probability ``rate``, scale the kept by 1 / (1 - rate); the mask is
    drawn from the caller's ``generator``."""
    if rate == 0.0 or deterministic:
        return x
    if generator is None:
        raise ValueError("drop path is active: pass the torch.Generator to draw masks from")
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return x * mask / keep


class RMSInstanceNorm(nn.Module):
    """x / (std over (H, W), ddof 1, + eps) * weight: no mean subtraction,
    and the bias parameter exists but is unused (reference quirk)."""

    seed_rules = {"weight": "gain"}

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        std = torch.std(x, dim=(-3, -2), keepdim=True, correction=1)
        return x / (std + self.eps) * self.weight


class InstanceNorm(nn.Module):
    """Instance norm over (H, W), affine per channel."""

    seed_rules = {"weight": "gain"}

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(-3, -2), keepdim=True)
        var = x.var(dim=(-3, -2), keepdim=True, correction=0)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


def t5_relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                                max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucketing (int32), as the JAX package computes it."""
    num_buckets //= 2
    n = -relative_position
    ret = (n < 0).to(torch.int32) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.clamp(min=1).float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class RelativePositionBias(nn.Module):
    seed_rules = {"embedding": "normal"}

    def __init__(self, n_heads: int, num_buckets: int = 32, max_distance: int = 128, gen=None):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.embedding = nn.Parameter(
            torch.randn((num_buckets, n_heads), generator=gen, dtype=torch.float32))

    def forward(self, qlen: int, klen: int) -> torch.Tensor:
        """(1, heads, qlen, klen)."""
        dev = self.embedding.device
        rel = torch.arange(klen, device=dev)[None, :] - torch.arange(qlen, device=dev)[:, None]
        buckets = t5_relative_position_bucket(rel, self.num_buckets, self.max_distance)
        return self.embedding[buckets.long()].permute(2, 0, 1)[None]


class ContinuousPositionBias1D(nn.Module):
    """Swin-v2-style continuous position bias (for ``bias_type='continuous'``
    in the reference; no AViT configuration uses it)."""

    def __init__(self, n_heads: int, gen=None):
        super().__init__()
        self.TorchDense_0 = TorchDense(1, 512, gen=gen)
        self.Dense_0 = Dense(torch_kernel_init((512, n_heads), gen))

    def forward(self, h: int, h2: int) -> torch.Tensor:
        dev = self.Dense_0.kernel.device
        rel = (torch.arange(-(h - 1), h, dtype=torch.float32, device=dev) / (h - 1))[:, None]
        y = 16 * torch.sigmoid(self.Dense_0(torch.relu(self.TorchDense_0(rel))))  # (2h-1, heads)
        coords = torch.arange(h, device=dev)[None, :] - torch.arange(h, device=dev)[:, None]
        return y[coords + (h - 1)].permute(2, 0, 1)[None]


def _heads_attention(q, k, v, bias=None):
    """q, k, v: (..., L, heads, D) -> (..., L, heads, D); bias (1, heads, L, L)."""
    if bias is None and q.shape[-2] * q.shape[-3] <= PACKED_ATTENTION_MAX_TOKENS:
        return packed_head_attention(q, k, v)
    return torch.einsum("...hqk,...khd->...qhd", attention_weights(q, k, attn_bias=bias), v)


def _split_qkv(y: torch.Tensor, heads: int):
    """(..., 3C) -> q, k, v (..., heads, C/heads): per head the channels run
    [q | k | v] (``rearrange(..., '(he d)')`` then a split of d in three)."""
    y = y.reshape(*y.shape[:-1], heads, -1)
    return y.chunk(3, dim=-1)


class _LayerScaleBlock(nn.Module):
    seed_rules = {"gamma": "gain", "gamma_att": "gain", "gamma_mlp": "gain"}

    def _gamma(self, c: float, init: float) -> nn.Parameter:
        return nn.Parameter(torch.full((c,), init))


class TemporalAttentionBlock(_LayerScaleBlock):
    """Attention over T per pixel, x: (B, T, H, W, C)."""

    def __init__(self, hidden_dim: int, num_heads: int, drop_path: float = 0.0,
                 layer_scale_init_value: float = 1e-6, gen=None):
        super().__init__()
        c, hd = hidden_dim, hidden_dim // num_heads
        self.num_heads, self.drop_path = num_heads, drop_path
        self.norm1 = InstanceNorm(c)
        self.input_head = TorchDense(c, 3 * c, gen=gen)
        self.qnorm = LayerNorm(hd)
        self.knorm = LayerNorm(hd)
        self.rel_pos_bias = RelativePositionBias(num_heads, gen=gen)
        self.norm2 = InstanceNorm(c)
        self.output_head = TorchDense(c, c, gen=gen)
        self.gamma = self._gamma(c, layer_scale_init_value)

    def forward(self, x, deterministic: bool = True, generator=None):
        b, t, h, w, c = x.shape
        q, k, v = _split_qkv(self.input_head(self.norm1(x)), self.num_heads)
        q, k = self.qnorm(q), self.knorm(k)
        # (B, T, H, W, he, d) -> (B, H, W, T, he, d): attention over T per pixel
        q, k, v = (z.permute(0, 2, 3, 1, 4, 5) for z in (q, k, v))
        bias = self.rel_pos_bias(t, t).to(q.dtype)
        y = _heads_attention(q, k, v, bias).permute(0, 3, 1, 2, 4, 5).reshape(b, t, h, w, c)
        y = self.output_head(self.norm2(y))
        return x + drop_path(y * self.gamma, self.drop_path, deterministic, generator)


class AxialAttentionBlock(_LayerScaleBlock):
    """Row + column attention averaged, then an MLP; x: (B', H, W, C)."""

    def __init__(self, hidden_dim: int, num_heads: int, drop_path: float = 0.0,
                 layer_scale_init_value: float = 1e-6, gen=None):
        super().__init__()
        c, hd = hidden_dim, hidden_dim // num_heads
        self.num_heads, self.drop_path = num_heads, drop_path
        self.norm1 = RMSInstanceNorm(c)
        self.input_head = TorchDense(c, 3 * c, gen=gen)
        self.qnorm = LayerNorm(hd)
        self.knorm = LayerNorm(hd)
        self.norm2 = RMSInstanceNorm(c)
        self.output_head = TorchDense(c, c, gen=gen)
        self.gamma_att = self._gamma(c, layer_scale_init_value)
        self.TorchDense_0 = TorchDense(c, 4 * c, gen=gen)
        self.TorchDense_1 = TorchDense(4 * c, c, gen=gen)
        self.mlp_norm = RMSInstanceNorm(c)
        self.gamma_mlp = self._gamma(c, layer_scale_init_value)

    def forward(self, x, deterministic: bool = True, generator=None):
        b, h, w, c = x.shape
        q, k, v = _split_qkv(self.input_head(self.norm1(x)), self.num_heads)
        q, k = self.qnorm(q), self.knorm(k)  # (B', H, W, he, d)
        xx = _heads_attention(q, k, v)  # row (W-axis) attention
        xy = _heads_attention(*(z.transpose(1, 2) for z in (q, k, v)))  # column (H-axis)
        y = (xx + xy.transpose(1, 2)).reshape(b, h, w, c) / 2
        y = self.output_head(self.norm2(y))
        x = x + drop_path(y * self.gamma_att, self.drop_path, deterministic, generator)
        z = self.mlp_norm(self.TorchDense_1(gelu(self.TorchDense_0(x))))
        return x + drop_path(z * self.gamma_mlp, self.drop_path, deterministic, generator)


class HMLPStem(nn.Module):
    """3-stage conv patch embed 4 * 2 * 2 with RMS instance norms."""

    def __init__(self, c_in: int, embed_dim: int, gen=None):
        super().__init__()
        e4 = embed_dim // 4
        self.Conv_0 = PatchConv(c_in, e4, (4, 4), use_bias=False, gen=gen)
        self.RMSInstanceNorm_0 = RMSInstanceNorm(e4)
        self.Conv_1 = PatchConv(e4, e4, (2, 2), use_bias=False, gen=gen)
        self.RMSInstanceNorm_1 = RMSInstanceNorm(e4)
        self.Conv_2 = PatchConv(e4, embed_dim, (2, 2), use_bias=False, gen=gen)
        self.RMSInstanceNorm_2 = RMSInstanceNorm(embed_dim)

    def forward(self, x):
        x = gelu(self.RMSInstanceNorm_0(self.Conv_0(x)))
        x = gelu(self.RMSInstanceNorm_1(self.Conv_1(x)))
        return self.RMSInstanceNorm_2(self.Conv_2(x))


class HMLPOutput(nn.Module):
    def __init__(self, out_chans: int, embed_dim: int, gen=None):
        super().__init__()
        e4 = embed_dim // 4
        self.ConvTranspose_0 = PatchConvTranspose(embed_dim, e4, (2, 2), use_bias=False, gen=gen)
        self.RMSInstanceNorm_0 = RMSInstanceNorm(e4)
        self.ConvTranspose_1 = PatchConvTranspose(e4, e4, (2, 2), use_bias=False, gen=gen)
        self.RMSInstanceNorm_1 = RMSInstanceNorm(e4)
        self.ConvTranspose_2 = PatchConvTranspose(e4, out_chans, (4, 4), gen=gen)

    def forward(self, x):
        x = gelu(self.RMSInstanceNorm_0(self.ConvTranspose_0(x)))
        x = gelu(self.RMSInstanceNorm_1(self.ConvTranspose_1(x)))
        return self.ConvTranspose_2(x)


class AViT(nn.Module):
    def __init__(self, in_T: int, dset_metadata: Optional[TanteMetadata] = None,
                 out_steps: int = 4, patch_size: Tuple[int, int] = (16, 16),
                 embed_dim: int = 768, num_heads: int = 12, processor_blocks: int = 8,
                 drop_path: float = 0.2, gradient_checkpointing: bool = False,
                 device=None, seed: int = 0):
        super().__init__()
        # patch_size is not read: the hMLP stem is 4 * 2 * 2 whatever it says,
        # in the JAX package and in the reference alike.
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        n_fields = dset_metadata.n_fields if dset_metadata else 4
        self.in_T, self.out_steps, self.embed_dim = in_T, out_steps, embed_dim
        self.processor_blocks = processor_blocks
        self.gradient_checkpointing = gradient_checkpointing
        self.space_bag = TorchDense(n_fields, embed_dim // 4, gen=gen)
        self.embed = HMLPStem(embed_dim // 4, embed_dim, gen=gen)
        for i, rate in enumerate(np.linspace(0, drop_path, processor_blocks)):
            self.add_module(f"temporal_{i}", TemporalAttentionBlock(
                embed_dim, num_heads, drop_path=float(rate), gen=gen))
            self.add_module(f"spatial_{i}", AxialAttentionBlock(
                embed_dim, num_heads, drop_path=float(rate), gen=gen))
        self.debed = HMLPOutput(n_fields, embed_dim, gen=gen)
        self.to(dev)

    @property
    def output_length(self) -> int:
        # The reference emits the last min(4, T) frames regardless of out_steps.
        return min(4, self.in_T)

    def _block(self, block, z, deterministic, generator):
        if not (self.gradient_checkpointing and torch.is_grad_enabled()):
            return block(z, deterministic, generator)
        # The recompute in backward draws the forward's drop-path masks again
        # (as nn.remat replays its key).
        return remat(lambda z: block(z, deterministic, generator), z,
                     rng=None if deterministic else generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, min(4, T), H, W, C)."""
        b, t, h, w, c = x.shape
        with torch.no_grad():  # the reference's stop-gradient statistics
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            std = x.std(dim=(1, 2, 3), keepdim=True, correction=1) + 1e-7
        z = self.space_bag((x - mean) / std)
        z = self.embed(z.reshape(b * t, h, w, -1))
        hp, wp = z.shape[1], z.shape[2]
        z = z.reshape(b, t, hp, wp, self.embed_dim)
        for i in range(self.processor_blocks):
            z = self._block(getattr(self, f"temporal_{i}"), z, deterministic, generator)
            zz = z.reshape(b * t, hp, wp, self.embed_dim)
            zz = self._block(getattr(self, f"spatial_{i}"), zz, deterministic, generator)
            z = zz.reshape(b, t, hp, wp, self.embed_dim)
        z = self.debed(z.reshape(b * t, hp, wp, self.embed_dim)).reshape(b, t, h, w, c)
        return (z * std + mean)[:, -self.output_length:]
