"""CViT baseline (counterpart of ``tante_tpu/models/cvit.py``): the Continuous
Vision Transformer.

A space-time conv patch embed, factorised t / s sincos position
embeddings, ``TimeAggregation`` (one learned latent cross-attending over
time per spatial token), ``depth`` self-attention blocks; the decoder embeds
query coordinates in [0, 1]^2 (a grid-RBF weighted average of a learned
latent table with eps = 1e5, Fourier features, or an MLP), runs
``dec_depth`` cross-attention blocks over the encoder tokens and a residual
MLP head that emits ``out_steps * C`` values per query.  Full-grid output
``(B, T', H, W, C)`` without coordinates, point output ``(B, T', N, C)``
with them.

Dtypes follow the JAX package: modules compute in ``dtype``; the parameters
that the JAX package adds or multiplies in f32 (position embeddings, latents,
the RBF grid, the Fourier kernel) stay f32 also when ``Predictor`` casts a
model for serving (``f32_params``), so the grid-RBF logits are f32 under a
bf16 compute dtype (in bf16 they would collapse), and a bf16 activation
plus an f32 embedding is f32 as under JAX's promotion.  The reference's
reuse of ``layer_norm2`` after the cross-attention is kept.

With the configuration's width (256 tokens, 8 heads) every self-attention
takes the unpacked branch of ``MultiheadAttention`` (8 * 256 > 128): this
model launches no hand-written kernel at that size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.common import (
    LayerNorm,
    TorchDense,
    get_1d_sincos_pos_embed,
    get_2d_sincos_pos_embed,
)
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.attention import Dense, MultiheadAttention
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.convs import PatchConv
from tante_tpu_torch.ops.initializers import torch_xavier_init


class MlpBlock(nn.Module):
    def __init__(self, in_dim: int, dim: int, out_dim: int, dtype=torch.float32, gen=None):
        super().__init__()
        self.Dense_0 = Dense(torch_xavier_init((in_dim, dim), gen), torch.zeros(dim), dtype)
        self.Dense_1 = Dense(torch_xavier_init((dim, out_dim), gen), torch.zeros(out_dim), dtype)

    def forward(self, x):
        return self.Dense_1(gelu(self.Dense_0(x)))


class SelfAttnBlock(nn.Module):
    def __init__(self, num_heads: int, emb_dim: int, mlp_ratio: int = 1, dtype=torch.float32,
                 gen=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(emb_dim, dtype)
        self.MultiheadAttention_0 = MultiheadAttention(emb_dim, num_heads, dtype=dtype, gen=gen)
        self.LayerNorm_1 = LayerNorm(emb_dim, dtype)
        self.MlpBlock_0 = MlpBlock(emb_dim, emb_dim * mlp_ratio, emb_dim, dtype, gen)

    def forward(self, x, deterministic: bool = True):
        x = x + self.MultiheadAttention_0(self.LayerNorm_0(x), deterministic=deterministic)
        return x + self.MlpBlock_0(self.LayerNorm_1(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, num_heads: int, emb_dim: int, mlp_ratio: int = 1, dtype=torch.float32,
                 gen=None):
        super().__init__()
        self.layer_norm1 = LayerNorm(emb_dim, dtype)
        self.layer_norm2 = LayerNorm(emb_dim, dtype)
        self.MultiheadAttention_0 = MultiheadAttention(emb_dim, num_heads, dtype=dtype, gen=gen)
        self.MlpBlock_0 = MlpBlock(emb_dim, emb_dim * mlp_ratio, emb_dim, dtype, gen)

    def forward(self, q_inputs, kv_inputs, deterministic: bool = True):
        kv = self.layer_norm2(kv_inputs)
        x = self.MultiheadAttention_0(self.layer_norm1(q_inputs), kv, kv,
                                      deterministic=deterministic) + q_inputs
        # The reference reuses layer_norm2 here: kept.
        return x + self.MlpBlock_0(self.layer_norm2(x))


class TimeAggregation(nn.Module):
    """Perceiver-style: learned latents cross-attend over time per token."""

    f32_params = ("latents",)
    seed_rules = {"latents": "normal"}

    def __init__(self, emb_dim: int, depth: int, num_heads: int = 8, num_latents: int = 64,
                 mlp_ratio: int = 1, dtype=torch.float32, gen=None):
        super().__init__()
        self.depth = depth
        self.latents = nn.Parameter(torch.randn((num_latents, emb_dim), generator=gen))
        for i in range(depth):
            self.add_module(f"CrossAttnBlock_{i}",
                            CrossAttnBlock(num_heads, emb_dim, mlp_ratio, dtype, gen))

    def forward(self, x, deterministic: bool = True):
        """(B, T, S, D) -> (B, num_latents, S, D)."""
        b, t, s, d = x.shape
        lat = self.latents.expand(b * s, *self.latents.shape)
        tokens = x.transpose(1, 2).reshape(b * s, t, d)
        for i in range(self.depth):
            lat = getattr(self, f"CrossAttnBlock_{i}")(lat, tokens, deterministic)
        return lat.reshape(b, s, -1, d).transpose(1, 2)


class ResidualMlp(nn.Module):
    """num_layers x [Dense-GELU residual + LayerNorm], then an output Dense."""

    def __init__(self, num_layers: int, hidden_dim: int, out_dim: int, dtype=torch.float32,
                 gen=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"TorchDense_{i}", TorchDense(hidden_dim, hidden_dim, dtype, gen))
            self.add_module(f"LayerNorm_{i}", LayerNorm(hidden_dim, dtype))
        self.add_module(f"TorchDense_{num_layers}", TorchDense(hidden_dim, out_dim, dtype, gen))

    def forward(self, x):
        for i in range(self.num_layers):
            x = x + gelu(getattr(self, f"TorchDense_{i}")(x))
            x = getattr(self, f"LayerNorm_{i}")(x)
        return getattr(self, f"TorchDense_{self.num_layers}")(x)


class FourierEmbs(nn.Module):
    f32_params = ("kernel",)
    seed_rules = {"kernel": "normal"}

    def __init__(self, embed_scale: float, embed_dim: int, in_dim: int = 2, gen=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.randn((in_dim, embed_dim // 2), generator=gen) * embed_scale)

    def forward(self, x):
        dot = x @ self.kernel
        return torch.cat([torch.cos(dot), torch.sin(dot)], dim=-1)


class CViTEncoder(nn.Module):
    f32_params = ("t_emb", "s_emb")

    def __init__(self, patch_size: Tuple[int, int, int], emb_dim: int, depth: int,
                 num_heads: int, mlp_ratio: int, thw_shape: Tuple[int, int, int], in_chans: int,
                 dtype=torch.float32, gen=None):
        super().__init__()
        pt, ph, pw = patch_size
        t_full, h_full, w_full = thw_shape
        self.depth = depth
        self.patch_embed = PatchConv(in_chans, emb_dim, tuple(patch_size), dtype=dtype, gen=gen)
        self.t_emb = nn.Parameter(torch.from_numpy(get_1d_sincos_pos_embed(emb_dim, t_full // pt)))
        self.s_emb = nn.Parameter(torch.from_numpy(get_2d_sincos_pos_embed(
            emb_dim, (h_full // ph, w_full // pw), flatten=True)))
        self.time_agg = TimeAggregation(emb_dim, depth=2, num_heads=num_heads, num_latents=1,
                                        mlp_ratio=mlp_ratio, dtype=dtype, gen=gen)
        self.LayerNorm_0 = LayerNorm(emb_dim, dtype)
        for i in range(depth):
            self.add_module(f"SelfAttnBlock_{i}",
                            SelfAttnBlock(num_heads, emb_dim, mlp_ratio, dtype, gen))

    def forward(self, x, deterministic: bool = True):
        """(B, T, H, W, C) -> (B, S, emb_dim), S = (H / ph) * (W / pw)."""
        b = x.shape[0]
        z = self.patch_embed(x)  # (B, T/pt, H/ph, W/pw, D)
        z = z.reshape(b, z.shape[1], -1, z.shape[-1])
        z = z + self.t_emb[:, :, None, :] + self.s_emb[:, None, :, :]
        z = self.LayerNorm_0(self.time_agg(z, deterministic))  # (B, 1, S, D)
        z = z.reshape(b, -1, z.shape[-1])
        for i in range(self.depth):
            z = getattr(self, f"SelfAttnBlock_{i}")(z, deterministic)
        return z


class CViT(nn.Module):
    f32_params = ("latents", "grid")
    seed_rules = {"latents": "normal", "grid": "keep"}

    def __init__(self, in_T: int, dset_metadata: Optional[TanteMetadata] = None,
                 out_steps: int = 4, patch_size: Tuple[int, int, int] = (1, 16, 16),
                 grid_size: Tuple[int, int] = (128, 128), latent_dim: int = 256,
                 emb_dim: int = 256, depth: int = 3, num_heads: int = 8, dec_emb_dim: int = 256,
                 dec_num_heads: int = 8, dec_depth: int = 1, num_mlp_layers: int = 1,
                 mlp_ratio: int = 1, eps: float = 1e5, embedding_type: str = "grid",
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        md = dset_metadata
        self.in_T, self.out_steps, self.eps = in_T, out_steps, eps
        self.embedding_type, self.dec_depth, self.dtype = embedding_type, dec_depth, dtype
        self.n_fields = md.n_fields if md else 4
        if embedding_type == "grid":
            n_x, n_y = grid_size
            self.latents = nn.Parameter(torch.randn((n_x * n_y, latent_dim), generator=gen))
            xx, yy = np.meshgrid(np.linspace(0, 1, n_x), np.linspace(0, 1, n_y), indexing="ij")
            self.grid = nn.Parameter(torch.from_numpy(
                np.stack([xx.flatten(), yy.flatten()], axis=-1).astype(np.float32)))
            self.TorchDense_0 = TorchDense(latent_dim, dec_emb_dim, dtype, gen)
            self.LayerNorm_0 = LayerNorm(dec_emb_dim, dtype)
        elif embedding_type == "fourier":
            self.FourierEmbs_0 = FourierEmbs(2 * np.pi, dec_emb_dim, gen=gen)
        elif embedding_type == "mlp":
            self.MlpBlock_0 = MlpBlock(2, dec_emb_dim, dec_emb_dim, dtype, gen)
            self.LayerNorm_0 = LayerNorm(dec_emb_dim, dtype)
        else:
            raise ValueError(f"Unknown embedding_type '{embedding_type}'")
        thw = (in_T, *(md.spatial_resolution if md else (128, 384)))
        self.encoder = CViTEncoder(tuple(patch_size), emb_dim, depth, num_heads, mlp_ratio, thw,
                                   self.n_fields, dtype, gen)
        self.norm1 = LayerNorm(emb_dim, dtype)
        self.E2D = TorchDense(emb_dim, dec_emb_dim, dtype, gen)
        for i in range(dec_depth):
            self.add_module(f"CrossAttnBlock_{i}",
                            CrossAttnBlock(dec_num_heads, dec_emb_dim, mlp_ratio, dtype, gen))
        self.norm2 = LayerNorm(dec_emb_dim, dtype)
        self.mlp = ResidualMlp(num_mlp_layers, dec_emb_dim, self.n_fields * out_steps, dtype, gen)
        self.to(dev)

    @property
    def output_length(self) -> int:
        return self.out_steps

    def _embed_coords(self, coords: torch.Tensor) -> torch.Tensor:
        if self.embedding_type == "grid":
            # softmax(-eps |q - g|^2) == softmax(eps (2 q.g - |g|^2)): the |q|^2
            # term is constant per query and cancels.  f32 throughout.
            grid = self.grid.float()
            logits = self.eps * (2.0 * coords.float() @ grid.T - (grid * grid).sum(1)[None, :])
            emb = torch.softmax(logits, dim=1) @ self.latents.float()
            return self.LayerNorm_0(self.TorchDense_0(emb))
        if self.embedding_type == "fourier":
            return self.FourierEmbs_0(coords)
        return self.LayerNorm_0(self.MlpBlock_0(coords))

    def forward(self, x: torch.Tensor, coords: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T, H, W, C); coords: (N, 2) in [0, 1]^2 or None.  Returns
        (B, out_steps, N, C) with coords, else (B, out_steps, H, W, C).  No
        dropout: ``generator`` is the trainers' call signature."""
        b, t, h, w, c = x.shape
        full_grid = coords is None
        if full_grid:
            xs, ys = torch.meshgrid(torch.linspace(0, 1, h, device=x.device),
                                    torch.linspace(0, 1, w, device=x.device), indexing="ij")
            coords = torch.stack([xs.flatten(), ys.flatten()], dim=-1)
        q = self._embed_coords(coords)
        q = q.expand(b, *q.shape)
        z = self.E2D(self.norm1(self.encoder(x, deterministic)))
        for i in range(self.dec_depth):
            q = getattr(self, f"CrossAttnBlock_{i}")(q, z, deterministic)
        y = self.mlp(self.norm2(q))  # (B, N, out_steps * C)
        y = y.reshape(b, -1, self.out_steps, c).transpose(1, 2)
        return y.reshape(b, self.out_steps, h, w, c) if full_grid else y
