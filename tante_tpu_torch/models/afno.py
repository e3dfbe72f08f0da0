"""AFNO baseline (counterpart of ``tante_tpu/models/afno.py``): the
FourCastNet-style Adaptive Fourier Neural Operator.

A conv patch embed over the T-folded channels, a learned position embedding
(0.02 truncated normal), N blocks of [LayerNorm -> Fourier token mixer ->
double skip -> LayerNorm -> MLP (ratio 4)], a transposed-conv de-patch, one
frame out.  Spatial axes are (H, W) or (D, H, W).

The mixer is the JAX package's corrected one: rfft over the spatial axes,
block-diagonal complex MLP, softshrink, inverse rfft back to the same grid
(the original repo's reversed-axes quirk on non-square grids is not
reproduced; see the JAX docstring).  Its transforms are ``torch.fft.rfftn`` /
``irfftn`` (ortho) in f32 on every rank of grid: the JAX package takes a
dense DFT for 2-D grids because XLA on the TPU has no FFT, and the two agree
to f32 rounding.  The patch embed and de-patch are stride == kernel convs,
``ops/convs.py:PatchConv`` / ``PatchConvTranspose`` (the latter flips the
kernel as flax's ``ConvTranspose`` does).  Plain PyTorch throughout: AFNO
reaches no hand-written kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.common import LayerNorm
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.attention import Dense, dropout
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.convs import PatchConv, PatchConvTranspose
from tante_tpu_torch.ops.fourier import block_diag_complex_matmul, softshrink
from tante_tpu_torch.ops.initializers import trunc_normal_init


def trunc02(shape, gen) -> torch.Tensor:
    return trunc_normal_init(shape, 0.02, gen)


def dense02(c_in: int, c_out: int, dtype, gen) -> Dense:
    """flax ``nn.Dense(c_out, kernel_init=trunc_normal(0.02))``: zero bias."""
    return Dense(trunc02((c_in, c_out), gen), torch.zeros(c_out), dtype)


def patch_conv02(cls, c_in: int, c_out: int, patch, dtype, gen):
    """A stride == kernel conv (or transposed conv) with flax's
    ``kernel_init=trunc_normal(0.02)`` and zero bias."""
    conv = cls(c_in, c_out, tuple(patch), dtype=dtype, gen=gen)
    with torch.no_grad():
        conv.kernel.copy_(trunc02(tuple(conv.kernel.shape), gen))
        conv.bias.zero_()
    return conv


class AFNOFilter(nn.Module):
    """rfft -> block-diagonal complex MLP with split GELU -> softshrink ->
    inverse rfft, over every axis between the batch and the channels."""

    def __init__(self, hidden_size: int, num_blocks: int = 8, sparsity_threshold: float = 0.01,
                 dtype=torch.float32, gen=None):
        super().__init__()
        if hidden_size % num_blocks:
            raise ValueError(f"hidden size {hidden_size} does not split into {num_blocks} blocks")
        self.hidden_size, self.num_blocks = hidden_size, num_blocks
        self.sparsity_threshold, self.dtype = sparsity_threshold, dtype
        bs = hidden_size // num_blocks
        # 0.02 * complex normal (the reference's ComplexBlockLinear scale).
        self.w1 = nn.Parameter(0.02 * torch.randn((2, num_blocks, bs, bs), generator=gen) / 2**0.5)
        self.w2 = nn.Parameter(0.02 * torch.randn((2, num_blocks, bs, bs), generator=gen) / 2**0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.ndim - 1))
        sizes = tuple(x.shape[1:-1])
        nb, bs = self.num_blocks, self.hidden_size // self.num_blocks
        xf = torch.fft.rfftn(x.float(), dim=axes, norm="ortho")
        xf = xf.reshape(*xf.shape[:-1], nb, bs)
        w1, w2 = self.w1.float(), self.w2.float()
        re, im = block_diag_complex_matmul(xf.real, xf.imag, w1[0], w1[1])
        re, im = block_diag_complex_matmul(gelu(re), gelu(im), w2[0], w2[1])
        re = softshrink(re, self.sparsity_threshold)
        im = softshrink(im, self.sparsity_threshold)
        yf = torch.complex(re, im).reshape(*re.shape[:-2], self.hidden_size)
        return torch.fft.irfftn(yf, s=sizes, dim=axes, norm="ortho").to(x.dtype)


class AFNOBlock(nn.Module):
    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0, num_blocks: int = 8,
                 sparsity_threshold: float = 0.01, double_skip: bool = True,
                 dtype=torch.float32, gen=None):
        super().__init__()
        self.double_skip = double_skip
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype, eps=1e-6)
        self.AFNOFilter_0 = AFNOFilter(hidden_dim, num_blocks, sparsity_threshold, dtype, gen)
        self.LayerNorm_1 = LayerNorm(hidden_dim, dtype, eps=1e-6)
        hidden = int(hidden_dim * mlp_ratio)
        self.Dense_0 = dense02(hidden_dim, hidden, dtype, gen)
        self.Dense_1 = dense02(hidden, hidden_dim, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.AFNOFilter_0(self.LayerNorm_0(x))
        if self.double_skip:
            y = y + residual
            residual = y
        z = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(y))))
        return z + residual


class AFNO(nn.Module):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        hidden_dim: int = 256,
        n_blocks: int = 12,
        cmlp_diagonal_blocks: int = 8,
        patch_size: int = 8,
        mlp_ratio: float = 4.0,
        drop_rate: float = 0.0,
        sparsity_threshold: float = 0.01,
        output_length: int = 1,
        dtype=torch.float32,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        md = dset_metadata
        c = md.n_fields if md else 4
        spatial = tuple(md.spatial_resolution) if md else (128, 384)
        self.in_T, self.output_length, self.dtype = in_T, output_length, dtype
        self.n_blocks, self.drop_rate = n_blocks, drop_rate
        patch = (patch_size,) * len(spatial)
        self.patch_embed = patch_conv02(PatchConv, in_T * c, hidden_dim, patch, dtype, gen)
        self.pos_embed = nn.Parameter(trunc02((1, *(s // patch_size for s in spatial),
                                               hidden_dim), gen))
        for i in range(n_blocks):
            self.add_module(f"AFNOBlock_{i}", AFNOBlock(
                hidden_dim, mlp_ratio, cmlp_diagonal_blocks, sparsity_threshold, dtype=dtype,
                gen=gen))
        self.patch_debed = patch_conv02(PatchConvTranspose, hidden_dim, c, patch, dtype, gen)
        self.to(dev)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, *spatial, C) -> (B, 1, *spatial, C); spatial is (H, W) or
        (D, H, W)."""
        b, t, c = x.shape[0], x.shape[1], x.shape[-1]
        spatial = x.shape[2:-1]
        z = x.movedim(1, -2).reshape(b, *spatial, t * c)
        z = self.patch_embed(z) + self.pos_embed.to(self.dtype)
        if not deterministic and self.drop_rate > 0.0:
            if generator is None:
                raise ValueError("dropout is active: pass the torch.Generator to draw masks from")
            z = dropout(z, self.drop_rate, generator)
        for i in range(self.n_blocks):
            z = getattr(self, f"AFNOBlock_{i}")(z)
        return self.patch_debed(z)[:, None]
