"""CNN encoder/decoder pyramids (counterpart of
``tante_tpu/models/enc_dec_cnn.py``), channels-last.

Encoder (B, T, H, W, C_in) -> (B, T, H_p, W_p, C_embed), three patch-conv
stages with per-stage patch sizes ``PATCH_MAP[patch_scale]``; the decoder
mirrors back, at any ``overlap_ratio`` (``ops/convs.py``).  Three modes:
plain (physical frames); ``packed=True``: the frames in
``pack_patches(frames, p0)`` layout, where stage 0 skips its
space-to-depth (the encoder) or its depth-to-space (the decoder) and the
other stages run plain; ``"morton"``: the constant-row pyramid on
``morton_pack_grouped`` frames, one row per latent pixel, where every
stage is one grouped matmul.  JAX forks the packed mode into an
"all-dense" pyramid where every stage is a clean space-to-depth, because
its plain stages are XLA convs; here a plain stride == patch, unpadded
stage already is space-to-depth + one matmul (``ops/convs.py``), so the
plain stages are that pyramid, the same operations on the same operands.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.convs import (
    RealConv2d,
    RealTransConv2d,
    morton_pyramid_ok,
)

# patch_scale -> per-stage patch sizes (reference enc_dec_cnn.py:39-46).
PATCH_MAP = {
    64: (4, 4, 4),
    32: (4, 4, 2),
    16: (4, 2, 2),
    8: (2, 2, 2),
    4: (2, 2, 1),
    2: (2, 1, 1),
}


def _check_mode(packed, p, overlap_ratio):
    if packed not in (False, True, "morton"):
        raise ValueError(f"enc/dec mode {packed!r}: the modes are False, True and 'morton'")
    if packed == "morton" and not morton_pyramid_ok(p, overlap_ratio):
        raise ValueError("'morton' mode needs a clean pyramid (TANTE.morton_io_ok())")


class EncCNN(nn.Module):
    def __init__(self, dset_metadata: Optional[TanteMetadata] = None, embed_dim: int = 256,
                 patch_scale: int = 64, overlap_ratio: float = 0.0, dtype=torch.float32,
                 gen=None):
        super().__init__()
        md = dset_metadata
        self.resolution = tuple(md.spatial_resolution) if md else (128, 384)
        c_in = md.n_fields if md else 4
        self.p = PATCH_MAP[patch_scale]
        self.patch_scale = patch_scale
        self.embed_dim = embed_dim
        self.overlap_ratio = overlap_ratio
        p, e = self.p, embed_dim
        self.RealConv2d_0 = RealConv2d(c_in, e // 4, p[0], overlap_ratio, dtype, gen)
        self.RealConv2d_1 = RealConv2d(e // 4, e // 2, p[1], overlap_ratio, dtype, gen)
        self.RealConv2d_2 = RealConv2d(e // 2, e, p[2], overlap_ratio, dtype, gen)

    def forward(self, x: torch.Tensor, packed_in=False) -> torch.Tensor:
        """packed_in=True: x is ``pack_patches(frames, p0)``; "morton": x is
        (B, T, H_p*W_p, g*p0*p0*C_in) rows."""
        _check_mode(packed_in, self.p, self.overlap_ratio)
        p = self.p
        b, t = x.shape[0], x.shape[1]
        z = x.reshape(b * t, *x.shape[2:])
        if packed_in == "morton":
            g = (p[1] * p[2]) ** 2
            z = gelu(self.RealConv2d_0(z, packed_in=True, packed_group=g))
            z = gelu(self.RealConv2d_1(z, packed_in=True, packed_group=g // (p[1] * p[1])))
            z = self.RealConv2d_2(z, packed_in=True, packed_group=1)
            hp, wp = (r // self.patch_scale for r in self.resolution)
            return z.reshape(b, t, hp, wp, self.embed_dim)
        z = gelu(self.RealConv2d_0(z, packed_in=packed_in))
        z = gelu(self.RealConv2d_1(z))
        z = self.RealConv2d_2(z)
        return z.reshape(b, t, *z.shape[1:])


class DecCNN(nn.Module):
    def __init__(self, dset_metadata: Optional[TanteMetadata] = None, embed_dim: int = 256,
                 patch_scale: int = 64, overlap_ratio: float = 0.0, dtype=torch.float32,
                 gen=None):
        super().__init__()
        md = dset_metadata
        out_channels = md.n_fields if md else 4
        self.p = PATCH_MAP[patch_scale]
        self.overlap_ratio = overlap_ratio
        p, e = self.p, embed_dim
        self.RealTransConv2d_0 = RealTransConv2d(e, e // 2, p[2], overlap_ratio, dtype, gen)
        self.RealTransConv2d_1 = RealTransConv2d(e // 2, e // 4, p[1], overlap_ratio, dtype, gen)
        self.RealTransConv2d_2 = RealTransConv2d(e // 4, out_channels, p[0], overlap_ratio,
                                                 dtype, gen)

    def forward(self, x: torch.Tensor, packed_out=False) -> torch.Tensor:
        """packed_out=True: returns ``pack_patches(frames, p0)``; "morton":
        (B, T, H_p*W_p, g*p0*p0*C_out) rows."""
        _check_mode(packed_out, self.p, self.overlap_ratio)
        p = self.p
        b, t = x.shape[0], x.shape[1]
        z = x.reshape(b * t, *x.shape[2:])
        if packed_out == "morton":
            z = z.reshape(b * t, -1, z.shape[-1])
            z = gelu(self.RealTransConv2d_0(z, packed_out=True, packed_group=1))
            z = gelu(self.RealTransConv2d_1(z, packed_out=True, packed_group=p[2] * p[2]))
            z = self.RealTransConv2d_2(z, packed_out=True, packed_group=(p[1] * p[2]) ** 2)
            return z.reshape(b, t, *z.shape[1:])
        z = gelu(self.RealTransConv2d_0(z))
        z = gelu(self.RealTransConv2d_1(z))
        z = self.RealTransConv2d_2(z, packed_out=packed_out)
        return z.reshape(b, t, *z.shape[1:])
