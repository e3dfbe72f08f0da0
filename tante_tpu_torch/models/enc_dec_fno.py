"""FNO-type encoder/decoder for TANTE (counterpart of
``tante_tpu/models/enc_dec_fno.py``), channels-last: the patch-conv pyramid
interleaved with truncated-mode spectral layers, in two stages
(``FNO_PATCH_MAP``).  The mode-space channel mixing of every spectral layer
runs through ``ops/fused_spectral.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.convs import RealConv2d, RealTransConv2d
from tante_tpu_torch.ops.spectral import SpectralLayer

# patch_scale -> 2-stage patch sizes (reference enc_dec_fno.py:39-46).
FNO_PATCH_MAP = {
    64: (8, 8),
    32: (8, 4),
    16: (4, 4),
    8: (4, 2),
    4: (2, 2),
    2: (2, 1),
}


class EncFNO(nn.Module):
    def __init__(self, dset_metadata: Optional[TanteMetadata] = None, embed_dim: int = 256,
                 modes: Tuple[int, int] = (32, 32), patch_scale: int = 64,
                 overlap_ratio: float = 0.0, dtype=torch.float32, gen=None):
        super().__init__()
        c_in = dset_metadata.n_fields if dset_metadata else 4
        p, e, (m1, m2) = FNO_PATCH_MAP[patch_scale], embed_dim, modes
        self.SpectralLayer_0 = SpectralLayer(c_in, e // 8, m1, m2, dtype, gen)
        self.RealConv2d_0 = RealConv2d(e // 8, e // 4, p[0], overlap_ratio, dtype, gen)
        self.SpectralLayer_1 = SpectralLayer(e // 4, e // 2, m1 // p[0], m2 // p[0], dtype, gen)
        self.RealConv2d_1 = RealConv2d(e // 2, e, p[1], overlap_ratio, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C_in) -> (B, T, H_p, W_p, embed_dim)."""
        b, t = x.shape[0], x.shape[1]
        z = x.reshape(b * t, *x.shape[2:])
        z = gelu(self.SpectralLayer_0(z))
        z = gelu(self.RealConv2d_0(z))
        z = gelu(self.SpectralLayer_1(z))
        z = self.RealConv2d_1(z)
        return z.reshape(b, t, *z.shape[1:])


class DecFNO(nn.Module):
    def __init__(self, dset_metadata: Optional[TanteMetadata] = None, embed_dim: int = 256,
                 modes: Tuple[int, int] = (32, 32), patch_scale: int = 64,
                 overlap_ratio: float = 0.0, dtype=torch.float32, gen=None):
        super().__init__()
        c_out = dset_metadata.n_fields if dset_metadata else 4
        p, e, (m1, m2) = FNO_PATCH_MAP[patch_scale], embed_dim, modes
        self.RealTransConv2d_0 = RealTransConv2d(e, e // 2, p[1], overlap_ratio, dtype, gen)
        self.SpectralLayer_0 = SpectralLayer(e // 2, e // 4, m1 // p[0], m2 // p[0], dtype, gen)
        self.RealTransConv2d_1 = RealTransConv2d(e // 4, e // 8, p[0], overlap_ratio, dtype, gen)
        self.SpectralLayer_1 = SpectralLayer(e // 8, c_out, m1, m2, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H_p, W_p, embed_dim) -> (B, T, H, W, C_out)."""
        b, t = x.shape[0], x.shape[1]
        z = x.reshape(b * t, *x.shape[2:])
        z = gelu(self.RealTransConv2d_0(z))
        z = gelu(self.SpectralLayer_0(z))
        z = gelu(self.RealTransConv2d_1(z))
        z = self.SpectralLayer_1(z)
        return z.reshape(b, t, *z.shape[1:])
