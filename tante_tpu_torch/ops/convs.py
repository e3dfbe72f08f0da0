"""Patchify / de-patchify convolutions as dense matmuls (counterpart of
``tante_tpu/ops/convs.py``), channels-last.

Only the clean case is ported: stride == patch and zero padding
(``overlap_ratio=0`` with 1x1 or 2x2 patches, every stage of
``patch_scale=8``).  There a patch conv IS space-to-depth + one matmul and
its transpose one matmul + depth-to-space, so the plain, ``packed`` and
``"morton"`` modes all run as matmuls.  The overlapping cases (padding plus
the adaptive-pool / bilinear grid enforcement) raise ``NotImplementedError``.

Parameters keep the flax layouts: ``kernel`` HWIO ``(ph, pw, ci, co)``,
``bias`` ``(co,)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from tante_tpu_torch.ops.initializers import torch_bias_init, torch_kernel_init


def pack_patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """Space-to-depth: (..., H, W, C) -> (..., H/p, W/p, p*p*C), channel
    order (patch-row, patch-col, channel) = the HWIO kernel flattening."""
    *lead, h, w, c = x.shape
    z = x.reshape(*lead, h // p, p, w // p, p, c)
    nd = z.ndim
    z = z.permute(*range(nd - 5), nd - 5, nd - 3, nd - 4, nd - 2, nd - 1)
    return z.reshape(*lead, h // p, w // p, p * p * c)


def unpack_patches(z: torch.Tensor, p: int) -> torch.Tensor:
    """Depth-to-space inverse of ``pack_patches``."""
    *lead, hp, wp, pc = z.shape
    c = pc // (p * p)
    y = z.reshape(*lead, hp, wp, p, p, c)
    nd = y.ndim
    y = y.permute(*range(nd - 5), nd - 5, nd - 3, nd - 4, nd - 2, nd - 1)
    return y.reshape(*lead, hp * p, wp * p, c)


def packed_patch_ok(p: int, overlap_ratio: float) -> bool:
    """Whether a pxp patch conv is a clean space-to-depth + dense."""
    return overlap_ratio == 0.0 and (p - 1) // 2 == 0 and p > 1


def morton_pack(x: torch.Tensor, ps: Tuple[int, int, int]) -> torch.Tensor:
    """Quad-tree space-to-depth for a 3-stage pyramid: (..., H, W, C) ->
    (..., N, p0*p0*C), rows ordered (h_c, w_c, h2, w2, h1, w1), channels
    (h0, w0, c) — see ``tante_tpu/ops/convs.py:morton_pack``."""
    p0, p1, p2 = ps
    *lead, h, w, c = x.shape
    s = p0 * p1 * p2
    hc, wc = h // s, w // s
    z = x.reshape(*lead, hc, p2, p1, p0, wc, p2, p1, p0, c)
    l = z.ndim - 9
    z = z.permute(*range(l), l, l + 4, l + 1, l + 5, l + 2, l + 6, l + 3, l + 7, l + 8)
    return z.reshape(*lead, hc * wc * p2 * p2 * p1 * p1, p0 * p0 * c)


def morton_unpack(z: torch.Tensor, ps: Tuple[int, int, int], hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of ``morton_pack``; ``hw`` is the physical (H, W)."""
    p0, p1, p2 = ps
    h, w = hw
    *lead, _, pc = z.shape
    c = pc // (p0 * p0)
    s = p0 * p1 * p2
    hc, wc = h // s, w // s
    y = z.reshape(*lead, hc, wc, p2, p2, p1, p1, p0, p0, c)
    l = y.ndim - 9
    y = y.permute(*range(l), l, l + 2, l + 4, l + 6, l + 1, l + 3, l + 5, l + 7, l + 8)
    return y.reshape(*lead, h, w, c)


def morton_pyramid_ok(ps: Tuple[int, int, int], overlap_ratio: float) -> bool:
    """Every stage a clean space-to-depth (or pointwise), stage 0 a real patch."""
    return packed_patch_ok(ps[0], overlap_ratio) and all(
        pi == 1 or packed_patch_ok(pi, overlap_ratio) for pi in ps
    )


def morton_group_factor(ps: Tuple[int, int, int]) -> int:
    """Rows per latent pixel of the morton frame layout."""
    return (ps[1] * ps[2]) ** 2


def morton_pack_grouped(x: torch.Tensor, ps: Tuple[int, int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., H_p*W_p, g*p0*p0*C), g = (p1*p2)**2: one row
    per final latent pixel carrying its whole receptive field."""
    z = morton_pack(x, ps)
    g = morton_group_factor(ps)
    return z.reshape(*z.shape[:-2], z.shape[-2] // g, g * z.shape[-1])


def morton_unpack_grouped(
    z: torch.Tensor, ps: Tuple[int, int, int], hw: Tuple[int, int]
) -> torch.Tensor:
    g = morton_group_factor(ps)
    y = z.reshape(*z.shape[:-2], z.shape[-2] * g, z.shape[-1] // g)
    return morton_unpack(y, ps, hw)


def _stride(p: int, overlap_ratio: float) -> int:
    return max(1, int(round(p * (1.0 - overlap_ratio))))


def _require_clean(p: int, overlap_ratio: float):
    if _stride(p, overlap_ratio) != p or (p - 1) // 2 != 0:
        raise NotImplementedError(
            f"patch {p} with overlap_ratio {overlap_ratio}: the padded conv and its "
            "adaptive-pool / bilinear grid enforcement are not ported yet"
        )


def _grouped_matmul(z: torch.Tensor, wmat: torch.Tensor, group: int, bias=None):
    """``z @ kron(I_group, wmat) + tile(bias, group)`` without the zero blocks
    or the tiled bias: the JAX package builds the block-diagonal weight for
    the TPU's lane layout; rows reshaped to (..., group, K) @ W (+ bias
    broadcast over the group) is the same product and the same sums."""
    y = z.reshape(*z.shape[:-1], group, wmat.shape[0]) @ wmat
    if bias is not None:
        y = (y.reshape(*y.shape[:-1], -1, bias.shape[0]) + bias)
    return y.reshape(*z.shape[:-1], -1)


class _ConvParams(nn.Module):
    """Flax ``Conv_0`` / ``ConvTranspose_0``: kernel (ph, pw, ci, co), bias (co,)."""

    def __init__(self, p: int, c_in: int, c_out: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(torch_kernel_init((p, p, c_in, c_out), gen))
        self.bias = nn.Parameter(torch_bias_init((c_out,), p * p * c_in, gen))


class RealConv2d(nn.Module):
    """Stride == patch conv as space-to-depth + matmul (``ops/convs.py:296``)."""

    def __init__(self, c_in, out_channels, patch_size, overlap_ratio=0.0,
                 dtype=torch.float32, gen=None):
        super().__init__()
        _require_clean(patch_size, overlap_ratio)
        self.p = patch_size
        self.dtype = dtype
        self.Conv_0 = _ConvParams(patch_size, c_in, out_channels, gen)

    def forward(self, x, packed_in: bool = False, packed_group: int = 1):
        """x: (..., H, W, C) or, with ``packed_in``, ``pack_patches`` rows
        whose last dim carries ``packed_group`` packed pixels."""
        k = self.Conv_0.kernel
        wmat = k.reshape(-1, k.shape[-1]).to(self.dtype)
        bias = self.Conv_0.bias.to(self.dtype)
        if not packed_in:
            x = pack_patches(x, self.p) if self.p > 1 else x
            packed_group = 1
        return _grouped_matmul(x.to(self.dtype), wmat, packed_group, bias)


class RealTransConv2d(nn.Module):
    """Stride == patch transposed conv as matmul + depth-to-space
    (``ops/convs.py:365``)."""

    def __init__(self, c_in, out_channels, patch_size, overlap_ratio=0.0,
                 dtype=torch.float32, gen=None):
        super().__init__()
        _require_clean(patch_size, overlap_ratio)
        self.p = patch_size
        self.dtype = dtype
        self.ConvTranspose_0 = _ConvParams(patch_size, c_in, out_channels, gen)

    def forward(self, x, packed_out: bool = False, packed_group: int = 1):
        p = self.p
        k = self.ConvTranspose_0.kernel
        c_in, c_out = k.shape[2], k.shape[3]
        # (ph, pw, ci, co) -> (ci, ph*pw*co).  lax.conv_transpose (flax's
        # ConvTranspose, transpose_kernel=False) mirrors the kernel
        # spatially, so flip it (``_PatchDenseTranspose``, convs.py:262-267).
        wmat = k.flip(0, 1).permute(2, 0, 1, 3).reshape(c_in, p * p * c_out).to(self.dtype)
        bias = self.ConvTranspose_0.bias.to(self.dtype)
        if packed_out:
            return _grouped_matmul(x.to(self.dtype), wmat, packed_group, bias)
        y = x.to(self.dtype) @ wmat
        if p > 1:
            y = unpack_patches(y, p)
        return y + bias
