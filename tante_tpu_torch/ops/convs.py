"""Patchify / de-patchify convolutions (counterpart of
``tante_tpu/ops/convs.py``), channels-last.

Stride == patch: with 1x1 or 2x2 patches (every stage of the CNN pyramid at
``patch_scale=8``) the symmetric padding ``(p - 1) // 2`` is zero and a
patch conv IS space-to-depth + one matmul, its transpose one matmul +
depth-to-space, so the plain, ``packed`` and ``"morton"`` modes all run as
matmuls.  Larger patches (the FNO pyramid's 4x4 stage) pad: the conv then
reads the frame shifted by the padding (the same matmul on the shifted
frame; the grid already is (H/p, W/p)), and the transposed conv crops the
padding off its (H*p, W*p) output and resizes bilinearly back to that
grid, plain mode only.

Stride below the patch (``overlap_ratio > 0``, stride
``max(1, round(p * (1 - overlap_ratio)))``, Python's rounding: patch 2 at
0.25 keeps stride 2): ``RealConv2d`` is the padded strided conv
(``conv_nhwc``) average-pooled to the (H/p, W/p) grid
(``ops/pooling.py:adaptive_avg_pool2d``); ``RealTransConv2d`` the VALID
transposed conv (``F.conv_transpose2d`` on the spatially flipped flax
kernel), cropped by the padding and resized bilinearly to (H*p, W*p).
``enforce_patch_grid=False`` skips the pool / the resize, as in JAX.

Parameters keep the flax layouts: ``kernel`` HWIO ``(ph, pw, ci, co)``,
``bias`` ``(co,)``.

``Conv2d`` is flax ``nn.Conv`` in general (any kernel, stride, explicit
per-side padding, feature groups) on channels-last fields, through
``F.conv2d`` on a channels-last view; ``depthwise_conv2d_lanes`` /
``DepthwiseConv2d`` are the JAX package's depthwise 'same' conv, here the
grouped conv itself (the lane-flat form is a TPU layout choice, the same
function).  The zoo models build on these.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tante_tpu_torch.ops.initializers import torch_bias_init, torch_kernel_init
from tante_tpu_torch.ops.pooling import adaptive_avg_pool2d, resize_bilinear


def patchify(x: torch.Tensor, patch: Tuple[int, ...]) -> torch.Tensor:
    """(..., *S, C) -> (..., *S/p, prod(p)*C) over the last ``len(patch)``
    spatial axes, channel order (patch offsets, channel) = the kernel's
    flattening; ``pack_patches`` for any rank and patch shape."""
    n = len(patch)
    lead, c = x.shape[: x.dim() - n - 1], x.shape[-1]
    grid = [s // p for s, p in zip(x.shape[-n - 1 : -1], patch)]
    if any(g * p != s for g, p, s in zip(grid, patch, x.shape[-n - 1 : -1])):
        raise ValueError(f"spatial axes {tuple(x.shape[-n - 1:-1])} are not divisible by the "
                         f"patch {tuple(patch)}")
    z = x.reshape(*lead, *(d for g, p in zip(grid, patch) for d in (g, p)), c)
    nl = len(lead)
    z = z.permute(*range(nl), *(nl + 2 * i for i in range(n)), *(nl + 2 * i + 1 for i in range(n)),
                  nl + 2 * n)
    return z.reshape(*lead, *grid, -1)


def unpatchify(z: torch.Tensor, patch: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of ``patchify``: (..., *G, prod(p)*C) -> (..., *G*p, C)."""
    n = len(patch)
    lead, grid = z.shape[: z.dim() - n - 1], z.shape[-n - 1 : -1]
    y = z.reshape(*lead, *grid, *patch, -1)
    nl = len(lead)
    y = y.permute(*range(nl), *(d for i in range(n) for d in (nl + i, nl + n + i)), nl + 2 * n)
    return y.reshape(*lead, *(g * p for g, p in zip(grid, patch)), y.shape[-1])


def pack_patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """Space-to-depth: (..., H, W, C) -> (..., H/p, W/p, p*p*C), channel
    order (patch-row, patch-col, channel) = the HWIO kernel flattening."""
    return patchify(x, (p, p))


def unpack_patches(z: torch.Tensor, p: int) -> torch.Tensor:
    """Depth-to-space inverse of ``pack_patches``."""
    return unpatchify(z, (p, p))


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


def _pad(p: int) -> int:
    """Symmetric 'same'-style padding of a pxp patch conv."""
    return (p - 1) // 2


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
    """Patch conv onto the (H/p, W/p) grid (``ops/convs.py:296``).  Stride ==
    patch on a frame the patch divides: space-to-depth + matmul; with
    padding ``pad`` (patches of 3 and more) the windows start ``pad`` pixels
    before the frame and the last ``pad`` pixels fall outside every window:
    the frame shifted by ``pad`` with zeros in front.  Otherwise the padded
    strided conv, average-pooled to the grid where ``enforce_patch_grid``."""

    def __init__(self, c_in, out_channels, patch_size, overlap_ratio=0.0,
                 dtype=torch.float32, gen=None, enforce_patch_grid: bool = True):
        super().__init__()
        self.p = patch_size
        self.stride = _stride(patch_size, overlap_ratio)
        self.dtype = dtype
        self.enforce_patch_grid = enforce_patch_grid
        self.Conv_0 = _ConvParams(patch_size, c_in, out_channels, gen)

    def forward(self, x, packed_in: bool = False, packed_group: int = 1):
        """x: (..., H, W, C) or, with ``packed_in``, ``pack_patches`` rows
        whose last dim carries ``packed_group`` packed pixels."""
        p, pad = self.p, _pad(self.p)
        k = self.Conv_0.kernel
        wmat = k.reshape(-1, k.shape[-1]).to(self.dtype)
        bias = self.Conv_0.bias.to(self.dtype)
        if packed_in:
            if pad or self.stride != p:
                raise ValueError(f"packed input needs an unpadded patch conv of stride == patch, "
                                 f"got patch {p}, stride {self.stride}")
            return _grouped_matmul(x.to(self.dtype), wmat, packed_group, bias)
        h, w = x.shape[-3], x.shape[-2]
        divisible = h % p == 0 and w % p == 0
        if self.stride == p and divisible:
            if pad:
                x = F.pad(x, (0, 0, pad, 0, pad, 0))[..., :h, :w, :]
            x = pack_patches(x, p) if p > 1 else x
            return _grouped_matmul(x.to(self.dtype), wmat, 1, bias)
        if self.enforce_patch_grid and not divisible:
            raise ValueError(f"to enforce the (H/p, W/p) grid, H and W ({h}, {w}) must be "
                             f"divisible by the patch {p}")
        lead = x.shape[:-3]
        y = conv_nhwc(x.reshape(-1, h, w, x.shape[-1]).to(self.dtype), k.to(self.dtype), bias,
                      self.stride, ((pad, pad), (pad, pad)), 1)
        y = y.reshape(*lead, *y.shape[1:])
        return adaptive_avg_pool2d(y, (h // p, w // p)) if self.enforce_patch_grid else y


class RealTransConv2d(nn.Module):
    """Transposed patch conv onto the (H*p, W*p) grid (``ops/convs.py:365``).
    Stride == patch: matmul + depth-to-space; otherwise the VALID
    transposed conv (``conv_transpose_nhwc``).  Either way the output loses
    the padding on every side and, where ``enforce_patch_grid``, is resized
    bilinearly to (H*p, W*p) unless it already has that size."""

    def __init__(self, c_in, out_channels, patch_size, overlap_ratio=0.0,
                 dtype=torch.float32, gen=None, enforce_patch_grid: bool = True):
        super().__init__()
        self.p = patch_size
        self.stride = _stride(patch_size, overlap_ratio)
        self.dtype = dtype
        self.enforce_patch_grid = enforce_patch_grid
        self.ConvTranspose_0 = _ConvParams(patch_size, c_in, out_channels, gen)

    def _wmat(self) -> torch.Tensor:
        """(ph, pw, ci, co) -> (ci, ph*pw*co).  lax.conv_transpose (flax's
        ConvTranspose, transpose_kernel=False) mirrors the kernel spatially,
        so flip it (``_PatchDenseTranspose``, convs.py:262-267)."""
        k = self.ConvTranspose_0.kernel
        return k.flip(0, 1).permute(2, 0, 1, 3).reshape(k.shape[2], -1).to(self.dtype)

    def forward(self, x, packed_out: bool = False, packed_group: int = 1):
        p, pad = self.p, _pad(self.p)
        bias = self.ConvTranspose_0.bias.to(self.dtype)
        h, w = x.shape[-3], x.shape[-2]
        if packed_out:
            if pad or self.stride != p:
                raise ValueError(f"packed output needs an unpadded patch conv of stride == "
                                 f"patch, got patch {p}, stride {self.stride}")
            return _grouped_matmul(x.to(self.dtype), self._wmat(), packed_group, bias)
        if self.stride == p:
            y = x.to(self.dtype) @ self._wmat()
            if p > 1:
                y = unpack_patches(y, p)
            y = y + bias
        else:
            lead = x.shape[:-3]
            y = conv_transpose_nhwc(x.reshape(-1, h, w, x.shape[-1]).to(self.dtype),
                                    self.ConvTranspose_0.kernel.to(self.dtype), bias, self.stride)
            y = y.reshape(*lead, *y.shape[1:])
        if pad:
            y = y[..., pad:-pad, pad:-pad, :]
        if self.enforce_patch_grid and (y.shape[-3], y.shape[-2]) != (h * p, w * p):
            y = resize_bilinear(y, (h * p, w * p))
        return y


# --------------------------------------------------------------------------
# flax ``nn.Conv`` / ``nn.ConvTranspose`` with stride == kernel, any rank
# (AViT's hMLP stem and head, CViT's space-time patch embed)
# --------------------------------------------------------------------------


class PatchConv(nn.Module):
    """flax ``nn.Conv(features, kernel_size=p, strides=p)`` on inputs whose
    spatial axes ``p`` divides ('SAME' and 'VALID' then pad nothing):
    ``patchify`` + one matmul.  Parameters ``kernel`` (*p, Cin, Cout) and,
    with ``use_bias``, ``bias`` (Cout,)."""

    def __init__(self, c_in: int, c_out: int, patch: Tuple[int, ...], use_bias: bool = True,
                 dtype=torch.float32, gen=None):
        super().__init__()
        self.patch, self.dtype = tuple(patch), dtype
        fan_in = math.prod(patch) * c_in
        self.kernel = nn.Parameter(torch_kernel_init((*patch, c_in, c_out), gen))
        self.bias = nn.Parameter(torch_bias_init((c_out,), fan_in, gen)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.to(self.dtype)
        y = patchify(x.to(self.dtype), self.patch) @ k.reshape(-1, k.shape[-1])
        return y if self.bias is None else y + self.bias.to(self.dtype)


class PatchConvTranspose(PatchConv):
    """flax ``nn.ConvTranspose(features, kernel_size=p, strides=p)``: one
    matmul + ``unpatchify``.  ``lax.conv_transpose`` (flax's default
    ``transpose_kernel=False``) mirrors the kernel spatially, so the matmul
    weight is the flipped kernel (as in ``RealTransConv2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.patch)
        k = self.kernel.flip(tuple(range(n))).to(self.dtype)  # (*p, Cin, Cout)
        wmat = k.movedim(n, 0).reshape(k.shape[n], -1)         # (Cin, prod(p)*Cout)
        y = unpatchify(x.to(self.dtype) @ wmat, self.patch)
        return y if self.bias is None else y + self.bias.to(self.dtype)


# --------------------------------------------------------------------------
# flax ``nn.Conv`` in general, and the depthwise 'same' conv (the zoo)
# --------------------------------------------------------------------------


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int, padding, groups: int):
    """Cross-correlation of (B, H, W, Cin) with an HWIO kernel, channels-last
    in and out.  ``padding`` ((top, bottom), (left, right)); symmetric
    padding goes to the convolution itself, anything else to ``F.pad``.

    On the card a dense (``groups == 1``) f32 convolution's forward runs
    PyTorch's own im2col + GEMM, not cuDNN: cuDNN 9.2's heuristics (f32, TF32
    off) take an FFT algorithm for some shapes, and for AttentionUNet's
    (4, 128, 128, 256) -> 128 3x3 conv it took 328 ms a call, where PyTorch's
    own took 1.5 ms and cuDNN the shapes around it 0.4-1.5 ms; a whole
    AttentionUNet call took 579.6 ms with cuDNN and 24.9 ms without (NVIDIA
    H100 80GB HBM3, 700 W, ``tante_tpu_torch/tools/conv_layouts.py --model``).
    The backward and the depthwise convs stay on cuDNN."""
    (pt, pb), (pl, pr) = padding
    pad = (pt, pl)
    if pt != pb or pl != pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pad = (0, 0)
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn and not (x.is_cuda and groups == 1
                                                  and x.dtype == torch.float32)
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, stride=stride,
                     padding=pad, groups=groups)
    finally:
        torch.backends.cudnn.enabled = cudnn
    return y.permute(0, 2, 3, 1)


def conv_transpose_nhwc(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int):
    """flax ``nn.ConvTranspose(strides=stride, padding="VALID")`` of
    (B, H, W, Cin) with a (kh, kw, Cin, Cout) kernel, channels-last in and
    out: (B, (H - 1) * stride + kh, (W - 1) * stride + kw, Cout).
    ``lax.conv_transpose`` (``transpose_kernel=False``) correlates the
    stride-dilated input with the kernel as it is, which is torch's
    transposed conv (a scatter of every input pixel through the kernel) with
    the kernel flipped spatially.

    On the card it runs on cuDNN, and in f32 with cuDNN's TF32 off whatever
    ``torch.backends.cudnn.allow_tf32`` says (PyTorch's default is on), so
    that the decoder computes in f32 as ``conv_nhwc``'s encoder conv does.
    The backward runs under the caller's flags, as ``conv_nhwc``'s does."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32 and not (x.is_cuda and x.dtype == torch.float32)
    try:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), kernel.flip(0, 1).permute(2, 3, 0, 1),
                               bias, stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=stride, padding=...,
    feature_group_count=groups)`` on (B, H, W, Cin): ``kernel`` (k, k,
    Cin / groups, Cout) and ``bias`` (Cout,), torch-default init with the
    bias's fan-in ``bias_fan_in`` (default: the kernel's).  ``padding`` is
    ((top, bottom), (left, right)), or None for 'VALID'.  A 1x1 conv is a
    matmul over the channels."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1, padding=None,
                 groups: int = 1, bias_fan_in: int | None = None, dtype=torch.float32, gen=None):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.padding = tuple(tuple(p) for p in padding) if padding else ((0, 0), (0, 0))
        self.kernel = nn.Parameter(torch_kernel_init((kernel, kernel, c_in // groups, c_out), gen))
        fan_in = bias_fan_in or kernel * kernel * c_in // groups
        self.bias = nn.Parameter(torch_bias_init((c_out,), fan_in, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, b = self.kernel.to(self.dtype), self.bias.to(self.dtype)
        x = x.to(self.dtype)
        if k.shape[0] == k.shape[1] == 1 and self.stride == 1 and self.groups == 1 and not any(
                sum(self.padding, ())):
            return x @ k[0, 0] + b
        return conv_nhwc(x, k, b, self.stride, self.padding, self.groups)


def same_padding(kernel: int):
    """The zoo's 'same' padding of a k x k conv: (k // 2, (k - 1) // 2) on
    each spatial axis (the reverse of XLA's 'SAME' for even k)."""
    return ((kernel // 2, (kernel - 1) // 2),) * 2


def depthwise_conv2d_lanes(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise k x k 'same' conv of (B, H, W, C) with a grouped-conv
    kernel (kh, kw, 1, C) and bias (C,), odd kernels only (the JAX form
    pads (k // 2, (k - 1) // 2), which is flax's 'SAME' only for odd k).
    The result is in ``x.dtype``."""
    kh, kw, _, c = kernel.shape
    if c != x.shape[-1]:
        raise ValueError(f"depthwise kernel channels {c} != input channels {x.shape[-1]} "
                         f"(kernel {tuple(kernel.shape)}, x {tuple(x.shape)})")
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"depthwise_conv2d_lanes requires odd kernels, got {(kh, kw)}")
    b = None if bias is None else bias.to(x.dtype)
    return conv_nhwc(x, kernel.to(x.dtype), b, 1, ((kh // 2,) * 2, (kw // 2,) * 2), c)


class DepthwiseConv2d(nn.Module):
    """flax ``nn.Conv(features, kernel_size, feature_group_count=features)``
    with odd kernels and 'same' padding: ``kernel`` (kh, kw, 1, C) and
    ``bias`` (C,), the JAX module's names and shapes."""

    def __init__(self, features: int, kernel_size: Tuple[int, int], dtype=torch.float32,
                 gen=None):
        super().__init__()
        kh, kw = kernel_size
        self.features, self.dtype = features, dtype
        self.kernel = nn.Parameter(torch_kernel_init((kh, kw, 1, features), gen))
        self.bias = nn.Parameter(torch_bias_init((features,), kh * kw, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.features:
            raise ValueError(f"DepthwiseConv2d(features={self.features}) got input with "
                             f"{x.shape[-1]} channels (shape {tuple(x.shape)})")
        return depthwise_conv2d_lanes(x.to(self.dtype), self.kernel, self.bias)
