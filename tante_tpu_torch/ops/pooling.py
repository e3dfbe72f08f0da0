"""Adaptive average pooling and image resizing, channels-last (counterpart
of ``tante_tpu/ops/pooling.py`` and of ``jax.image.resize`` as the JAX
package calls it).

``adaptive_avg_pool2d(x, (h_out, w_out))`` has torch's bins (bin i covers
``[floor(i*In/Out), ceil((i+1)*In/Out))``), which the JAX package
reproduces with differences of cumulative sums.  Here it is
``F.adaptive_avg_pool2d`` itself on a channels-last view of the input in
f32: each bin is summed directly (no cumsum, whose running total loses the
small differences), in f32 whatever the activation dtype, and rounded once
to it.  The JAX form in bf16 runs its cumsum in bf16 and is off by whole
units (``ROADMAP.md`` section 3), so the port does not follow it there.

``resize(x, size, method)`` reproduces ``jax.image.resize``'s weights:
half-pixel centres, the triangle ("linear") or the Keys cubic kernel with
a = -0.5 ("cubic"), the kernel widened by the scale when it downsamples
(antialiasing), weights renormalised per output sample.  PyTorch's own
``interpolate`` differs (bicubic uses a = -0.75, and antialiasing is
opt-in), so the two 1-D weight matrices are built in numpy, cached per
(sizes, method, device, dtype), and applied as one contraction per axis.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., H_out, W_out, C), averaged in f32 and
    rounded once to ``x.dtype``; ``x`` itself where the size is unchanged."""
    h_out, w_out = output_size
    *lead, h, w, c = x.shape
    if (h, w) == (h_out, w_out):
        return x
    z = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    y = F.adaptive_avg_pool2d(z, (h_out, w_out)).to(x.dtype)
    return y.permute(0, 2, 3, 1).reshape(*lead, h_out, w_out, c)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) f32 weight matrix of a 1-D resize."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)  # low-pass when downsampling
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    weights = _KERNELS[method](x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=128)
def _cached_weights(in_size, out_size, method, device, dtype) -> torch.Tensor:
    # An ordinary tensor even when first built under inference_mode (the
    # cache outlives that call).
    with torch.inference_mode(False):
        return torch.from_numpy(resize_weights(in_size, out_size, method)).to(device, dtype)


def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """(..., H, W, C) -> (..., H_out, W_out, C); an axis whose size does not
    change is left alone."""
    h_out, w_out = size
    h, w = x.shape[-3], x.shape[-2]
    if h != h_out:
        x = torch.einsum("...hwc,hk->...kwc", x, _cached_weights(h, h_out, method, x.device, x.dtype))
    if w != w_out:
        x = torch.einsum("...hwc,wk->...hkc", x, _cached_weights(w, w_out, method, x.device, x.dtype))
    return x


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres."""
    return resize(x, size, "linear")
