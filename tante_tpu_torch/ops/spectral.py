"""Spectral (Fourier) convolution ops, channels-last (counterpart of
``tante_tpu/ops/spectral.py``).

The FNO primitive: real FFT (ortho) -> complex channel mixing on the kept
low modes -> inverse FFT.  Two routes to mode space, as in the JAX package:

- the partial DFT (``dft=True``, the default): only the kept modes are
  computed, as dense DFT matmuls over the W and then the H axis, and the
  inverse expands them straight to the output grid;
- the FFT route (``torch.fft``): taken when the kept corners overlap
  (``2*m1 > h``), when no mode is kept, by the 3-D convolution, and on
  request (``dft=False``).

Both are plain PyTorch.  The channel mixing in between always goes through
``ops/fused_spectral.py:spectral_mode_matmul``: the hand-written CUDA kernel
on the card, four real einsums on the CPU.  The weight reaches it as stored,
``(Cin, Cout, *modes, 2)`` real with a trailing [re, im] axis, through a
permuted view: it is never transposed, cropped into a copy or duplicated.

dtype gate (the JAX package's): under bf16 compute only the two field-sized
contractions (over W) run with bf16 operands, mode space is f32 throughout
and the spectral weights stay f32; f32 input is f32 everywhere.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from tante_tpu_torch.ops.convs import _ConvParams
from tante_tpu_torch.ops.fused_spectral import spectral_mode_matmul
from tante_tpu_torch.ops.initializers import complex_spectral_init


def _partial_rdft_mats(h: int, w: int, m1_pos: int, m1_neg: int, m2r: int,
                       norm: str = "ortho", h_out: int | None = None,
                       w_out: int | None = None) -> tuple:
    """DFT matrices (numpy f32) for the kept-mode set: H-rows [0..m1_pos) and
    the m1_neg highest (negative) frequencies, rfft W-columns [0..m2r).  The
    inverse W matrices fold the hermitian-completion factor c_l (1 for l=0
    and the Nyquist column, else 2), so

        fwd(x)  == rfft2(x, norm)[kept modes]
        inv(y)  == irfft2(zero-pad(y), s=(h_out, w_out), norm)

    up to f32 rounding.  ``h_out``/``w_out`` default to the input size; a
    different output size gives the resolution-changing spectral conv (UNO):
    negative frequencies keep their index-from-end position.  Returns
    (fw_cos, fw_sin, fh_cos, fh_sin, iw_cos, iw_sin, ih_cos, ih_sin)."""
    h_out = h if h_out is None else h_out
    w_out = w if w_out is None else w_out
    ks_in = np.concatenate([np.arange(m1_pos), np.arange(h - m1_neg, h)])
    ks_out = np.concatenate([np.arange(m1_pos), np.arange(h_out - m1_neg, h_out)])
    ls = np.arange(m2r)
    wn = np.arange(w)[:, None] * ls[None, :] * (2.0 * np.pi / w)
    hn = np.arange(h)[:, None] * ks_in[None, :] * (2.0 * np.pi / h)
    wn_o = np.arange(w_out)[:, None] * ls[None, :] * (2.0 * np.pi / w_out)
    hn_o = np.arange(h_out)[:, None] * ks_out[None, :] * (2.0 * np.pi / h_out)
    if norm == "ortho":
        fsw, fsh = np.sqrt(w), np.sqrt(h)
        isw, ish = np.sqrt(w_out), np.sqrt(h_out)
    elif norm == "forward":  # rfft2 scales by 1/N, irfft2 by 1
        fsw, fsh = w, h
        isw, ish = 1.0, 1.0
    else:
        raise ValueError(norm)
    fw_cos, fw_sin = np.cos(wn) / fsw, np.sin(wn) / fsw  # (w, m2r)
    fh_cos, fh_sin = np.cos(hn) / fsh, np.sin(hn) / fsh  # (h, K)
    c = np.full(m2r, 2.0)
    c[0] = 1.0
    if w_out % 2 == 0 and m2r - 1 == w_out // 2:
        c[-1] = 1.0
    iw_cos = (np.cos(wn_o) * c[None, :]).T / isw  # (m2r, w_out)
    iw_sin = (np.sin(wn_o) * c[None, :]).T / isw
    ih_cos, ih_sin = np.cos(hn_o).T / ish, np.sin(hn_o).T / ish  # (K, h_out)
    return tuple(np.asarray(a, np.float32) for a in (
        fw_cos, fw_sin, fh_cos, fh_sin, iw_cos, iw_sin, ih_cos, ih_sin))


class DftMats(NamedTuple):
    """The partial DFT's constants on a device.  ``fw`` = [cos, -sin] (W,
    2*m2r) and ``iw`` = [cos; sin] (2*m2r, W_out) touch the field and carry
    its dtype; the H matrices act in mode space and are f32."""

    fw: torch.Tensor
    fh_cos: torch.Tensor
    fh_sin: torch.Tensor
    iw: torch.Tensor
    ih_cos: torch.Tensor
    ih_sin: torch.Tensor
    m2r: int


@functools.lru_cache(maxsize=128)
def _cached_mats(h, w, m1_pos, m1_neg, m2r, norm, h_out, w_out, device, dtype) -> DftMats:
    fw_cos, fw_sin, fh_cos, fh_sin, iw_cos, iw_sin, ih_cos, ih_sin = _partial_rdft_mats(
        h, w, m1_pos, m1_neg, m2r, norm, h_out, w_out)
    # One dot for both legs of each field-sized pass: the t_im sign is folded
    # into the constants (exact).
    fw = np.concatenate([fw_cos, -fw_sin], axis=1)
    iw = np.concatenate([iw_cos, iw_sin], axis=0)
    # Ordinary tensors even when first asked for under inference_mode: the
    # cache outlives that call and a training step may use them next.
    with torch.inference_mode(False):
        def dev(a, dt=torch.float32):
            return torch.from_numpy(a).to(device, dt)

        return DftMats(dev(fw, dtype), dev(fh_cos), dev(fh_sin), dev(iw, dtype),
                       dev(ih_cos), dev(ih_sin), m2r)


def dft_mats(x: torch.Tensor, h: int, w: int, m1_pos: int, m1_neg: int, m2r: int,
             norm: str = "ortho", h_out: int | None = None,
             w_out: int | None = None) -> DftMats:
    """The constants for field ``x``, built once per (geometry, device,
    field dtype): in eager PyTorch building them per call would be a float64
    host computation and a host-to-device copy in every spectral layer."""
    dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    return _cached_mats(h, w, m1_pos, m1_neg, m2r, norm, h if h_out is None else h_out,
                        w if w_out is None else w_out, x.device, dtype)


def _field(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.bfloat16 else x.float()


def _partial_rdft2(x: torch.Tensor, mats: DftMats):
    """(B, H, W, C) real -> kept-mode (re, im), each (B, K, m2r, C) f32.
    Under bf16 the W contraction reads the field as bf16 (f32 accumulation
    inside the matmul, bf16 out) and only the small result goes to f32."""
    m2r = mats.m2r
    t = torch.einsum("bhwc,wl->bhlc", _field(x), mats.fw).float()
    t_re, t_im = t[:, :, :m2r], t[:, :, m2r:]
    # e^{-i theta}(a + ib) = (a cos + b sin) + i(b cos - a sin)
    xr = (torch.einsum("bhlc,hk->bklc", t_re, mats.fh_cos)
          + torch.einsum("bhlc,hk->bklc", t_im, mats.fh_sin))
    xi = (torch.einsum("bhlc,hk->bklc", t_im, mats.fh_cos)
          - torch.einsum("bhlc,hk->bklc", t_re, mats.fh_sin))
    return xr, xi


def _partial_irdft2(yr: torch.Tensor, yi: torch.Tensor, mats: DftMats) -> torch.Tensor:
    """Kept-mode (re, im) (B, K, m2r, C) -> (B, H, W, C) in the field dtype
    the constants were built for: the H expansion in f32, then the W expansion
    as one dot of [z_re, -z_im] against [cos; sin] (bf16 operands and a bf16
    result for a bf16 field)."""
    z_re = (torch.einsum("bklc,kh->bhlc", yr, mats.ih_cos)
            - torch.einsum("bklc,kh->bhlc", yi, mats.ih_sin))
    z_im = (torch.einsum("bklc,kh->bhlc", yr, mats.ih_sin)
            + torch.einsum("bklc,kh->bhlc", yi, mats.ih_cos))
    z = torch.cat([z_re, -z_im], dim=-2)  # (B, H, 2*m2r, C)
    return torch.einsum("bhlc,lw->bhwc", z.to(mats.iw.dtype), mats.iw)


def mix_modes(xr: torch.Tensor, xi: torch.Tensor, weight: torch.Tensor,
              crop: Sequence[slice]):
    """Channel mixing of kept modes: x_* (B, *modes, Cin) f32 against the
    stored weight (Cin, Cout, *modes_full, 2) cropped by ``crop`` (one slice
    per mode axis), seen as (*modes, Cin, Cout) views of its re and im
    halves.  -> (re, im), each (B, *modes, Cout)."""
    w = weight.float()[(slice(None), slice(None), *crop)]
    n = len(crop)
    perm = (*range(2, 2 + n), 0, 1)
    return spectral_mode_matmul(xr, xi, w[..., 0].permute(perm), w[..., 1].permute(perm))


def mix_modes_complex(block: torch.Tensor, weight: torch.Tensor, crop: Sequence[slice]):
    """``mix_modes`` on a complex (B, *modes, Cin) slice of an FFT."""
    return torch.complex(*mix_modes(block.real, block.imag, weight, crop))


def spectral_conv2d(x: torch.Tensor, weight: torch.Tensor, modes1: int, modes2: int,
                    dft: bool = True) -> torch.Tensor:
    """Truncated-mode spectral convolution: the top and bottom ``m1`` rows
    and low ``m2`` columns of the rfft2 spectrum, one weight for both corners.

    x: (B, H, W, Cin) real; weight: (Cin, Cout, m1, m2, 2) real ([re, im]).
    Returns (B, H, W, Cout): f32 under f32 input, bf16 under bf16."""
    b, h, w = x.shape[0], x.shape[-3], x.shape[-2]
    m1 = min(modes1, h)
    m2 = min(modes2, w // 2 + 1)
    c_out = weight.shape[1]
    crop = (slice(0, m1), slice(0, m2))
    if dft and m1 > 0 and m2 > 0 and 2 * m1 <= h:  # disjoint top/bottom corners
        mats = dft_mats(x, h, w, m1, m1, m2)
        xr, xi = _partial_rdft2(x, mats)
        # Both corners share the weight: they go into the batch, (2B, m1, m2, C).
        o_re, o_im = mix_modes(xr.reshape(2 * b, m1, m2, -1), xi.reshape(2 * b, m1, m2, -1),
                               weight, crop)
        return _partial_irdft2(o_re.reshape(b, 2 * m1, m2, c_out),
                               o_im.reshape(b, 2 * m1, m2, c_out), mats)

    x_ft = torch.fft.rfft2(x.float(), dim=(-3, -2), norm="ortho")  # (B, H, Wf, Cin)
    y_ft = torch.zeros((b, h, x_ft.shape[-2], c_out), dtype=x_ft.dtype, device=x.device)
    if m1 > 0 and m2 > 0:
        corners = torch.cat([x_ft[:, :m1, :m2], x_ft[:, -m1:, :m2]], dim=0)  # (2B, m1, m2, Cin)
        out = mix_modes_complex(corners, weight, crop)
        y_ft[:, :m1, :m2] = out[:b]
        y_ft[:, -m1:, :m2] = out[b:]
    return torch.fft.irfft2(y_ft, s=(h, w), dim=(-3, -2), norm="ortho")


def _centered(modes1: int, modes2: int, h: int, w: int):
    """Kept-mode counts of the centered selection: ``ceil(m1/2)`` lowest
    positive and ``floor(m1/2)`` lowest negative H-frequencies, the first
    ``m2//2 + 1`` rfft columns."""
    m1 = min(modes1, h)
    m2r = min(modes2 // 2 + 1, w // 2 + 1)
    m1_pos = (m1 + 1) // 2
    return m1, m1_pos, m1 - m1_pos, m2r


def spectral_conv2d_centered(x: torch.Tensor, weight: torch.Tensor, modes1: int, modes2: int,
                             dft: bool = True) -> torch.Tensor:
    """Centered-mode spectral convolution (neuralop-style selection): ONE
    weight tensor covers all ``m1 * m2r`` kept modes, rows ordered [positive
    block, negative block].

    x: (B, H, W, Cin); weight: (Cin, Cout, m1, m2r, 2). Returns (B, H, W, Cout)."""
    b, h, w = x.shape[0], x.shape[-3], x.shape[-2]
    m1, m1_pos, m1_neg, m2r = _centered(modes1, modes2, h, w)
    crop = (slice(None), slice(0, m2r))
    if dft and m1 > 0 and m2r > 0:
        mats = dft_mats(x, h, w, m1_pos, m1_neg, m2r)
        xr, xi = _partial_rdft2(x, mats)
        o_re, o_im = mix_modes(xr, xi, weight, crop)
        return _partial_irdft2(o_re, o_im, mats)

    x_ft = torch.fft.rfft2(x.float(), dim=(-3, -2), norm="ortho")
    y_ft = torch.zeros((b, h, x_ft.shape[-2], weight.shape[1]), dtype=x_ft.dtype,
                       device=x.device)
    if m1 > 0 and m2r > 0:
        # Positive rows then negative rows: the weight's own row order.
        rows = [x_ft[:, :m1_pos, :m2r]] + ([x_ft[:, h - m1_neg:, :m2r]] if m1_neg else [])
        out = mix_modes_complex(torch.cat(rows, dim=1), weight, crop)
        y_ft[:, :m1_pos, :m2r] = out[:, :m1_pos]
        if m1_neg:
            y_ft[:, h - m1_neg:, :m2r] = out[:, m1_pos:]
    return torch.fft.irfft2(y_ft, s=(h, w), dim=(-3, -2), norm="ortho")


def spectral_conv2d_centered_cw(x: torch.Tensor, weight: torch.Tensor, modes1: int,
                                modes2: int) -> torch.Tensor:
    """``spectral_conv2d_centered`` for the channel-major layout.

    x: (B, H, Cin, W); weight: (Cin, Cout, m1, m2r, 2), the SAME tensor as
    the channels-last path.  Returns (B, H, Cout, W).  W is the contiguous
    axis of every field tensor here, so both field-sized contractions are
    plain matmuls over the last axis with no transposing copy.  Partial DFT
    only (no FFT route), as in the JAX package."""
    h, w = x.shape[1], x.shape[-1]
    m1, m1_pos, m1_neg, m2r = _centered(modes1, modes2, h, w)
    if not (m1 > 0 and m2r > 0):
        raise ValueError(f"cw layout requires kept modes within range: {m1}, {m2r}")
    mats = dft_mats(x, h, w, m1_pos, m1_neg, m2r)
    t = torch.einsum("bhcw,wl->bhcl", _field(x), mats.fw).float()
    t_re, t_im = t[..., :m2r], t[..., m2r:]
    xr = (torch.einsum("bhcl,hk->bkcl", t_re, mats.fh_cos)
          + torch.einsum("bhcl,hk->bkcl", t_im, mats.fh_sin))
    xi = (torch.einsum("bhcl,hk->bkcl", t_im, mats.fh_cos)
          - torch.einsum("bhcl,hk->bkcl", t_re, mats.fh_sin))
    # (B, K, C, L) seen as (B, K, L, C); the result comes back in the same
    # memory order, i.e. (B, K, Cout, L) after the permute.
    o_re, o_im = (o.permute(0, 1, 3, 2) for o in mix_modes(
        xr.permute(0, 1, 3, 2), xi.permute(0, 1, 3, 2), weight, (slice(None), slice(0, m2r))))
    z_re = (torch.einsum("bkol,kh->bhol", o_re, mats.ih_cos)
            - torch.einsum("bkol,kh->bhol", o_im, mats.ih_sin))
    z_im = (torch.einsum("bkol,kh->bhol", o_re, mats.ih_sin)
            + torch.einsum("bkol,kh->bhol", o_im, mats.ih_cos))
    z = torch.cat([z_re, -z_im], dim=-1)  # (B, H, Cout, 2*m2r)
    return torch.einsum("bhol,lw->bhow", z.to(mats.iw.dtype), mats.iw)


def spectral_conv3d_centered(x: torch.Tensor, weight: torch.Tensor, modes1: int, modes2: int,
                             modes3: int) -> torch.Tensor:
    """Centered-mode 3-D spectral convolution: rfftn over (D, H, W), the
    centered ``m1``/``m2`` frequencies of the two full axes and the first
    ``m3r = m3//2 + 1`` one-sided W columns, one weight tensor over all kept
    modes; each of the (up to) four corners is one mode-mixing call.

    x: (B, D, H, W, Cin); weight: (Cin, Cout, m1, m2, m3r, 2).
    Returns (B, D, H, W, Cout)."""
    d, h, w = x.shape[1:4]
    x_ft = torch.fft.rfftn(x, dim=(1, 2, 3), norm="ortho")  # (B, D, H, Wf, Cin)
    wf = x_ft.shape[3]
    m1, m2 = min(modes1, d), min(modes2, h)
    m3r = min(modes3 // 2 + 1, wf)
    m1p, m2p = (m1 + 1) // 2, (m2 + 1) // 2
    m1n, m2n = m1 - m1p, m2 - m2p
    y_ft = torch.zeros((x.shape[0], d, h, wf, weight.shape[1]), dtype=x_ft.dtype,
                       device=x.device)
    # (spectrum rows, weight rows) of the positive and negative frequencies.
    corners_d = [(slice(0, m1p), slice(0, m1p))] + (
        [(slice(d - m1n, d), slice(m1p, m1))] if m1n else [])
    corners_h = [(slice(0, m2p), slice(0, m2p))] + (
        [(slice(h - m2n, h), slice(m2p, m2))] if m2n else [])
    for sl1, wsl1 in corners_d:
        for sl2, wsl2 in corners_h:
            y_ft[:, sl1, sl2, :m3r] = mix_modes_complex(
                x_ft[:, sl1, sl2, :m3r], weight, (wsl1, wsl2, slice(0, m3r)))
    return torch.fft.irfftn(y_ft, s=(d, h, w), dim=(1, 2, 3), norm="ortho")


class SpectralLayer(nn.Module):
    """Spectral conv + 1x1 conv residual.  Parameters: ``weight`` (Cin, Cout,
    m1, m2, 2) and ``w0`` (flax ``nn.Conv`` 1x1: kernel (1, 1, Cin, Cout),
    bias (Cout,))."""

    mode_space_params = ("weight",)  # stay f32 when a model is cast for serving

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 dtype=torch.float32, gen=None):
        super().__init__()
        self.in_channels = in_channels
        self.modes1, self.modes2 = modes1, modes2
        self.dtype = dtype
        self.weight = nn.Parameter(complex_spectral_init(
            (in_channels, out_channels, modes1, modes2, 2), in_channels, out_channels, gen))
        self.w0 = _ConvParams(1, in_channels, out_channels, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} channels, got {x.shape[-1]}")
        y = spectral_conv2d(x, self.weight, self.modes1, self.modes2)
        dt = self.dtype
        s = x.to(dt) @ self.w0.kernel[0, 0].to(dt) + self.w0.bias.to(dt)
        return s + y.to(s.dtype)
