"""UNO baseline: U-shaped Neural Operator (counterpart of
``tante_tpu/models/uno.py``).

sin/cos grid features appended to the T-folded input, Linear lift 16 ->
width, seven operator blocks (resolution-changing spectral conv +
bicubic-resampled 1x1 conv) in an encoder--bottleneck--decoder with
channel-concat skips at fixed fractions D/4..D/32 of the input resolution,
Linear projection back, one frame out.

The UNO spectral conv changes the spatial resolution in Fourier space
("forward"-normalized transforms, so amplitudes rescale with the grid): the
inverse partial DFT is simply built for the output grid.  Mode counts are
clamped to what the input and output grids can hold.  The two H-frequency
corners have a weight each, so a spectral conv is two calls of the
mode-mixing kernel (``ops/fused_spectral.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.common import TorchDense
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.pooling import resize
from tante_tpu_torch.ops.spectral import (
    _partial_irdft2,
    _partial_rdft2,
    dft_mats,
    mix_modes,
    mix_modes_complex,
)


def uno_spectral_conv(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      out_hw: Tuple[int, int], dft: bool = True) -> torch.Tensor:
    """Resolution-changing spectral conv, channels-last.

    x: (B, H, W, Cin); w1/w2: (Cin, Cout, m1, m2, 2) for the positive /
    negative H-frequency rows; returns (B, H_out, W_out, Cout)."""
    h_out, w_out = out_hw
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    wf_out = w_out // 2 + 1
    m1 = min(w1.shape[2], h // 2, h_out // 2)
    m2 = min(w1.shape[3], w // 2 + 1, wf_out)
    crop = (slice(0, m1), slice(0, m2))
    if dft and m1 > 0 and m2 > 0:
        # The inverse matrices are built for the OUTPUT resolution, which
        # makes the resolution change free.
        mats = dft_mats(x, h, w, m1, m1, m2, norm="forward", h_out=h_out, w_out=w_out)
        xr, xi = _partial_rdft2(x, mats)
        top = mix_modes(xr[:, :m1], xi[:, :m1], w1, crop)
        bot = mix_modes(xr[:, m1:], xi[:, m1:], w2, crop)
        return _partial_irdft2(torch.cat([top[0], bot[0]], dim=1),
                               torch.cat([top[1], bot[1]], dim=1), mats)

    x_ft = torch.fft.rfft2(x.float(), dim=(1, 2), norm="forward")
    y_ft = torch.zeros((b, h_out, wf_out, w1.shape[1]), dtype=x_ft.dtype, device=x.device)
    # A degenerate level (a 1-pixel grid keeps no mode) contributes nothing
    # spectrally; the block's pointwise path still carries the signal.
    if m1 > 0 and m2 > 0:
        y_ft[:, :m1, :m2] = mix_modes_complex(x_ft[:, :m1, :m2], w1, crop)
        y_ft[:, -m1:, :m2] = mix_modes_complex(x_ft[:, -m1:, :m2], w2, crop)
    return torch.fft.irfft2(y_ft, s=(h_out, w_out), dim=(1, 2), norm="forward")


def bicubic_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, H_out, W_out, C) cubic resize with the JAX
    package's weights (Keys a = -0.5, half-pixel centres, antialiased when
    it downsamples): ``ops/pooling.py``."""
    return resize(x, out_hw, "cubic")


class _PointwiseConv(nn.Module):
    """flax ``nn.Conv`` 1x1 with its default init (lecun normal, not
    truncated here; zero bias): kernel (1, 1, Cin, Cout), bias (Cout,)."""

    def __init__(self, c_in: int, c_out: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.randn((1, 1, c_in, c_out), generator=gen) / max(c_in, 1) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(c_out))


class UNOOperatorBlock(nn.Module):
    mode_space_params = ("weights1", "weights2")  # stay f32 when a model is cast for serving

    def __init__(self, c_in: int, out_codim: int, modes1: int, modes2: int, non_lin: bool = True,
                 dtype=torch.float32, gen=None):
        super().__init__()
        self.non_lin, self.dtype = non_lin, dtype
        scale = (1.0 / (2 * c_in)) ** 0.5 / 2**0.5
        shape = (c_in, out_codim, modes1, modes2, 2)
        self.weights1 = nn.Parameter(torch.randn(shape, generator=gen) * scale)
        self.weights2 = nn.Parameter(torch.randn(shape, generator=gen) * scale)
        self.Conv_0 = _PointwiseConv(c_in, out_codim, gen)

    def forward(self, x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
        y_spec = uno_spectral_conv(x, self.weights1, self.weights2, out_hw).to(x.dtype)
        dt = self.dtype
        y_pw = x.to(dt) @ self.Conv_0.kernel[0, 0].to(dt) + self.Conv_0.bias.to(dt)
        y = y_spec + bicubic_resize(y_pw.float(), out_hw).to(x.dtype)
        return gelu(y) if self.non_lin else y


class UNO(nn.Module):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        width: int = 32,
        pad: int = 0,
        factor: int = 1,
        output_length: int = 1,
        dtype=torch.float32,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        c = dset_metadata.n_fields if dset_metadata else 4
        self.in_T, self.pad, self.output_length, self.dtype = in_T, pad, output_length, dtype
        f, wd = factor, width
        self.TorchDense_0 = TorchDense(in_T * c + 4, 16, dtype, gen)
        self.TorchDense_1 = TorchDense(16, wd, dtype, gen)

        def block(c_in, cod, m1, m2):
            return UNOOperatorBlock(c_in, cod, m1, m2, dtype=dtype, gen=gen)

        self.L0 = block(wd, 2 * f * wd, 32, 33)
        self.L1 = block(2 * f * wd, 4 * f * wd, 8, 9)
        self.L2 = block(4 * f * wd, 8 * f * wd, 4, 5)
        self.L3 = block(8 * f * wd, 8 * f * wd, 4, 5)
        self.L4 = block(8 * f * wd, 4 * f * wd, 4, 5)
        self.L5 = block(8 * f * wd, 2 * f * wd, 8, 9)   # input: L4 ++ L1
        self.L6 = block(4 * f * wd, wd, 32, 32)          # input: L5 ++ L0
        self.TorchDense_2 = TorchDense(2 * wd, 3 * wd, dtype, gen)  # input: L6 ++ lift
        self.TorchDense_3 = TorchDense(3 * wd + 16, c, dtype, gen)
        self.to(dev)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, 1, H, W, C)."""
        b, t, h, w, c = x.shape
        z = x.movedim(1, -2).reshape(b, h, w, t * c)

        # sin/cos grid features
        gx = torch.linspace(0, 2 * torch.pi, h, device=x.device)[None, :, None, None]
        gy = torch.linspace(0, 2 * torch.pi, w, device=x.device)[None, None, :, None]
        grid = torch.cat([g.expand(b, h, w, 1) for g in
                          (torch.sin(gx), torch.sin(gy), torch.cos(gx), torch.cos(gy))], dim=-1)
        z = torch.cat([z, grid.to(z.dtype)], dim=-1)

        z_fc = gelu(self.TorchDense_0(z))
        z0 = gelu(self.TorchDense_1(z_fc))
        if self.pad:
            z0 = F.pad(z0, (0, 0, self.pad, self.pad, self.pad, self.pad))
        d1, d2 = z0.shape[1], z0.shape[2]

        c0 = self.L0(z0, (d1 // 4, d2 // 4))
        c1 = self.L1(c0, (d1 // 16, d2 // 16))
        c2 = self.L2(c1, (d1 // 32, d2 // 32))
        c3 = self.L3(c2, (d1 // 32, d2 // 32))
        c4 = torch.cat([self.L4(c3, (d1 // 16, d2 // 16)), c1], dim=-1)
        c5 = torch.cat([self.L5(c4, (d1 // 4, d2 // 4)), c0], dim=-1)
        c6 = torch.cat([self.L6(c5, (d1, d2)), z0], dim=-1)
        if self.pad:
            c6 = c6[:, self.pad:-self.pad, self.pad:-self.pad, :]

        y = gelu(self.TorchDense_2(c6))
        y = self.TorchDense_3(torch.cat([y, z_fc], dim=-1))
        return y[:, None]
