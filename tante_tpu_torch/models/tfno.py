"""TFNO baseline: Tucker-factorized Fourier Neural Operator (counterpart of
``tante_tpu/models/tfno.py``).

The spectral weight of each layer is stored in Tucker form,

  W[ci, co, i, j] = sum_{a,b,c,d} G[a,b,c,d] U0[ci,a] U1[co,b] U2[i,c] U3[j,d]

with complex core and factors kept as real tensors with a trailing [re, im]
axis.  The full weight is rebuilt on every layer call (complex einsums,
small beside the DFT) and fed as re / im into the same centered-mode
spectral convolution as FNO, so TFNO shares FNO's compute path, the
mode-mixing kernel included, and only changes the parameterization.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.fno import _FoldedFrames, _SpectralBlock
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.spectral import (
    spectral_conv2d_centered,
    spectral_conv2d_centered_cw,
)


def _tucker_ranks(shape: Sequence[int], rank: float) -> tuple:
    return tuple(max(1, int(round(rank * s))) for s in shape)


class TuckerSpectralWeight(nn.Module):
    """Complex Tucker-factorized (Cin, Cout, m1, m2r) spectral weight."""

    mode_space_params = ("core", "factor_0", "factor_1", "factor_2", "factor_3")

    def __init__(self, shape: Sequence[int], rank: float = 0.5, gen=None):
        super().__init__()
        ranks = _tucker_ranks(shape, rank)
        # The dense init's variance 1/(Cin*Cout), spread over the core and
        # the 4 factors: a product of 5 independent entries ~ N(0, s^2)
        # summed over prod(ranks) terms has std ~ s^5 * sqrt(prod(ranks)).
        target_std = (1.0 / (shape[0] * shape[1])) ** 0.5
        s = (target_std / math.sqrt(max(1, math.prod(ranks)))) ** (1.0 / (len(shape) + 1))

        def init(*dims):
            return nn.Parameter(torch.randn(dims, generator=gen) * (s / 2**0.5))

        self.core = init(*ranks, 2)
        for i, (dim, r) in enumerate(zip(shape, ranks)):
            setattr(self, f"factor_{i}", init(dim, r, 2))

    def forward(self) -> torch.Tensor:
        """The dense weight (Cin, Cout, m1, m2r, 2), f32."""
        cplx = lambda a: torch.view_as_complex(a.float().contiguous())  # noqa: E731
        w = cplx(self.core)
        w = torch.einsum("abcd,ia->ibcd", w, cplx(self.factor_0))
        w = torch.einsum("ibcd,ob->iocd", w, cplx(self.factor_1))
        w = torch.einsum("iocd,mc->iomd", w, cplx(self.factor_2))
        w = torch.einsum("iomd,nd->iomn", w, cplx(self.factor_3))
        return torch.view_as_real(w)


class TFNOBlock(_SpectralBlock):
    def __init__(self, hidden: int, modes1: int, modes2: int, rank: float = 0.5,
                 last: bool = False, dtype=torch.float32, cw: bool = False, gen=None):
        super().__init__()
        self.modes = (modes1, modes2)
        self.last, self.cw, self.dtype = last, cw, dtype
        self.TuckerSpectralWeight_0 = TuckerSpectralWeight(
            (hidden, hidden, modes1, modes2 // 2 + 1), rank, gen)
        self._make_mlp(hidden, dtype, gen, cw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = spectral_conv2d_centered_cw if self.cw else spectral_conv2d_centered
        return self._mix(x, conv(x, self.TuckerSpectralWeight_0(), *self.modes))


class TFNO(_FoldedFrames):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        modes1: int = 16,
        modes2: int = 16,
        modes3: int = 16,
        hidden_channels: int = 64,
        n_layers: int = 4,
        rank: float = 0.5,
        gradient_checkpointing: bool = False,
        output_length: int = 1,
        dtype=torch.float32,
        layout: str = "cw",
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        if layout not in ("cw", "wc"):
            raise ValueError(f"Unknown layout '{layout}'")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        n_fields = dset_metadata.n_fields if dset_metadata else 4
        self.in_T = in_T
        self.output_length = output_length
        self.gradient_checkpointing = gradient_checkpointing
        self.dtype = dtype
        self.cw = layout == "cw"
        self._make_trunk(in_T * n_fields, n_fields, hidden_channels, dtype, gen, self.cw)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"TFNOBlock_{i}", TFNOBlock(
                hidden_channels, modes1, modes2, rank, last=(i == n_layers - 1), dtype=dtype,
                cw=self.cw, gen=gen))
        self.to(dev)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, 1, H, W, C)."""
        blocks = [getattr(self, f"TFNOBlock_{i}") for i in range(self.n_layers)]
        return self._trunk(x, blocks, self.cw)
