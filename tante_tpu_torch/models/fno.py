"""FNO baseline (counterpart of ``tante_tpu/models/fno.py``).

The T input frames fold into channels, then

  lifting: 1x1 MLP C_in -> 2h -> h
  n_layers x [centered-mode spectral conv + linear 1x1 skip, gelu,
              channel MLP (h -> h/2 -> h) + soft-gating skip, gelu*]
  projection: 1x1 MLP h -> 2h -> C_out          (*no gelu after last block)

and one frame comes out.  Every 1x1 conv is a Dense over the channel axis.
Two internal layouts with identical parameters: ``"cw"`` (default; 2-D
only) keeps fields as (B, H, C, W), so the two field-sized DFT contractions
run over the contiguous last axis with no transposing copy; ``"wc"`` is
channels-last and also carries the 3-D path.  The spectral convolutions'
channel mixing runs through ``ops/fused_spectral.py`` in both.

``sp_mesh`` (a ``parallel.Mesh`` with an 'sp' axis) shards H: every rank
holds a contiguous block of rows, the spectral convolutions run the
H-sharded partial DFT with one all-reduce each
(``parallel/halo.py:sharded_spectral_conv2d_centered``, f32), and every other
op is pointwise over H.  It forces the channels-last layout (2-D only), as in
the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.common import TorchDense
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.initializers import complex_spectral_init
from tante_tpu_torch.ops.spectral import (
    spectral_conv2d_centered,
    spectral_conv2d_centered_cw,
    spectral_conv3d_centered,
)
from tante_tpu_torch.parallel.halo import sharded_spectral_conv2d_centered


class SoftGate(nn.Module):
    """Per-channel learned scale + bias (neuralop's 'soft-gating' skip);
    ``cw=True`` broadcasts over axis -2.  The parameters are cast to the
    field dtype, so a bf16 field stays bf16."""

    seed_rules = {"weight": "gain"}

    def __init__(self, channels: int, cw: bool = False):
        super().__init__()
        self.cw = cw
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.cw:
            return x * w[:, None] + b[:, None]
        return x * w + b


class _SpectralBlock(nn.Module):
    """What FNOBlock and TFNOBlock share: the spectral conv's result ``y``
    goes through the linear skip, the channel MLP and the soft gate."""

    def _make_mlp(self, hidden: int, dtype, gen, cw: bool):
        self.TorchDense_0 = TorchDense(hidden, hidden, dtype, gen, cw=cw)  # linear fno skip
        self.TorchDense_1 = TorchDense(hidden, hidden // 2, dtype, gen, cw=cw)
        self.TorchDense_2 = TorchDense(hidden // 2, hidden, dtype, gen, cw=cw)
        self.SoftGate_0 = SoftGate(hidden, cw=cw)

    def _mix(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        y = gelu(y.to(x.dtype) + self.TorchDense_0(x))
        z = self.TorchDense_2(gelu(self.TorchDense_1(y)))
        y = z + self.SoftGate_0(y)
        return y if self.last else gelu(y)


class FNOBlock(_SpectralBlock):
    """One FNO layer, 2-D (either layout) or 3-D (channels-last, ``dims=3``)."""

    mode_space_params = ("spectral_weight",)  # stay f32 when a model is cast for serving

    def __init__(self, hidden: int, modes1: int, modes2: int, modes3: int = 16,
                 last: bool = False, dtype=torch.float32, cw: bool = False, dims: int = 2,
                 gen=None):
        super().__init__()
        if cw and dims != 2:
            raise ValueError("the cw layout is 2-D only")
        self.modes = (modes1, modes2, modes3)[:dims]
        self.last, self.cw, self.dtype = last, cw, dtype
        self.sp_mesh = None  # FNO.set_sp_mesh
        kept = (*self.modes[:-1], self.modes[-1] // 2 + 1)
        self.spectral_weight = nn.Parameter(complex_spectral_init(
            (hidden, hidden, *kept, 2), hidden, hidden, gen))
        self._make_mlp(hidden, dtype, gen, cw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.spectral_weight
        if self.cw:
            y = spectral_conv2d_centered_cw(x, w, *self.modes)
        elif len(self.modes) == 3:
            if x.ndim != 5:
                raise ValueError(f"3-D block expects (B, D, H, W, C), got {tuple(x.shape)}")
            y = spectral_conv3d_centered(x.float(), w, *self.modes)
        elif self.sp_mesh is not None:  # this rank's H rows
            y = sharded_spectral_conv2d_centered(self.sp_mesh, x.float(), w, *self.modes)
        else:
            y = spectral_conv2d_centered(x, w, *self.modes)
        return self._mix(x, y)


class _FoldedFrames(nn.Module):
    """Shared trunk of FNO and TFNO: fold T into channels, lift, run
    ``blocks``, project to one frame."""

    def _make_trunk(self, c_in: int, c_out: int, hidden: int, dtype, gen, cw: bool):
        self.TorchDense_0 = TorchDense(c_in, hidden * 2, dtype, gen, cw=cw)
        self.TorchDense_1 = TorchDense(hidden * 2, hidden, dtype, gen, cw=cw)
        self.TorchDense_2 = TorchDense(hidden, hidden * 2, dtype, gen, cw=cw)
        self.TorchDense_3 = TorchDense(hidden * 2, c_out, dtype, gen, cw=cw)

    def _trunk(self, x: torch.Tensor, blocks, cw: bool) -> torch.Tensor:
        b, t, c = x.shape[0], x.shape[1], x.shape[-1]
        spatial = x.shape[2:-1]
        z = x.movedim(1, -2).reshape(b, *spatial, t * c)  # fold T into channels
        if cw:
            z = z.transpose(-1, -2)  # (B, H, TC, W): one small transpose
        z = self.TorchDense_1(gelu(self.TorchDense_0(z)))
        for block in blocks:
            if self.gradient_checkpointing and torch.is_grad_enabled():
                z = checkpoint(block, z, use_reentrant=False)
            else:
                z = block(z)
        z = self.TorchDense_3(gelu(self.TorchDense_2(z)))
        if cw:
            z = z.transpose(-1, -2)  # back to (B, H, W, C)
        return z[:, None]


class FNO(_FoldedFrames):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        modes1: int = 16,
        modes2: int = 16,
        modes3: int = 16,
        hidden_channels: int = 64,
        n_layers: int = 4,
        gradient_checkpointing: bool = False,
        output_length: int = 1,
        sp_mesh: Any = None,
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
        md = dset_metadata
        n_fields = md.n_fields if md else 4
        self.dims = md.n_spatial_dims if md else 2
        self.in_T = in_T
        self.output_length = output_length
        self.gradient_checkpointing = gradient_checkpointing
        self.dtype = dtype
        self.layout = layout
        # cw is the 2-D layout; 3-D inputs take wc, as in the JAX package.
        cw = layout == "cw" and self.dims == 2
        self._make_trunk(in_T * n_fields, n_fields, hidden_channels, dtype, gen, cw)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"FNOBlock_{i}", FNOBlock(
                hidden_channels, modes1, modes2, modes3, last=(i == n_layers - 1), dtype=dtype,
                cw=cw, dims=self.dims, gen=gen))
        self.set_sp_mesh(sp_mesh)
        self.to(dev)

    def set_sp_mesh(self, mesh) -> None:
        """Shard H over ``mesh``'s 'sp' axis (None: whole fields): the JAX
        model's ``sp_mesh`` field, which its Trainer sets by ``clone``.  The
        sharded path is channels-last, so it switches every layer to ``wc``
        (same parameters); None restores the constructor's layout."""
        self.sp_mesh = mesh
        self.cw = self.layout == "cw" and self.dims == 2 and mesh is None
        for m in self.modules():
            if m is not self and hasattr(m, "cw"):
                m.cw = self.cw
            if isinstance(m, FNOBlock):
                m.sp_mesh = mesh if self.dims == 2 else None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, *spatial, C) -> (B, 1, *spatial, C); spatial is (H, W) or
        (D, H, W).  No dropout: ``deterministic`` / ``generator`` are the
        trainers' call signature."""
        if x.ndim - 3 != self.dims:
            raise ValueError(f"model built for {self.dims}-D fields, got {tuple(x.shape)}")
        blocks = [getattr(self, f"FNOBlock_{i}") for i in range(self.n_layers)]
        return self._trunk(x, blocks, self.cw)
