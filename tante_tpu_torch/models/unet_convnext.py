"""ConvNeXt U-Net baseline (counterpart of ``tante_tpu/models/unet_convnext.py``).

ConvNeXt blocks (7x7 depthwise conv -> LayerNorm -> 4x MLP -> LayerScale)
in a U-Net of down / up stages with channel-concat skips and 1x1 skip
projections, channels-last.  The depthwise conv is
``ops/convs.py:depthwise_conv2d_lanes`` (the grouped conv, as the JAX
block's).  The reference's channels-first "LayerNorm" inside the stages is
an L2 normalisation over channels times a weight (``ChannelL2Norm``),
reproduced as the JAX package does.

Convolutions pad (k // 2, (k - 1) // 2) on each side, so the 2x2 stride-2
``down`` conv pads one row and column in front and none behind
(``ops/convs.py:same_padding``); the 2x2 stride-2 ``up`` is flax's
``ConvTranspose`` (``PatchConvTranspose``, kernel flipped).

Parameter layout: with ``blocks_per_stage > 1`` the JAX package scans one
block over the depth (``nn.scan``), so a stage holds ONE tree
``blocks/ConvNextBlock_0/...`` whose tensors carry a leading depth axis; with
depth 1 it holds an unstacked ``ConvNextBlock_0``.  ``ConvNextBlock`` keeps
both layouts (``depth`` stacked copies, looped over), so ``convert.py``'s one
rule holds.  ``gradient_checkpointing`` recomputes each encoder / decoder
stage in backward (``utils/remat.py``; the neck is not rematerialised, as in
JAX).  Plain PyTorch throughout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.convs import (
    Conv2d,
    PatchConvTranspose,
    depthwise_conv2d_lanes,
    same_padding,
)
from tante_tpu_torch.ops.fused_block import ln
from tante_tpu_torch.ops.initializers import torch_bias_init, torch_kernel_init
from tante_tpu_torch.utils.remat import remat


class ChannelL2Norm(nn.Module):
    """x / max(||x||_2 over C, eps) * weight (the reference quirk)."""

    seed_rules = {"weight": "gain"}

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=self.eps) * self.weight.to(x.dtype)


def conv(c_in: int, c_out: int, kernel: int, stride: int = 1, groups: int = 1,
         dtype=torch.float32, gen=None) -> Conv2d:
    """The JAX module's ``_conv``: (k // 2, (k - 1) // 2) padding, 'VALID'
    for 1x1, torch-default init with the bias's fan-in c_in * k * k / groups."""
    return Conv2d(c_in, c_out, kernel, stride, same_padding(kernel) if kernel > 1 else None,
                  groups, dtype=dtype, gen=gen)


class _Params(nn.Module):
    """A named group of parameters (a flax submodule's leaves)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


class ConvNextBlock(nn.Module):
    """dwconv 7x7 -> LayerNorm (1e-6) -> Dense 4x -> GELU -> Dense ->
    LayerScale (``gamma``, 1e-6 at init) -> + x.  With ``depth`` set, every
    parameter carries a leading axis of that length (the ``nn.scan`` layout)
    and ``forward`` runs the copies in order."""

    seed_rules = {"gamma": "gain"}

    def __init__(self, dim: int, depth: Optional[int] = None, layer_scale_init_value: float = 1e-6,
                 dtype=torch.float32, gen=None):
        super().__init__()
        self.dim, self.depth, self.dtype = dim, depth, dtype
        n = depth or 1

        def stack(make):
            ts = [make() for _ in range(n)]
            return torch.stack(ts) if depth else ts[0]

        self.dwconv = _Params(kernel=stack(lambda: torch_kernel_init((7, 7, 1, dim), gen)),
                              bias=stack(lambda: torch_bias_init((dim,), 49, gen)))
        self.LayerNorm_0 = _Params(scale=stack(lambda: torch.ones(dim)),
                                   bias=stack(lambda: torch.zeros(dim)))
        self.LayerNorm_0.seed_rules = {"scale": "gain"}
        self.Dense_0 = _Params(kernel=stack(lambda: torch_kernel_init((dim, 4 * dim), gen)),
                               bias=stack(lambda: torch_bias_init((4 * dim,), dim, gen)))
        self.Dense_1 = _Params(kernel=stack(lambda: torch_kernel_init((4 * dim, dim), gen)),
                               bias=stack(lambda: torch_bias_init((dim,), 4 * dim, gen)))
        self.layer_scale = layer_scale_init_value > 0
        if self.layer_scale:
            self.gamma = nn.Parameter(stack(lambda: layer_scale_init_value * torch.ones(dim)))

    def _one(self, x: torch.Tensor, i: Optional[int]) -> torch.Tensor:
        def p(t):
            return (t if i is None else t[i]).to(self.dtype)

        d, l0, f0, f1 = self.dwconv, self.LayerNorm_0, self.Dense_0, self.Dense_1
        y = depthwise_conv2d_lanes(x.to(self.dtype), p(d.kernel), p(d.bias))
        y = ln(y.float(), l0.scale if i is None else l0.scale[i],
               l0.bias if i is None else l0.bias[i], 1e-6).to(self.dtype)
        y = gelu(y @ p(f0.kernel) + p(f0.bias)) @ p(f1.kernel) + p(f1.bias)
        if self.layer_scale:
            y = p(self.gamma) * y
        return (x + y).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.depth is None:
            return self._one(x, None)
        for i in range(self.depth):
            x = self._one(x, i)
        return x


class _ScanCell(nn.Module):
    """The ``nn.scan`` wrapper's name level: ``blocks/ConvNextBlock_0``."""

    def __init__(self, dim: int, depth: int, dtype, gen):
        super().__init__()
        self.ConvNextBlock_0 = ConvNextBlock(dim, depth, dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvNextBlock_0(x)


class Stage(nn.Module):
    """[skip projection] -> ``depth`` ConvNeXt blocks -> ChannelL2Norm and
    the 2x2 stride-2 conv (``down``) or transposed conv (``up``), or nothing
    more (``neck``)."""

    def __init__(self, dim_in: int, dim_out: int, depth: int = 1, mode: str = "down",
                 skip_project: bool = False, c_in: Optional[int] = None, dtype=torch.float32,
                 gen=None):
        super().__init__()
        if mode not in ("down", "up", "neck"):
            raise ValueError(f"Unknown stage mode '{mode}'")
        self.mode, self.depth = mode, depth
        if skip_project:
            self.skip_proj = conv(c_in or dim_in, dim_in, 1, dtype=dtype, gen=gen)
        if depth > 1:
            self.blocks = _ScanCell(dim_in, depth, dtype, gen)
        elif depth == 1:
            self.ConvNextBlock_0 = ConvNextBlock(dim_in, dtype=dtype, gen=gen)
        if mode == "down":
            self.ChannelL2Norm_0 = ChannelL2Norm(dim_in)
            self.down = conv(dim_in, dim_out, 2, stride=2, dtype=dtype, gen=gen)
        elif mode == "up":
            self.ChannelL2Norm_0 = ChannelL2Norm(dim_in)
            self.up = PatchConvTranspose(dim_in, dim_out, (2, 2), dtype=dtype, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "skip_proj"):
            x = self.skip_proj(x)
        if self.depth > 1:
            x = self.blocks(x)
        elif self.depth == 1:
            x = self.ConvNextBlock_0(x)
        if self.mode == "down":
            x = self.down(self.ChannelL2Norm_0(x))
        elif self.mode == "up":
            x = self.up(self.ChannelL2Norm_0(x))
        return x


class UNetConvNext(nn.Module):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        stages: int = 4,
        blocks_per_stage: int = 1,
        blocks_at_neck: int = 1,
        init_features: int = 32,
        gradient_checkpointing: bool = False,
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
        self.in_T, self.output_length, self.dtype = in_T, output_length, dtype
        self.stages, self.gradient_checkpointing = stages, gradient_checkpointing
        f = init_features
        enc = [f * 2**i for i in range(stages + 1)]
        dec = [f * 2**i for i in range(stages, -1, -1)]
        self.in_proj = conv(in_T * c, f, 3, dtype=dtype, gen=gen)
        for i in range(stages):
            self.add_module(f"enc_{i}", Stage(enc[i], enc[i + 1], blocks_per_stage, "down",
                                              dtype=dtype, gen=gen))
        self.neck = Stage(enc[-1], enc[-1], blocks_at_neck, "neck", dtype=dtype, gen=gen)
        for j in range(stages):
            # Decoder stage j > 0 reads the previous stage's output and the skip.
            c_in = dec[j] if j == 0 else dec[j] + enc[stages - j]
            self.add_module(f"dec_{j}", Stage(dec[j], dec[j + 1], blocks_per_stage, "up",
                                              skip_project=j != 0, c_in=c_in, dtype=dtype,
                                              gen=gen))
        self.out_proj = conv(f, c, 3, dtype=dtype, gen=gen)
        self.to(dev)

    def _stage(self, name: str, z: torch.Tensor) -> torch.Tensor:
        stage = getattr(self, name)
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return remat(stage, z)
        return stage(z)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, 1, H, W, C).  No dropout:
        ``deterministic`` / ``generator`` are the trainers' call signature."""
        b, t, h, w, c = x.shape
        z = self.in_proj(x.movedim(1, -2).reshape(b, h, w, t * c))
        skips = []
        for i in range(self.stages):
            skips.append(z)
            z = self._stage(f"enc_{i}", z)
        z = self.neck(z)
        for j in range(self.stages):
            if j > 0:
                z = torch.cat([z, skips[-j]], dim=-1)
            z = self._stage(f"dec_{j}", z)
        return self.out_proj(z)[:, None]
