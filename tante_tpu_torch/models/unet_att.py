"""Attention-gated U-Net baseline (counterpart of ``tante_tpu/models/unet_att.py``).

Double conv-BN-ReLU blocks, a max-pool encoder 64 -> 1024 channels (depth
2..5), a nearest-upsample + conv decoder with attention gates (a sigmoid
``psi`` on gate + skip), and a final 1x1 conv to ``n_channel * out_T``
frames, grouped channel-major as the reference's ``b (c t) ... -> b t c ...``.

BatchNorm is flax's (``ops/norms.py``): the running statistics are buffers
with the flax ``batch_stats`` names, a call with ``deterministic=False`` uses
the batch's statistics and moves the running ones once (the JAX model under
``mutable=["batch_stats"]``), a deterministic call uses the running ones.

Spatial sharding (``set_sp_mesh``): the forward runs on this rank's block
of H rows.  Every 3x3 conv halo-exchanges one row with its neighbours first
(``parallel/halo.py:halo_exchange``, zero edges: the unsharded 'same'
padding); 1x1 convs, pooling, upsampling and the reshapes are H-local.
BatchNorm statistics are the whole mesh's: the Trainer gives every BatchNorm
the group of the mesh's split axes.  Every pyramid level must keep an even
local row count: sp * 2**(depth - 1) must divide H.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.convs import Conv2d, conv_nhwc
from tante_tpu_torch.ops.norms import BatchNorm
from tante_tpu_torch.parallel.halo import halo_exchange

DIMS = (64, 128, 256, 512, 1024)


class HaloConv(Conv2d):
    """A 3x3 'same' conv (torch-default init, the bias's fan-in
    c_in * 9); under a spatial mesh the H padding comes from the halo
    exchange and the conv pads only W."""

    def __init__(self, c_in: int, c_out: int, dtype=torch.float32, gen=None):
        super().__init__(c_in, c_out, 3, padding=((1, 1), (1, 1)), dtype=dtype, gen=gen)
        self.sp_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sp_mesh is None:
            return super().forward(x)
        x = halo_exchange(x.to(self.dtype), 1, self.sp_mesh, periodic=False)
        return conv_nhwc(x, self.kernel.to(self.dtype), self.bias.to(self.dtype), 1,
                         ((0, 0), (1, 1)), 1)


def conv1x1(c_in: int, c_out: int, dtype, gen) -> Conv2d:
    return Conv2d(c_in, c_out, 1, dtype=dtype, gen=gen)


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, out_channels: int, dtype=torch.float32, gen=None):
        super().__init__()
        for i in range(2):
            self.add_module(f"Conv_{i}", HaloConv(c_in if i == 0 else out_channels,
                                                  out_channels, dtype, gen))
            self.add_module(f"BatchNorm_{i}", BatchNorm(out_channels, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(2):
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), train))
        return x


class UpConv(nn.Module):
    def __init__(self, c_in: int, out_channels: int, dtype=torch.float32, gen=None):
        super().__init__()
        self.Conv_0 = HaloConv(c_in, out_channels, dtype, gen)
        self.BatchNorm_0 = BatchNorm(out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # nearest, x2
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), train))


class AttentionGate(nn.Module):
    def __init__(self, c_gate: int, c_skip: int, n_coefficients: int, dtype=torch.float32,
                 gen=None):
        super().__init__()
        self.W_gate = conv1x1(c_gate, n_coefficients, dtype, gen)
        self.BatchNorm_0 = BatchNorm(n_coefficients, dtype=dtype)
        self.W_x = conv1x1(c_skip, n_coefficients, dtype, gen)
        self.BatchNorm_1 = BatchNorm(n_coefficients, dtype=dtype)
        self.psi = conv1x1(n_coefficients, 1, dtype, gen)
        self.BatchNorm_2 = BatchNorm(1, dtype=dtype)

    def forward(self, gate: torch.Tensor, skip: torch.Tensor, train: bool = False):
        g1 = self.BatchNorm_0(self.W_gate(gate), train)
        x1 = self.BatchNorm_1(self.W_x(skip), train)
        psi = torch.sigmoid(self.BatchNorm_2(self.psi(torch.relu(g1 + x1)), train))
        return skip * psi


class AttentionUNet(nn.Module):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        depth: int = 4,
        out_T: int = 4,
        dtype=torch.float32,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        if not 2 <= depth <= len(DIMS):
            raise ValueError(f"depth {depth}: AttentionUNet has 2 to {len(DIMS)} levels")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        md = dset_metadata
        c = md.n_fields if md else 4
        self.in_T, self.depth, self.out_T, self.dtype = in_T, depth, out_T, dtype
        self.output_length = out_T
        self.sp_mesh = None
        dims = DIMS[:depth]
        for i, d in enumerate(dims):
            self.add_module(f"Conv{i + 1}", ConvBlock(in_T * c if i == 0 else dims[i - 1], d,
                                                      dtype, gen))
        for level in range(depth, 1, -1):
            d = dims[level - 2]
            self.add_module(f"Up{level}", UpConv(dims[level - 1], d, dtype, gen))
            self.add_module(f"Att{level}", AttentionGate(d, d, d // 2, dtype, gen))
            self.add_module(f"UpConv{level}", ConvBlock(2 * d, d, dtype, gen))
        self.Conv = conv1x1(dims[0], c * out_T, dtype, gen)
        self.to(dev)

    def set_sp_mesh(self, mesh) -> None:
        """Run on this rank's H rows of ``mesh``'s 'sp' axis (None: whole
        fields): every 3x3 conv halo-exchanges first.  The JAX model's
        ``sp_axis``, which its Trainer sets by ``clone``."""
        self.sp_mesh = mesh
        for m in self.modules():
            if isinstance(m, HaloConv):
                m.sp_mesh = mesh

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, out_T, H, W, C); ``deterministic=False``
        uses and updates the batch statistics.  No dropout: ``generator`` is
        the trainers' call signature."""
        train = not deterministic
        b, t, h, w, c = x.shape
        if self.sp_mesh is not None and h % 2 ** (self.depth - 1):
            sp = self.sp_mesh.size("sp")
            raise ValueError(
                f"spatial sharding over sp={sp}: sp * 2**(depth - 1) = "
                f"{sp * 2 ** (self.depth - 1)} must divide H = {h * sp}")
        z = x.movedim(1, -2).reshape(b, h, w, t * c)
        encs = []
        for i in range(self.depth):
            if i > 0:
                z = F.max_pool2d(z.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            z = getattr(self, f"Conv{i + 1}")(z, train)
            encs.append(z)
        d_cur = encs[-1]
        for level in range(self.depth, 1, -1):
            d_up = getattr(self, f"Up{level}")(d_cur, train)
            s = getattr(self, f"Att{level}")(d_up, encs[level - 2], train)
            d_cur = getattr(self, f"UpConv{level}")(torch.cat([s, d_up], dim=-1), train)
        out = self.Conv(d_cur).reshape(b, h, w, c, self.out_T)
        return out.permute(0, 4, 1, 2, 3)
