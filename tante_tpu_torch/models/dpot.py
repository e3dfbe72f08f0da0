"""DPOT baseline (counterpart of ``tante_tpu/models/dpot.py``): the
denoising-pretrained operator transformer.

A per-frame conv patch embed with three appended (x, y, t) grid features, a
learned position embedding, a learned ``TimeAggregator`` ('mlp' or
'exp_mlp' with a cosine time embedding) contracting T away, N blocks of
[GroupNorm(8) -> AFNO2D Fourier mixer (real / imaginary block-diagonal
weights and biases on the low-mode corner, internal residual) -> GroupNorm ->
MLP], and a transposed-conv head reshaped to ``out_timesteps`` frames.
Channels-last throughout; GroupNorm is flax's (epsilon 1e-6,
``ops/norms.py``).

The reference's ``cls`` head is computed and thrown away there; its
parameters (``Dense_0``, ``Dense_1``, ``cls_out``) are kept so checkpoints
carry across, and nothing computes it here, as nothing does in the compiled
JAX model.  The loss does not reach them: the Trainer gives such parameters a
zero gradient, so AdamW decays them as optax does.  Transforms are
``torch.fft.rfft2`` / ``irfft2`` (ortho) in f32.  Plain PyTorch throughout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.afno import dense02, patch_conv02, trunc02
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.convs import PatchConv, PatchConvTranspose
from tante_tpu_torch.ops.fourier import block_diag_complex_matmul
from tante_tpu_torch.ops.norms import GroupNorm

ACTIVATIONS = {"gelu": gelu, "relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
               "silu": F.silu}


class AFNO2DMixer(nn.Module):
    """DPOT's Fourier mixer: a 2-layer block-diagonal complex MLP with
    separate real / imaginary weights and biases on the ``modes x modes``
    low-frequency corner (non-negative H frequencies only), scattered back
    into zeros, inverse-transformed, plus the input."""

    def __init__(self, width: int, num_blocks: int = 8, modes: int = 32,
                 hidden_size_factor: int = 1, act: str = "gelu", dtype=torch.float32, gen=None):
        super().__init__()
        nb, bs, hsf = num_blocks, width // num_blocks, hidden_size_factor
        self.num_blocks, self.modes, self.act, self.dtype = nb, modes, ACTIVATIONS[act], dtype
        scale = 1.0 / (bs * bs * hsf)

        def u(*shape):
            return nn.Parameter(scale * torch.rand(shape, generator=gen))

        self.w1 = u(2, nb, bs, bs * hsf)
        self.b1 = u(2, nb, bs * hsf)
        self.w2 = u(2, nb, bs * hsf, bs)
        self.b2 = u(2, nb, bs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nb = self.num_blocks
        xf = torch.fft.rfft2(x.float(), dim=(1, 2), norm="ortho")
        hf, wf = xf.shape[1], xf.shape[2]
        m1, m2 = min(self.modes, hf), min(self.modes, wf)
        corner = xf[:, :m1, :m2].reshape(b, m1, m2, nb, c // nb)
        w1, b1, w2, b2 = (p.float() for p in (self.w1, self.b1, self.w2, self.b2))
        re, im = block_diag_complex_matmul(corner.real, corner.imag, w1[0], w1[1])
        re, im = self.act(re + b1[0]), self.act(im + b1[1])
        re, im = block_diag_complex_matmul(re, im, w2[0], w2[1])
        oc = torch.complex(re + b2[0], im + b2[1]).reshape(b, m1, m2, c)
        # Scatter into zeros: pad W up to wf, then H up to hf.
        oc = torch.cat([oc, oc.new_zeros((b, m1, wf - m2, c))], dim=2)
        yf = torch.cat([oc, oc.new_zeros((b, hf - m1, wf, c))], dim=1)
        y = torch.fft.irfft2(yf, s=(h, w), dim=(1, 2), norm="ortho")
        return y.to(x.dtype) + x


class DPOTBlock(nn.Module):
    def __init__(self, width: int, n_blocks: int = 8, modes: int = 32, mlp_ratio: float = 1.0,
                 act: str = "gelu", double_skip: bool = False, dtype=torch.float32, gen=None):
        super().__init__()
        self.act, self.double_skip = ACTIVATIONS[act], double_skip
        self.GroupNorm_0 = GroupNorm(width, 8, dtype=dtype)
        self.AFNO2DMixer_0 = AFNO2DMixer(width, n_blocks, modes, act=act, dtype=dtype, gen=gen)
        self.GroupNorm_1 = GroupNorm(width, 8, dtype=dtype)
        hidden = int(width * mlp_ratio)
        self.Dense_0 = dense02(width, hidden, dtype, gen)
        self.Dense_1 = dense02(hidden, width, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.AFNO2DMixer_0(self.GroupNorm_0(x))
        if self.double_skip:
            y = y + residual
            residual = y
        z = self.Dense_1(self.act(self.Dense_0(self.GroupNorm_1(y))))
        return z + residual


class TimeAggregator(nn.Module):
    """Learned per-timestep channel matrices contracting T away:
    (B, H, W, T, C) -> (B, H, W, C); 'exp_mlp' first multiplies by
    cos(t * gamma) on a [0, 1] time grid."""

    def __init__(self, n_timesteps: int, out_channels: int, agg_type: str = "exp_mlp",
                 dtype=torch.float32, gen=None):
        super().__init__()
        if agg_type not in ("mlp", "exp_mlp"):
            raise ValueError(f"Unknown time_agg '{agg_type}'")
        t, c = n_timesteps, out_channels
        self.agg_type, self.dtype = agg_type, dtype
        self.w = nn.Parameter(torch.randn((t, c, c), generator=gen) / (t * c**0.5))
        if agg_type == "exp_mlp":
            self.gamma = nn.Parameter((2.0 ** torch.linspace(-10, 10, c))[None, :])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w.to(x.dtype)
        if self.agg_type == "exp_mlp":
            tgrid = torch.linspace(0, 1, x.shape[-2], device=x.device)[:, None]
            x = x * torch.cos(tgrid @ self.gamma).to(x.dtype)
        return torch.einsum("tij,...ti->...j", w, x)


class DPOT(nn.Module):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        patch_size: int = 16,
        mixing_type: str = "afno",
        out_timesteps: int = 1,
        n_blocks: int = 4,
        embed_dim: int = 768,
        out_layer_dim: int = 32,
        depth: int = 12,
        modes: int = 32,
        mlp_ratio: float = 1.0,
        n_cls: int = 12,
        act: str = "gelu",
        time_agg: str = "exp_mlp",
        dtype=torch.float32,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        if mixing_type != "afno":
            raise ValueError(f"mixing_type '{mixing_type}': only afno mixing is implemented")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        md = dset_metadata
        c = md.n_fields if md else 4
        self.resolution = tuple(md.spatial_resolution) if md else (128, 384)
        h, w = self.resolution
        p = patch_size
        self.in_T, self.out_timesteps, self.output_length = in_T, out_timesteps, out_timesteps
        self.patch_size, self.embed_dim, self.depth = p, embed_dim, depth
        self.act, self.dtype = ACTIVATIONS[act], dtype
        self.patch_proj = patch_conv02(PatchConv, c + 3, c * p + 3, (p, p), dtype, gen)
        self.patch_out = dense02(c * p + 3, embed_dim, dtype, gen)
        self.pos_embed = nn.Parameter(trunc02((1, h // p, w // p, embed_dim), gen))
        self.time_agg_layer = TimeAggregator(in_T, embed_dim, time_agg, dtype, gen)
        for i in range(depth):
            self.add_module(f"DPOTBlock_{i}", DPOTBlock(
                embed_dim, n_blocks, modes, mlp_ratio, act, dtype=dtype, gen=gen))
        # The cls head (see the module docstring): parameters only.
        self.Dense_0 = dense02(embed_dim, embed_dim, dtype, gen)
        self.Dense_1 = dense02(embed_dim, embed_dim, dtype, gen)
        self.cls_out = dense02(embed_dim, n_cls, dtype, gen)
        self.out_deconv = patch_conv02(PatchConvTranspose, embed_dim, out_layer_dim, (p, p),
                                       dtype, gen)
        self.Dense_2 = dense02(out_layer_dim, out_layer_dim, dtype, gen)
        self.out_proj = dense02(out_layer_dim, c * out_timesteps, dtype, gen)
        self.to(dev)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, out_timesteps, H, W, C).  No dropout:
        ``deterministic`` / ``generator`` are the trainers' call signature."""
        b, t, h, w, c = x.shape
        p = self.patch_size
        if (h, w) != self.resolution:
            raise ValueError(f"Input image size ({h}*{w}) doesn't match model {self.resolution}")
        # (x, y, t) grid features on [0, 1] (the reference's get_grid_3d).
        dev = x.device
        gx = torch.linspace(0, 1, h, device=dev)[:, None, None].expand(h, w, t)
        gy = torch.linspace(0, 1, w, device=dev)[None, :, None].expand(h, w, t)
        gt = torch.linspace(0, 1, t, device=dev)[None, None, :].expand(h, w, t)
        grid = torch.stack([gx, gy, gt], dim=-1).movedim(2, 0).to(x.dtype)  # (T, H, W, 3)
        z = torch.cat([x, grid.expand(b, t, h, w, 3)], dim=-1).reshape(b * t, h, w, c + 3)
        z = self.patch_out(self.act(self.patch_proj(z))) + self.pos_embed.to(self.dtype)
        z = z.reshape(b, t, h // p, w // p, self.embed_dim).movedim(1, 3)
        z = self.time_agg_layer(z)
        for i in range(self.depth):
            z = getattr(self, f"DPOTBlock_{i}")(z)
        y = self.act(self.out_deconv(z))
        y = self.out_proj(self.act(self.Dense_2(y)))
        return y.reshape(b, h, w, self.out_timesteps, c).movedim(3, 1)
