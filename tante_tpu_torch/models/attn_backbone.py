"""Axial-attention backbone (counterpart of ``tante_tpu/models/attn_backbone.py``).

Input/output ``(B, T, H, W, C)``.  Three residual propagator MLPs mix along
H, W and T; then one transformer block per axis letter, with the tensor
rearranged so attention runs along that axis:

  T  time, causal, per pixel        H/W  rows / columns
  L  H*W tokens per frame           Y/X  (T*H) / (T*W) space-time planes
  A  all T*H*W tokens                C    the C channels of each token, each
                                          lifted to ``expanded_channel``

A T block inside the canonical gate runs ``fused_block_canon_t`` on the
(B, T, H, W, C) tensor directly; every other block rearranges and runs
``fused_block_apply`` (the single-block kernel up to L = 64, the long entry
past it: the L, X and A axes at the flagship).  The channel axis ``C``
(``tante_tpu/models/attn_backbone.py:266-279``) turns each token's C values
into a sequence of C scalars, lifts each scalar with its own ``Mlp``
(``channel_lift_{k}``, the k-th C block of the backbone: 1 ->
expanded_channel / 4 -> expanded_channel, exact GELU), runs a block of width
``expanded_channel`` over the C channels, and keeps the last feature of each.
Opt-in, as in the JAX package: ``fused_group`` runs
a pure T/H/W ``attn_axes`` in one ``fused_group_apply`` launch, and
``fused_chain = n >= 2`` runs each run of up to n consecutive T/H/W blocks
in one ``fused_chain_apply`` launch.  Both, like the canonical T kernel,
apply only when ``deterministic or dropout == 0``; with dropout active every
block takes its plain path.  ``fused=False`` (the JAX backbone's ``fused``)
runs the plain block math everywhere: no group, chain, canonical T or block
kernel; the parameters are the same, so checkpoints are interchangeable.
The kernels run in the backbone's dtype, bf16 or f32; the canonical T, chain
and group gates take it (the f32 body holds C <= 256).  ``tp_mesh`` (tensor parallelism) goes to every
block; the group, chain and canonical-T kernels are single-device kernels and
are bypassed under it, so T blocks run as causal (rows, T, C) blocks.  The
group and chain gates take T/H/W letters only, so neither ever holds a C or
another long axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
from einops import rearrange
from torch import nn

from tante_tpu_torch.models.common import FusedTransformerBlock, Mlp
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.fused_block import (
    canon_t_supported,
    chain_fusable,
    fused_block_canon_t,
    fused_chain_apply,
    fused_group_apply,
    group_fusable,
)
from tante_tpu_torch.ops.initializers import torch_bias_init, torch_kernel_init

# axis -> (rearrange to (rows, L, C), inverse pattern, sizes the inverse needs)
_LAYOUTS = {
    "T": ("b t h w c -> (b h w) t c", "(b h w) t c -> b t h w c", "bhw"),
    "H": ("b t h w c -> (b t w) h c", "(b t w) h c -> b t h w c", "btw"),
    "W": ("b t h w c -> (b t h) w c", "(b t h) w c -> b t h w c", "bth"),
    "L": ("b t h w c -> (b t) (h w) c", "(b t) (h w) c -> b t h w c", "bhw"),
    "Y": ("b t h w c -> (b w) (t h) c", "(b w) (t h) c -> b t h w c", "bth"),
    "X": ("b t h w c -> (b h) (t w) c", "(b h) (t w) c -> b t h w c", "btw"),
    "A": ("b t h w c -> b (t h w) c", "b (t h w) c -> b t h w c", "thw"),
}


class AxisPropagator(nn.Module):
    """Residual Linear-GELU-Linear along one axis of (B, T, H, W, C)."""

    def __init__(self, axis_size: int, axis: int, dtype=torch.float32, gen=None):
        super().__init__()
        a = axis_size
        self.axis = axis
        self.dtype = dtype
        self.w1 = nn.Parameter(torch_kernel_init((a, a), gen))
        self.b1 = nn.Parameter(torch_bias_init((a,), a, gen))
        self.w2 = nn.Parameter(torch_kernel_init((a, a), gen))
        self.b2 = nn.Parameter(torch_bias_init((a,), a, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The mixing axis moved last and two matmuls: the same products as
        # the JAX package's einsum form, without einsum's per-call parsing.
        dt = self.dtype
        y = x.to(dt).movedim(self.axis, -1)
        y = gelu(y @ self.w1.to(dt) + self.b1.to(dt))
        y = y @ self.w2.to(dt) + self.b2.to(dt)
        return x + y.movedim(-1, self.axis)


class AttnBackbone(nn.Module):
    def __init__(self, tensor_shape: Tuple[int, int, int, int], attn_axes: str = "THWTHWTHW",
                 n_head: int = 8, mlp_ratio: float = 1.0, dropout: float = 0.0,
                 fused_group: bool = False, fused_chain: int = 0, dtype=torch.float32,
                 gen=None, tp_mesh=None, fused: bool = True, expanded_channel: int = 128):
        super().__init__()
        t, h, w, c = tensor_shape
        self.tensor_shape = tuple(tensor_shape)
        self.axes = attn_axes.replace(" ", "")
        if self.axes == "":
            raise ValueError("Invalid block: empty segment.")
        bad = set(self.axes) - set(_LAYOUTS) - {"C"}
        if bad:
            raise ValueError(f"Invalid attention axes {sorted(bad)}")
        self.n_head = n_head
        self.dropout = dropout
        self.fused = fused
        self.fused_group = fused_group
        self.fused_chain = fused_chain
        self.hidden = int(c * mlp_ratio)
        self.dtype = dtype
        self.vertical_propagator = AxisPropagator(h, 2, dtype, gen)
        self.horizontal_propagator = AxisPropagator(w, 3, dtype, gen)
        self.temporal_propagator = AxisPropagator(t, 1, dtype, gen)
        self.lift = {}  # block index of a C block -> its channel_lift index
        for i, axis in enumerate(self.axes):
            width = expanded_channel if axis == "C" else c
            self.add_module(f"block_{i}", FusedTransformerBlock(
                width, n_head, mlp_ratio, dropout, dtype, gen, tp_mesh=tp_mesh, use_kernel=fused))
            if axis == "C":
                k = self.lift[i] = len(self.lift)
                self.add_module(f"channel_lift_{k}", Mlp(
                    1, expanded_channel // 4, expanded_channel, approximate_gelu=False,
                    dtype=dtype, gen=gen))
        self.set_tp_mesh(tp_mesh)

    def set_tp_mesh(self, mesh) -> None:
        """Run the blocks tensor-parallel over ``mesh``'s 'tp' axis (None: not)."""
        self.tp_mesh = mesh
        for i in range(len(self.axes)):
            getattr(self, f"block_{i}").tp_mesh = mesh

    def _params_seq(self, start: int, n: int):
        return tuple(getattr(self, f"block_{start + k}").block_params() for k in range(n))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        t, h, w, c = self.tensor_shape
        dims = (t, h, w)
        sizes = {"b": x.shape[0], "t": t, "h": h, "w": w}
        # Compute-dtype gate: f32 embeddings upstream must not promote the
        # activation that rides through every block.
        x = x.to(self.dtype)
        x = self.vertical_propagator(x)
        x = self.horizontal_propagator(x)
        x = self.temporal_propagator(x)
        axes = self.axes
        kernels_ok = self.fused and (deterministic or self.dropout == 0.0)
        single = kernels_ok and self.tp_mesh is None  # the one-device kernels
        dt = x.dtype
        if (self.fused_group and single
                and group_fusable(axes, dims, c, self.n_head, self.hidden, dt)):
            return fused_group_apply(
                x.contiguous(), self._params_seq(0, len(axes)), axes, self.n_head)
        use_chain = self.fused_chain >= 2 and single
        i = 0
        while i < len(axes):
            axis = axes[i]
            if use_chain and axis in "THW":
                run = axes[i : i + self.fused_chain]
                j = 0
                while j < len(run) and run[j] in "THW":
                    j += 1
                run = run[:j]
                if len(run) >= 2 and chain_fusable(run, dims, c, self.n_head, self.hidden, dt):
                    y = rearrange(x, _LAYOUTS[run[0]][0]).contiguous()
                    y = fused_chain_apply(y, self._params_seq(i, len(run)), run, self.n_head, dims)
                    _, inv, keep = _LAYOUTS[run[-1]]
                    x = rearrange(y, inv, **{k: sizes[k] for k in keep})
                    i += len(run)
                    continue
            block = getattr(self, f"block_{i}")
            if axis == "C":
                # (b t h w) c 1 -> lift -> block over the C channels -> last feature.
                y = x.reshape(-1, c, 1)
                y = getattr(self, f"channel_lift_{self.lift[i]}")(y).contiguous()
                y = block(y, deterministic=deterministic, generator=generator)[..., -1]
                x = y.reshape(x.shape)
                i += 1
                continue
            i += 1
            if axis == "T" and single and canon_t_supported(t, h, w, c, self.n_head, self.hidden,
                                                            dt):
                x = fused_block_canon_t(x.contiguous(), block.block_params(), self.n_head)
                continue
            fwd, inv, keep = _LAYOUTS[axis]
            y = rearrange(x, fwd).contiguous()
            y = block(y, causal=axis == "T", deterministic=deterministic, generator=generator)
            x = rearrange(y, inv, **{k: sizes[k] for k in keep})
        return x
