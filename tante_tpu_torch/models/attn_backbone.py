"""Axial-attention backbone (counterpart of ``tante_tpu/models/attn_backbone.py``).

Input/output ``(B, T, H, W, C)``.  Three residual propagator MLPs mix along
H, W and T; then one transformer block per axis letter, with the tensor
rearranged so attention runs along that axis:

  T  time, causal, per pixel        H/W  rows / columns
  L  H*W tokens per frame           Y/X  (T*H) / (T*W) space-time planes
  A  all T*H*W tokens

A T block inside the canonical gate runs ``fused_block_canon_t`` on the
(B, T, H, W, C) tensor directly; every other block rearranges and runs
``fused_block_apply``.  Only the per-block path is ported: the JAX
package's opt-in chain/group fusion and the channel-lift axis ``C`` are not
(``C`` raises ``NotImplementedError``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from einops import rearrange
from torch import nn

from tante_tpu_torch.models.common import FusedTransformerBlock
from tante_tpu_torch.ops.activations import gelu
from tante_tpu_torch.ops.fused_block import canon_t_supported, fused_block_canon_t
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
                 n_head: int = 8, mlp_ratio: float = 1.0, dtype=torch.float32, gen=None):
        super().__init__()
        t, h, w, c = tensor_shape
        self.tensor_shape = tuple(tensor_shape)
        self.axes = attn_axes.replace(" ", "")
        if self.axes == "":
            raise ValueError("Invalid block: empty segment.")
        bad = set(self.axes) - set(_LAYOUTS)
        if "C" in bad:
            raise NotImplementedError("channel-lift axis 'C' is not ported yet")
        if bad:
            raise ValueError(f"Invalid attention axes {sorted(bad)}")
        self.n_head = n_head
        self.dtype = dtype
        self.vertical_propagator = AxisPropagator(h, 2, dtype, gen)
        self.horizontal_propagator = AxisPropagator(w, 3, dtype, gen)
        self.temporal_propagator = AxisPropagator(t, 1, dtype, gen)
        for i in range(len(self.axes)):
            self.add_module(
                f"block_{i}", FusedTransformerBlock(c, n_head, mlp_ratio, dtype, gen)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, h, w, c = self.tensor_shape
        sizes = {"b": x.shape[0], "t": t, "h": h, "w": w}
        # Compute-dtype gate: f32 embeddings upstream must not promote the
        # activation that rides through every block.
        x = x.to(self.dtype)
        x = self.vertical_propagator(x)
        x = self.horizontal_propagator(x)
        x = self.temporal_propagator(x)
        for i, axis in enumerate(self.axes):
            block = getattr(self, f"block_{i}")
            if axis == "T" and canon_t_supported(t, h, w, c, self.n_head):
                x = fused_block_canon_t(x.contiguous(), block.block_params(), self.n_head)
                continue
            fwd, inv, keep = _LAYOUTS[axis]
            y = rearrange(x, fwd).contiguous()
            y = block(y, causal=axis == "T")
            x = rearrange(y, inv, **{k: sizes[k] for k in keep})
        return x
