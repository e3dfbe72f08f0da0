"""Fused axial transformer block (counterpart of ``tante_tpu/ops/pallas_block.py``).

Two entry points carry every attention block of the TANTE serving path:

- ``fused_block_apply(x, p, l, heads, causal)``: the whole pre-LN block on
  ``(S, L, C)`` rows (the H and W blocks, and the T block outside the
  canonical gate).  CUDA kernel ``fused_block_fwd`` replaces the Pallas
  kernel reached by ``fused_block_apply`` (``pallas_block.py:208``).
- ``fused_block_canon_t(x5, p, heads)``: the causal T block straight on the
  canonical ``(B, T, H, W, C)`` tensor with no transpose on either side.
  CUDA kernel ``fused_block_canon_t_fwd`` replaces ``fused_block_canon_t``
  (``pallas_block.py:368``).

Both kernels live in ``csrc/fused_block.cu`` and are built on first use by
``_build.py``.  Each wrapper takes its plain PyTorch version (``block_ref``,
``canon_t_ref``: the JAX package's ``_xla_block`` / ``_canon_t_ref``) only
for a tensor on the CPU; a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in its ``launches`` attribute.

Kernel numerics are the Pallas kernel's "fast" softmax: ``d**-0.5 * log2(e)``
folded into ``wq``/``bq`` once per launch, ``exp2(min(s, 60*log2(e)))`` with
no max-subtract, normalisation after the AV product with a ``+1e-30``
guard; bf16 activations and weights, f32 LayerNorm, softmax, GELU and
accumulators.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tante_tpu_torch.ops.activations import gelu_tanh_f32

LOG2E = 1.4426950408889634
# Largest sequence the CUDA kernel holds in one tile (whole sequences per
# CTA, scores never leave registers).  The serving path has L = 4, 16, 48.
KERNEL_MAX_L = 64
# C and the MLP width are matmul depths (multiples of 64) and LayerNorm
# widths the kernel holds in registers.
KERNEL_MAX_C = 512
KERNEL_HEAD_DIMS = (16, 32, 64)


class BlockParams(NamedTuple):
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def ln(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with one-pass moments (E[x^2] - mu^2), computed in f32 and
    returned in ``x.dtype`` (``pallas_block.py:_ln``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def block_ref(x: torch.Tensor, p: BlockParams, l: int, heads: int, causal: bool):
    """Plain PyTorch block: the JAX package's ``_xla_block`` op for op
    (max-subtract softmax, dtype following ``x``)."""
    dt = x.dtype
    c = x.shape[-1]
    d = c // heads
    xn = ln(x, p.ln1_scale, p.ln1_bias)
    q = ((xn @ p.wq.to(dt)) + p.bq.to(dt)) * (d**-0.5)
    k = (xn @ p.wk.to(dt)) + p.bk.to(dt)
    v = (xn @ p.wv.to(dt)) + p.bv.to(dt)

    def split(t):
        return t.reshape(*t.shape[:-1], heads, d)

    q, k, v = split(q), split(k), split(v)
    logits = torch.einsum("blhd,bmhd->bhlm", q, k).float()
    if causal:
        m = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
        logits = torch.where(m, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(dt)
    attn = torch.einsum("bhlm,bmhd->blhd", w, v).reshape(x.shape)
    x = x + (attn @ p.wo.to(dt)) + p.bo.to(dt)
    yn = ln(x, p.ln2_scale, p.ln2_bias)
    h1 = ((yn @ p.w1.to(dt)) + p.b1.to(dt)).float()
    h1 = gelu_tanh_f32(h1).to(dt)
    return x + (h1 @ p.w2.to(dt)) + p.b2.to(dt)


def canon_t_ref(x5: torch.Tensor, p: BlockParams, heads: int) -> torch.Tensor:
    """Plain causal T block on canonical (B, T, H, W, C): transpose, block,
    transpose back (``pallas_block.py:_canon_t_ref``)."""
    b, t, h, w, c = x5.shape
    y = x5.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    y = block_ref(y, p, t, heads, True)
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


def canon_t_supported(t: int, h: int, w: int, c: int, heads: int) -> bool:
    """Geometry gate for the canonical T-block kernel (``pallas_block.py:349``):
    2 <= T <= 8, C % 128 == 0, heads divides C.  The TPU gate's VMEM
    estimate has no counterpart: the CUDA kernel tiles pixels, so no whole
    batch element has to fit on chip."""
    return 2 <= t <= 8 and c % heads == 0 and c % 128 == 0


# --------------------------------------------------------------------------
# CUDA launch
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _param_shapes(c: int, hidden: int) -> tuple:
    return ((c,), (c,), (c, c), (c,), (c, c), (c,), (c, c), (c,), (c, c), (c,), (c,), (c,),
            (c, hidden), (hidden,), (hidden, c), (c,))


def _check_kernel_args(x: torch.Tensor, p: BlockParams, l: int, heads: int):
    """What the kernel takes, checked before any pointer reaches it (one
    pass per tensor: the checks run on every launch)."""
    bf16 = torch.bfloat16
    if x.device.type != "cuda":
        raise ValueError(f"fused block kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != bf16 or not x.is_contiguous():
        raise ValueError(f"kernel input must be contiguous bf16, got {x.dtype}")
    c, hidden = x.shape[-1], p.w1.shape[-1]
    if c % 64 or c > KERNEL_MAX_C or hidden % 64 or hidden > 2 * c or heads <= 0 or c % heads:
        raise ValueError(
            f"kernel needs C % 64 == 0, C <= {KERNEL_MAX_C}, hidden % 64 == 0, hidden <= 2C "
            f"and heads | C; got C={c}, hidden={hidden}, heads={heads}"
        )
    if c // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head dim must be one of {KERNEL_HEAD_DIMS}, got {c // heads}")
    if not 1 <= l <= KERNEL_MAX_L:
        raise ValueError(f"kernel holds sequences of 1..{KERNEL_MAX_L}, got L={l}")
    dev = x.device
    for name, t, want in zip(BlockParams._fields, p, _param_shapes(c, hidden)):
        if (t.shape != want or t.dtype != bf16 or t.device != dev or not t.is_contiguous()
                or t.data_ptr() % 32):
            raise ValueError(
                f"{name}: want contiguous 32-byte-aligned bf16 {want} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if x.data_ptr() % 32:
        raise ValueError("kernel input must be 32-byte aligned")


def _prescaled(p: BlockParams, heads: int) -> BlockParams:
    """Fold d**-0.5 * log2(e) into wq/bq once per launch
    (``pallas_block.py:147-151``)."""
    qs = (p.wq.shape[0] // heads) ** -0.5 * LOG2E
    # bf16 * scalar multiplies in f32 and rounds once: (w.f32 * qs).bf16.
    return p._replace(wq=p.wq * qs, bq=p.bq * qs)


def _ptr_array(p: BlockParams):
    return (ctypes.c_void_p * 16)(*[t.data_ptr() for t in p])


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def fused_block_apply(
    x: torch.Tensor, p: BlockParams, l: int, heads: int, causal: bool
) -> torch.Tensor:
    """(S, L, C) -> (S, L, C) full pre-LN transformer block."""
    if x.device.type == "cpu":
        return block_ref(x, p, l, heads, causal)
    from tante_tpu_torch.ops import _build

    s, l_, c = x.shape
    if l_ != l:
        raise ValueError(f"x of shape {tuple(x.shape)} does not hold sequences of L={l}")
    _check_kernel_args(x, p, l, heads)
    ps = _prescaled(p, heads)
    out = torch.empty_like(x)
    rc = _build.load().tante_fused_block_fwd(
        x.data_ptr(), out.data_ptr(), _ptr_array(ps), s, l, c, p.w1.shape[-1],
        heads, int(bool(causal)), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(rc, "fused_block_fwd")
    fused_block_apply.launches += 1
    return out


fused_block_apply.launches = 0


def fused_block_canon_t(x5: torch.Tensor, p: BlockParams, heads: int) -> torch.Tensor:
    """(B, T, H, W, C) -> same: one causal T-axis block on the canonical
    tensor, no rearrange on either side."""
    if x5.device.type == "cpu":
        return canon_t_ref(x5, p, heads)
    from tante_tpu_torch.ops import _build

    b, t, h, w, c = x5.shape
    if not canon_t_supported(t, h, w, c, heads):
        raise ValueError(f"canonical T block unsupported for {tuple(x5.shape)}, heads={heads}")
    _check_kernel_args(x5, p, t, heads)
    ps = _prescaled(p, heads)
    out = torch.empty_like(x5)
    rc = _build.load().tante_fused_block_canon_t_fwd(
        x5.data_ptr(), out.data_ptr(), _ptr_array(ps), b, t, h * w, c, p.w1.shape[-1],
        heads, x5.device.index, torch.cuda.current_stream(x5.device).cuda_stream,
    )
    _raise_on(rc, "fused_block_canon_t_fwd")
    fused_block_canon_t.launches += 1
    return out


fused_block_canon_t.launches = 0


def reset_launches():
    fused_block_apply.launches = 0
    fused_block_canon_t.launches = 0
