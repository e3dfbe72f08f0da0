"""Head-packed attention core (counterpart of ``tante_tpu/ops/pallas_attention.py``).

For every sequence and head: the L queries of the head's segment attend over
the same segment's L keys (key <= query when causal) with f32 scores and a
max-subtract f32 softmax, the weights cast to v's dtype, the AV product
accumulated in f32 and cast to q's dtype.

- ``packed_attention_ref``: the plain PyTorch version (the JAX package's
  ``_xla_packed_core``): the heads folded into one (P, P) score matrix per
  sequence, P = heads * L, with a block-diagonal (and causal) -1e30 mask.
- ``packed_attention(qp, kp, vp, l, causal)``: the JAX signature, (S, P, D)
  with q already scaled by D**-0.5.
- ``packed_head_attention(q, k, v, causal)``: the same core on
  ``(*lead, L, heads, D)`` projections (q unscaled), as ``MultiheadAttention``
  and AViT hold them; output contiguous ``(*lead, L, heads, D)``.

Both wrappers take the plain version for a tensor on the CPU; a CUDA tensor
launches the hand-written kernel ``csrc/packed_attention.cu`` (built on
first use by ``_build.py``; replaces the Pallas kernel reached by
``pallas_attention.py:packed_attention_core``) or raises, also outside the
kernel's envelope (P <= 128, D in [8, 128], f32 or bf16, at most two leading
axes).  Both count their launches in ``packed_attention.launches``.  The
kernel takes element strides, so the projections go in as views (a q / k / v
slice of a fused projection, a column view of an axial layout) and nothing is
packed or transposed; for ``packed_head_attention`` it applies the scale to
its f32 scores, where the plain version scales q in its own dtype first.  It
stages rows 16 bytes at a time, so it takes operands with channel stride 1 and
rows on 16-byte boundaries; the wrapper copies an operand that has neither
(into zero-padded rows where D * itemsize is not a multiple of 16) and counts
it in ``packed_attention.copies``.  AViT's row and column views, the packed
form and the slices of a fused projection need no copy.  ``packed_plan`` is
the kernel's launch plan (``tante_packed_attention_plan`` returns the same on
the card).

Gradients: the Pallas kernel's custom VJP differentiates the XLA core
(``_packed_attention_bwd``); here, on CUDA tensors that need a gradient, the
launch sits in one ``torch.autograd.Function`` whose backward differentiates
the plain version.  There is no backward kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

# heads * L: the gate of the packed branch (``TANTE_PACKED_MAX``) and the kernel's envelope
PACKED_ATTENTION_MAX_TOKENS = 128
KERNEL_HEAD_DIMS = (8, 128)  # D range
KERNEL_MAX_LEAD = 2  # sequence axes the kernel addresses by stride
_GEOM = ctypes.c_longlong * 25

# The kernel's launch plan (csrc/packed_attention.cu: make_plan, plan_for).
PLAN_MAX_WARPS, PLAN_MAX_STAGES, PLAN_ROW_BLOCK = 16, 4, 16
PLAN_SMEM_LIMIT = 232448  # 227 KB: a CTA's dynamic shared memory on sm_90


class PackedPlan(NamedTuple):
    """Per CTA ``warps`` consumer warps, each with a ring of ``stages`` unit
    slots (q, k, v rows ``row_bytes`` apart) and an (L, 16) f32 scratch."""

    warps: int
    stages: int
    row_bytes: int
    unit_bytes: int
    scratch_bytes: int
    smem_bytes: int


def packed_plan(l: int, d: int, itemsize: int, units: int, sms: int) -> PackedPlan:
    """The kernel's plan for ``units`` units of L rows of D channels on a
    card of ``sms`` SMs: a ring of two (one unit in flight while one
    computes) where a warp holds two; as many warps as fit, up to 16, but no
    more than give each at least two units of an SM's share; then the
    deepest ring (up to 4) those warps leave room for."""
    # Rows of n 16-byte chunks padded to n + pad == 2 (mod 4) chunks: the
    # score tile's 4 rows x 2 chunk parities fall into 8 different banks.
    n = -(-d * itemsize // 16)
    row = 16 * (n + ((2 - n) % 4 or 4))
    unit, scratch = 3 * l * row, 4 * PLAN_ROW_BLOCK * l
    stages = 2 if 2 * unit + scratch <= PLAN_SMEM_LIMIT else 1
    want = (-(-units // sms) + 1) // 2
    warps = min(PLAN_MAX_WARPS, PLAN_SMEM_LIMIT // (stages * unit + scratch), want)
    while stages < PLAN_MAX_STAGES and warps * ((stages + 1) * unit + scratch) <= PLAN_SMEM_LIMIT:
        stages += 1
    return PackedPlan(warps, stages, row, unit, scratch, warps * (stages * unit + scratch))


def packed_grid(units: int, sms: int, ctas_per_sm: int) -> int:
    """Persistent grid: the resident CTAs, down to one unit a CTA (so that
    every SM takes a share)."""
    return min(units, sms * ctas_per_sm)


def launch_plan(s0: int, s1: int, h: int, l: int, d: int, dtype) -> dict:
    """The plan a launch takes on the current card (from the library)."""
    from tante_tpu_torch.ops import _build

    out = (ctypes.c_longlong * 8)()
    geom = _GEOM(s0, s1, h, l, d, *([0] * 20))
    rc = _build.load("packed_attention").tante_packed_attention_plan(
        geom, int(dtype == torch.bfloat16), torch.cuda.current_device(), out)
    if rc != 0:
        raise RuntimeError(f"packed_attention plan: cudaError {rc}")
    return dict(zip((*PackedPlan._fields, "grid", "ctas_per_sm"), out))


def packed_attention_ref(qp, kp, vp, l: int, causal: bool = False) -> torch.Tensor:
    """(S, P, D) head-packed q (pre-scaled), k, v -> (S, P, D)."""
    p = qp.shape[1]
    scores = torch.einsum("spd,sqd->spq", qp.float(), kp.float())
    idx = torch.arange(p, device=qp.device)
    mask = (idx[:, None] // l) == (idx[None, :] // l)
    if causal:
        mask = mask & ((idx[:, None] % l) >= (idx[None, :] % l))
    scores = torch.where(mask, scores, torch.full((), -1e30, device=qp.device))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("spq,sqd->spd", weights.to(vp.dtype), vp).to(qp.dtype)


def _head_ref(q, k, v, causal: bool) -> torch.Tensor:
    """``packed_attention_ref`` on (*lead, L, H, D) projections, q unscaled
    (the JAX package's ``packed_head_attention``: pack, core, unpack)."""
    *lead, l, h, d = q.shape
    s = math.prod(lead)

    def pack(t):
        return t.reshape(s, l, h, d).transpose(1, 2).reshape(s, h * l, d)

    out = packed_attention_ref(pack(q * d**-0.5), pack(k), pack(v), l, causal)
    return out.reshape(s, h, l, d).transpose(1, 2).reshape(q.shape)


def _plain(q, k, v, l: int, causal: bool, heads_last: bool) -> torch.Tensor:
    if heads_last:
        return _head_ref(q, k, v, causal)
    return packed_attention_ref(q, k, v, l, causal)


def _check_envelope(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: the kernel takes q, k, v of one dtype on one device, got "
                             f"{t.dtype} on {t.device} (q: {q.dtype} on {q.device})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes f32 or bf16, got {q.dtype}")


def _check_geometry(q5):
    _, _, h, l, d = q5.shape
    lo, hi = KERNEL_HEAD_DIMS
    if h * l > PACKED_ATTENTION_MAX_TOKENS or not lo <= d <= hi:
        raise ValueError(f"outside the kernel's envelope: heads * L = {h * l} (at most "
                         f"{PACKED_ATTENTION_MAX_TOKENS}), D = {d} (from {lo} to {hi})")


def rows_aligned(t5) -> bool:
    """Whether every row of a (S0, S1, H, L, D) view starts on a 16-byte
    boundary (the base, and the strides of the axes longer than 1) with its
    channels adjacent: what the kernel checks of its inputs."""
    size = t5.element_size()
    if t5.stride(-1) != 1 or t5.data_ptr() % 16:
        return False
    return all(n == 1 or (st * size) % 16 == 0 for n, st in zip(t5.shape[:4], t5.stride()[:4]))


def _staged(t5):
    """``t5`` itself where the kernel can stage it as it is: ``rows_aligned``
    and D * itemsize a multiple of 16 bytes (it copies whole 16-byte
    chunks).  Else a copy with rows padded with zeros to a multiple of 16
    bytes (a new, aligned allocation), counted in
    ``packed_attention.copies``.  The zeros add nothing to a score, and the
    output channels past D are not written."""
    d, per = t5.shape[-1], 16 // t5.element_size()
    if rows_aligned(t5) and d % per == 0:
        return t5
    padded = t5.new_zeros((*t5.shape[:-1], -(-d // per) * per))
    padded[..., :d] = t5
    packed_attention.copies += 1
    return padded[..., :d]


def geometry(q5, k5, v5, o5):
    """The kernel's 25-value geometry: (S0, S1, H, L, D), then the element
    strides of the q, k, v and output views."""
    return _GEOM(*q5.shape, *q5.stride(), *k5.stride(), *v5.stride(), *o5.stride())


def _launch(q5, k5, v5, o5, causal: bool, scale: float):
    """The kernel on (S0, S1, H, L, D) views of q, k, v and the output
    (checked by ``_kernel``: the envelope, and inputs from ``_staged``)."""
    from tante_tpu_torch.ops import _build

    rc = _build.load("packed_attention").tante_packed_attention(
        q5.data_ptr(), k5.data_ptr(), v5.data_ptr(), o5.data_ptr(), geometry(q5, k5, v5, o5),
        int(causal), float(scale), int(q5.dtype == torch.bfloat16), q5.device.index,
        torch.cuda.current_stream(q5.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_attention: CUDA launch failed with cudaError {rc}")
    packed_attention.launches += 1


def kernel_views(tensors, l: int, heads_last: bool):
    """The (S0, S1, H, L, D) views the kernel addresses, and the scale it
    applies to its f32 scores: (*lead, L, H, D) with the lead padded to two
    axes and (H, L) swapped (q unscaled), or (S, P, D) as (S, 1, H, L, D)
    (q pre-scaled)."""
    if heads_last:
        lead = tensors[0].dim() - 3
        if lead > KERNEL_MAX_LEAD:
            raise ValueError(f"the kernel addresses at most {KERNEL_MAX_LEAD} leading axes, got "
                             f"{lead}")
        pad = (None,) * (KERNEL_MAX_LEAD - lead)
        return [t[pad].transpose(-3, -2) for t in tensors], tensors[0].shape[-1] ** -0.5
    return [t.unflatten(1, (t.shape[1] // l, l))[:, None] for t in tensors], 1.0


def _kernel(q, k, v, l: int, causal: bool, heads_last: bool) -> torch.Tensor:
    _check_envelope(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    (q5, k5, v5, o5), scale = kernel_views((q, k, v, out), l, heads_last)
    _check_geometry(q5)
    _launch(_staged(q5), _staged(k5), _staged(v5), o5, causal, scale)
    return out


class _PlainGrad(torch.autograd.Function):
    """Kernel forward; backward = the cotangent pulled through the plain
    version under autograd (``_packed_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, l, causal, heads_last):
        ctx.save_for_backward(q, k, v)
        ctx.args = (l, causal, heads_last)
        return _kernel(q, k, v, l, causal, heads_last)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = _plain(*leaves, *ctx.args)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if n else None for n in need), None, None, None)


def _dispatch(q, k, v, l: int, causal: bool, heads_last: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return _plain(q, k, v, l, causal, heads_last)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _PlainGrad.apply(q, k, v, l, causal, heads_last)
    return _kernel(q, k, v, l, causal, heads_last)


def packed_attention(qp, kp, vp, l: int, causal: bool = False) -> torch.Tensor:
    """(S, P = heads * L, D) head-packed q (pre-scaled by D**-0.5), k, v ->
    (S, P, D): the CUDA kernel on CUDA tensors, the plain version on the CPU."""
    if qp.dim() != 3 or kp.shape != qp.shape or vp.shape != qp.shape or qp.shape[1] % l:
        raise ValueError(f"want q, k, v of one shape (S, P, D) with L = {l} dividing P; got "
                         f"{tuple(qp.shape)}, {tuple(kp.shape)}, {tuple(vp.shape)}")
    return _dispatch(qp, kp, vp, l, causal, heads_last=False)


def packed_head_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """(*lead, L, heads, D) q (unscaled), k, v, any strides -> contiguous
    (*lead, L, heads, D) attention of each head over its own L positions."""
    if q.dim() < 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v of one shape (*lead, L, heads, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _dispatch(q, k, v, q.shape[-3], causal, heads_last=True)


packed_attention.launches = 0
packed_attention.copies = 0  # operands the wrapper copied for the kernel
