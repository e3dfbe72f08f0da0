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
its f32 scores, where the plain version scales q in its own dtype first.

Gradients: the Pallas kernel's custom VJP differentiates the XLA core
(``_packed_attention_bwd``); here, on CUDA tensors that need a gradient, the
launch sits in one ``torch.autograd.Function`` whose backward differentiates
the plain version.  There is no backward kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

# heads * L: the gate of the packed branch (``TANTE_PACKED_MAX``) and the kernel's envelope
PACKED_ATTENTION_MAX_TOKENS = 128
KERNEL_HEAD_DIMS = (8, 128)  # D range
KERNEL_MAX_LEAD = 2  # sequence axes the kernel addresses by stride
_GEOM = ctypes.c_longlong * 25


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


def _launch(q5, k5, v5, o5, causal: bool, scale: float):
    """The kernel on (S0, S1, H, L, D) views of q, k, v and the output."""
    from tante_tpu_torch.ops import _build

    s0, s1, h, l, d = q5.shape
    lo, hi = KERNEL_HEAD_DIMS
    if h * l > PACKED_ATTENTION_MAX_TOKENS or not lo <= d <= hi:
        raise ValueError(f"outside the kernel's envelope: heads * L = {h * l} (at most "
                         f"{PACKED_ATTENTION_MAX_TOKENS}), D = {d} (from {lo} to {hi})")
    geom = _GEOM(s0, s1, h, l, d, *q5.stride(), *k5.stride(), *v5.stride(), *o5.stride())
    rc = _build.load("packed_attention").tante_packed_attention(
        q5.data_ptr(), k5.data_ptr(), v5.data_ptr(), o5.data_ptr(), geom, int(causal),
        float(scale), int(q5.dtype == torch.bfloat16), q5.device.index,
        torch.cuda.current_stream(q5.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_attention: CUDA launch failed with cudaError {rc}")
    packed_attention.launches += 1


def _kernel(q, k, v, l: int, causal: bool, heads_last: bool) -> torch.Tensor:
    _check_envelope(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if heads_last:  # (*lead, L, H, D): lead padded to two axes, then (H, L) swapped
        lead = q.dim() - 3
        if lead > KERNEL_MAX_LEAD:
            raise ValueError(f"the kernel addresses at most {KERNEL_MAX_LEAD} leading axes, got "
                             f"{lead}")

        def view(t):
            return t[(None,) * (KERNEL_MAX_LEAD - lead)].transpose(-3, -2)

        scale = q.shape[-1] ** -0.5
    else:  # (S, P, D) -> (S, 1, H, L, D)
        def view(t):
            return t.unflatten(1, (t.shape[1] // l, l))[:, None]

        scale = 1.0
    _launch(view(q), view(k), view(v), view(out), causal, scale)
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
