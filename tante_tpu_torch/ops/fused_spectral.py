"""Per-mode complex channel mixing (counterpart of
``tante_tpu/ops/pallas_spectral.py``): for every retained Fourier mode m

    out[b, m, :] = x[b, m, :] @ w[m, :, :]        (complex)

on separate re / im f32 tensors.  It is the hot product inside every
spectral convolution (``SpectralLayer``, FNO, TFNO, UNO), and every one of
those sites calls ``spectral_mode_matmul`` (``ops/spectral.py``,
``models/uno.py``).

- ``spectral_mode_matmul_ref``: the plain PyTorch version (the JAX
  package's ``spectral_mode_matmul_xla``: four real einsums and the combine).
- ``spectral_mode_matmul``: the wrapper.  A CPU tensor takes the plain
  version; a CUDA tensor launches the hand-written kernel
  ``csrc/spectral_matmul.cu`` (built on first use by ``_build.py``; replaces
  the Pallas kernel reached by ``pallas_spectral.py:spectral_mode_matmul``)
  or raises.  It counts its launches in ``spectral_mode_matmul.launches``.

Operands need not be contiguous and the mode index may have one to three
dimensions: x is ``(B, *modes, Cin)``, w ``(*modes, Cin, Cout)``, both given
as views with whatever strides they have, so a caller passes the weight as
stored (``(Cin, Cout, *modes, 2)``, permuted view of its re or im half) and
x as the partial DFT or an FFT slice left it; nothing is copied, padded or
transposed on the way in.  The result is ``(B, *modes, Cout)`` laid out like
x (the same axis order in memory).

Gradients: the Pallas kernel has no backward kernel and no custom VJP, so
there is none here either.  On CUDA tensors that need a gradient the launch
sits in one ``torch.autograd.Function`` whose backward differentiates the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

KERNEL_MAX_MODE_DIMS = 3
_GEOM = ctypes.c_longlong * 21


def spectral_mode_matmul_ref(x_re, x_im, w_re, w_im) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_*: (B, *modes, Cin); w_*: (*modes, Cin, Cout) -> (out_re, out_im),
    each (B, *modes, Cout)."""
    rr = torch.einsum("b...i,...io->b...o", x_re, w_re)
    ii = torch.einsum("b...i,...io->b...o", x_im, w_im)
    ri = torch.einsum("b...i,...io->b...o", x_re, w_im)
    ir = torch.einsum("b...i,...io->b...o", x_im, w_re)
    return rr - ii, ri + ir


def _check_shapes(x_re, x_im, w_re, w_im):
    modes = tuple(x_re.shape[1:-1])
    if (x_im.shape != x_re.shape or w_im.shape != w_re.shape or not modes
            or tuple(w_re.shape) != (*modes, x_re.shape[-1], w_re.shape[-1])):
        raise ValueError(
            f"want x (B, *modes, Cin) and w (*modes, Cin, Cout), re and im alike; got x "
            f"{tuple(x_re.shape)} / {tuple(x_im.shape)}, w {tuple(w_re.shape)} / "
            f"{tuple(w_im.shape)}")


def mode_fast(w: torch.Tensor) -> bool:
    """Whether a mode axis (not Cout) is the fastest axis of the weight view
    ``(*modes, Cin, Cout)``: the kernel runs a warp's lanes along that axis."""
    strides = [s for s, n in zip(w.stride()[:-2], w.shape[:-2]) if n > 1]
    return bool(strides) and w.shape[-1] > 1 and min(strides) < w.stride(-1)


def _empty_like_layout(x: torch.Tensor, c_out: int) -> torch.Tensor:
    """(…, Cout) f32 tensor of x's shape otherwise, dense, with x's axis
    order in memory."""
    shape = (*x.shape[:-1], c_out)
    if x.is_contiguous():
        return torch.empty(shape, dtype=torch.float32, device=x.device)
    order = sorted(range(x.ndim), key=lambda d: (-x.stride(d), d))
    out = torch.empty([shape[d] for d in order], dtype=torch.float32, device=x.device)
    inverse = [order.index(d) for d in range(x.ndim)]
    return out.permute(inverse)


def _launch(x_re, x_im, w_re, w_im):
    from tante_tpu_torch.ops import _build

    f32 = torch.float32
    for name, t in (("x_re", x_re), ("x_im", x_im), ("w_re", w_re), ("w_im", w_im)):
        if t.device != x_re.device or t.dtype != f32:
            raise ValueError(f"{name}: the kernel takes f32 tensors on one CUDA device, got "
                             f"{t.dtype} on {t.device} (x_re on {x_re.device})")
    modes = tuple(x_re.shape[1:-1])
    if len(modes) > KERNEL_MAX_MODE_DIMS:
        raise ValueError(f"the kernel takes 1 to {KERNEL_MAX_MODE_DIMS} mode dimensions, got "
                         f"{len(modes)}")
    # re and im of a pair share one set of strides in the kernel.
    if x_im.stride() != x_re.stride():
        x_re, x_im = x_re.contiguous(), x_im.contiguous()
    if w_im.stride() != w_re.stride():
        w_re, w_im = w_re.contiguous(), w_im.contiguous()
    c_out = w_re.shape[-1]
    out_re = _empty_like_layout(x_re, c_out)
    out_im = torch.empty_like(out_re)  # preserves out_re's strides (dense)
    if out_re.numel() == 0:
        return out_re, out_im
    if x_re.shape[-1] == 0:
        return out_re.zero_(), out_im.zero_()
    pad = KERNEL_MAX_MODE_DIMS - len(modes)

    def strides5(t, lead):  # leading mode axes of size 1 pad to three
        s = list(t.stride())
        return s[:lead] + [0] * pad + s[lead:]

    geom = _GEOM(x_re.shape[0], *([1] * pad), *modes, x_re.shape[-1], c_out,
                 *strides5(x_re, 1), *strides5(w_re, 0), *strides5(out_re, 1))
    rc = _build.load("spectral_matmul").tante_spectral_mode_matmul(
        x_re.data_ptr(), x_im.data_ptr(), w_re.data_ptr(), w_im.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), geom, int(mode_fast(w_re)),
        x_re.device.index, torch.cuda.current_stream(x_re.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spectral_mode_matmul: CUDA launch failed with cudaError {rc}")
    spectral_mode_matmul.launches += 1
    return out_re, out_im


class _PlainGrad(torch.autograd.Function):
    """Kernel forward; backward = the cotangents pulled through
    ``spectral_mode_matmul_ref`` under autograd."""

    @staticmethod
    def forward(ctx, x_re, x_im, w_re, w_im):
        ctx.save_for_backward(x_re, x_im, w_re, w_im)
        return _launch(x_re, x_im, w_re, w_im)

    @staticmethod
    def backward(ctx, g_re, g_im):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            outs = spectral_mode_matmul_ref(*leaves)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(outs, wanted, (g_re, g_im)))
        return tuple(next(grads) if n else None for n in need)


def spectral_mode_matmul(x_re, x_im, w_re, w_im) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex per-mode matmul on re / im pairs: x_* (B, *modes, Cin), w_*
    (*modes, Cin, Cout), f32, any strides -> (out_re, out_im) (B, *modes,
    Cout).  The CUDA kernel on CUDA tensors, the plain version on the CPU."""
    _check_shapes(x_re, x_im, w_re, w_im)
    if x_re.device.type == "cpu":
        return spectral_mode_matmul_ref(x_re, x_im, w_re, w_im)
    args = (x_re, x_im, w_re, w_im)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _PlainGrad.apply(*args)
    return _launch(*args)


spectral_mode_matmul.launches = 0
