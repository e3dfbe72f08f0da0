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
import math
from typing import Tuple

import torch

KERNEL_MAX_MODE_DIMS = 3
_GEOM = ctypes.c_longlong * 21
_TILE = ctypes.c_int * 6
# Warps the tile plan aims at, about eight on each of the H100's 132 SMs:
# latency, not bytes or FMAs, decides these small shapes, and the more loads
# are in flight the less of it shows (the templates measured on the card:
# tante_tpu_torch/tools/spectral_tiles.py).
TARGET_WARPS = 1024
OUT_PER_THREAD = 4  # output channels a kernel thread owns (kOT)


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


def tile_plan(b: int, m: int, ci: int, co: int) -> tuple[int, int, int]:
    """The kernel's template for this geometry: (LO, BT, KS) = lanes along
    output channels (1 when Cout <= 4, else 2), batch entries per thread (4 or
    2) and warps splitting the input channels (1, 2, 4 or 8, with at least two
    2-channel chunks per warp).  The first of (KS 1, BT 4), (KS 1, BT 2),
    (KS 2, BT 4), ... that gives ``TARGET_WARPS`` warps: at each split, BT 2
    (each weight read by twice the threads) before a longer split (a longer
    reduction); BT 4 needs more than 2 batch entries and a split below 8.
    At the main path's shapes this is the fastest template of the sweep
    ``tools/spectral_tiles.py`` measured."""
    lo = 1 if co <= OUT_PER_THREAD else 2
    chunks = (ci + 1) // 2
    tile = None
    for ks in (1, 2, 4, 8):
        if ks > 1 and chunks < 2 * ks:
            break
        for bt in ((4, 2) if b > 2 and ks < 8 else (2,)):
            tile = (lo, bt, ks)
            if kernel_warps(b, m, co, tile) >= TARGET_WARPS:
                return tile
    return tile


def kernel_grid(b: int, m: int, co: int, tile: tuple) -> tuple[int, int, int]:
    """(mode tiles, cout tiles, batch tiles) of a launch: a CTA covers
    32 / LO mode pairs x 4 * LO output channels x BT batch entries."""
    lo, bt, _ = tile
    pairs = (m + 1) // 2
    return (-(-pairs // (32 // lo)), -(-co // (OUT_PER_THREAD * lo)), -(-b // bt))


def kernel_warps(b: int, m: int, co: int, tile: tuple) -> int:
    mt, ot, bt = kernel_grid(b, m, co, tile)
    return mt * ot * bt * tile[2]


def _aligned(t: torch.Tensor, elems: int) -> bool:
    return t.data_ptr() % (4 * elems) == 0


def vector_flags(x_re, x_im, w_re, w_im, out_re, out_im) -> tuple[int, int, int]:
    """(wvec, xvec, ovec): the weight's modes flat at stride 2 with im one
    element after re, 16-byte aligned (the stored layout: one float4 holds
    both modes of a pair); x channel-fastest with an even Cin, 8-byte aligned;
    out channel-fastest, Cout % 4 == 0, 16-byte aligned."""
    modes = w_re.shape[:-2]
    stride, want = 2, True
    for n, s in zip(reversed(modes), reversed(w_re.stride()[:-2])):
        if n > 1 and s != stride:
            want = False
        stride *= n
    m = math.prod(modes)
    wvec = (want and m % 2 == 0 and w_im.data_ptr() == w_re.data_ptr() + 4
            and _aligned(w_re, 4) and w_re.stride(-1) % 4 == 0 and w_re.stride(-2) % 4 == 0)
    xvec = (x_re.stride(-1) == 1 and x_re.shape[-1] % 2 == 0 and _aligned(x_re, 2)
            and _aligned(x_im, 2) and all(s % 2 == 0 for s in x_re.stride()[:-1]))
    ovec = (out_re.stride(-1) == 1 and out_re.shape[-1] % 4 == 0 and _aligned(out_re, 4)
            and _aligned(out_im, 4) and all(s % 4 == 0 for s in out_re.stride()[:-1]))
    return int(wvec), int(xvec), int(ovec)


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
    tile = tile_plan(x_re.shape[0], math.prod(modes), x_re.shape[-1], c_out)
    flags = vector_flags(x_re, x_im, w_re, w_im, out_re, out_im)
    rc = _build.load("spectral_matmul").tante_spectral_mode_matmul(
        x_re.data_ptr(), x_im.data_ptr(), w_re.data_ptr(), w_im.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), geom, _TILE(*tile, *flags),
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
