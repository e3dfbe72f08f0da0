"""Fourier token-mixing primitives shared by AFNO and DPOT (counterpart of
``tante_tpu/ops/fourier.py``).

Block-diagonal complex channel MLPs applied in rfft space: the channel axis
is split into ``num_blocks`` groups and each group gets its own small complex
matrix, computed as four real contractions on the (re, im) pair.  Plain
PyTorch: neither model reaches a hand-written kernel, in JAX or here.
"""

from __future__ import annotations

import torch


def softshrink(x: torch.Tensor, lambd: float) -> torch.Tensor:
    """sign(x) * max(|x| - lambd, 0) (``torch.nn.functional.softshrink``)."""
    return torch.sign(x) * torch.clamp(x.abs() - lambd, min=0.0)


def block_diag_complex_matmul(x_re: torch.Tensor, x_im: torch.Tensor, w_re: torch.Tensor,
                              w_im: torch.Tensor):
    """(..., nb, bs) complex x per-block (nb, bs, bs') complex weights ->
    (out_re, out_im), each (..., nb, bs')."""
    def mm(x, w):
        return torch.einsum("...bi,bio->...bo", x, w)

    return mm(x_re, w_re) - mm(x_im, w_im), mm(x_im, w_re) + mm(x_re, w_im)
