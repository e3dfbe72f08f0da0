"""Spatial (H-axis) sharding of the FNO primitive (counterpart of
``tante_tpu/parallel/halo.py:sharded_spectral_conv2d_centered``).

The partial DFT (``ops/spectral.py``: only the kept modes, as dense DFT
matmuls) splits exactly over an H-sharded field:

  forward  the W contraction is local (W is whole); the H contraction runs
           over this rank's rows of the forward H-DFT matrix, and ONE
           ``psum`` of the small (B, m1, m2r, C) mode block completes it;
  mixing   the replicated weight mixes channels on every rank
           (``spectral_mode_matmul``: the kernel on the card);
  inverse  each rank expands only its own H rows (its columns of the inverse
           H matrix); the W inverse is local.

The full field never exists on one rank.  ``halo_exchange``,
``sharded_conv2d`` and ``sharded_rfft2`` / ``sharded_irfft2`` of the JAX
module serve only AttentionUNet and need point-to-point and all-to-all
collectives; they wait for that model (ROADMAP.md item 17).
"""

from __future__ import annotations

import torch

from tante_tpu_torch.ops.spectral import (
    _centered,
    _partial_irdft2,
    _partial_rdft2,
    dft_mats,
    mix_modes,
)
from tante_tpu_torch.parallel.collectives import psum


def sharded_spectral_conv2d_centered(mesh, x: torch.Tensor, weight: torch.Tensor, modes1: int,
                                     modes2: int, axis_name: str = "sp") -> torch.Tensor:
    """``spectral_conv2d_centered`` on this rank's block of H rows.

    x: LOCAL (B, H / n, W, C) f32, rank ``i`` of the ``axis_name`` axis
    holding rows [i * H / n, (i + 1) * H / n); weight: (Cin, Cout, m1, m2r, 2)
    replicated.  Returns this rank's rows of the output, (B, H / n, W, Cout).
    Equal to the unsharded op up to f32 summation order."""
    n, i = mesh.size(axis_name), mesh.index(axis_name)
    h_loc, w = x.shape[1], x.shape[2]
    h = h_loc * n
    m1, m1_pos, m1_neg, m2r = _centered(modes1, modes2, h, w)
    if m1 == 0 or m2r == 0:
        return x.new_zeros((*x.shape[:-1], weight.shape[1]))
    mats = dft_mats(x, h, w, m1_pos, m1_neg, m2r)
    rows = slice(i * h_loc, (i + 1) * h_loc)
    # This rank's rows of the forward H-DFT matrix / columns of the inverse.
    mats = mats._replace(fh_cos=mats.fh_cos[rows], fh_sin=mats.fh_sin[rows],
                         ih_cos=mats.ih_cos[:, rows], ih_sin=mats.ih_sin[:, rows])
    xr, xi = _partial_rdft2(x, mats)
    # The one collective: re and im together.
    xr, xi = psum(torch.stack([xr, xi]), mesh.group(axis_name))
    o_re, o_im = mix_modes(xr, xi, weight, (slice(None), slice(0, m2r)))
    return _partial_irdft2(o_re, o_im, mats)
