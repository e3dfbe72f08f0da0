"""Spatial (H-axis) sharding primitives (counterpart of
``tante_tpu/parallel/halo.py``).  A rank holds a contiguous block of the H
rows of (B, H, W, C) fields (``spatial_sharding``); every function takes and
returns LOCAL tensors, where the JAX ones run inside ``shard_map``.

- ``halo_exchange``: pad the local rows with the neighbours' boundary rows
  (a ring, periodic or with zero edges), the primitive a conv needs;
- ``sharded_conv2d``: a 'same' conv on H-shards, halos first, equal to the
  unsharded conv;
- ``sharded_rfft2`` / ``sharded_irfft2``: the transposed distributed 2-D
  (i)rFFT, a local rFFT along the whole W axis, then an all-to-all so that H
  is whole and the W frequencies are split, a local FFT along H, and an
  all-to-all back (``_transposed_fft_h``);
- ``sharded_spectral_conv2d_centered``: the FNO primitive, below.

The exchanges go through ``parallel/collectives.py``'s ``all_gather`` and
``all_to_all``, built on all-reduce alone: gloo, which runs two ranks on one
card, takes no point-to-point or all-to-all on CUDA tensors.  The halo sends
only boundary rows; the all-to-all holds the gathered spectrum on every rank
for a moment (O(full), where a point-to-point all-to-all holds O(full / n)).

The partial DFT (``ops/spectral.py``: only the kept modes, as dense DFT
matmuls) splits exactly over an H-sharded field:

  forward  the W contraction is local (W is whole); the H contraction runs
           over this rank's rows of the forward H-DFT matrix, and ONE
           ``psum`` of the small (B, m1, m2r, C) mode block completes it;
  mixing   the replicated weight mixes channels on every rank
           (``spectral_mode_matmul``: the kernel on the card);
  inverse  each rank expands only its own H rows (its columns of the inverse
           H matrix); the W inverse is local.

The full field never exists on one rank.
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
from tante_tpu_torch.ops.convs import conv_nhwc
from tante_tpu_torch.parallel.collectives import all_gather, all_to_all, psum


def halo_exchange(x: torch.Tensor, halo: int, mesh, axis_name: str = "sp",
                  periodic: bool = True) -> torch.Tensor:
    """(B, H_loc, W, C) -> (B, H_loc + 2 * halo, W, C): the left (previous)
    rank's last ``halo`` rows above, the right rank's first below; with
    ``periodic=False`` the first rank's top and the last rank's bottom halos
    are zeros (the unsharded 'same' padding)."""
    if halo == 0:
        return x
    n, i = mesh.size(axis_name), mesh.index(axis_name)
    edges = all_gather(torch.stack([x[:, :halo], x[:, -halo:]]), mesh, axis_name)
    from_left, from_right = edges[(i - 1) % n, 1], edges[(i + 1) % n, 0]
    if not periodic:
        if i == 0:
            from_left = torch.zeros_like(from_left)
        if i == n - 1:
            from_right = torch.zeros_like(from_right)
    return torch.cat([from_left, x, from_right], dim=1)


def sharded_conv2d(mesh, kernel: torch.Tensor, x: torch.Tensor, axis_name: str = "sp",
                   periodic: bool = False) -> torch.Tensor:
    """'same' NHWC conv of this rank's rows: kernel (kh, kw, Cin, Cout),
    odd kh / kw; the halo supplies the H padding."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    pad_w = (kw - 1) // 2
    xp = halo_exchange(x, (kh - 1) // 2, mesh, axis_name, periodic=periodic)
    return conv_nhwc(xp, kernel, None, 1, ((0, 0), (pad_w, pad_w)), 1)


def _transposed_fft_h(xf: torch.Tensor, mesh, axis_name: str, inverse: bool) -> torch.Tensor:
    """(i)FFT along the SHARDED H axis of a (B, H_loc, Wf, C) spectrum: an
    all-to-all makes H whole and splits the W frequencies (padded with zero
    columns to a multiple of n, which stay zero and are cut off after), the
    transform runs locally, and an all-to-all puts the axes back.  With a
    local rFFT along W first this is rfft2 (the ortho norms multiply)."""
    n = mesh.size(axis_name)
    wf = xf.shape[2]
    pad = (-wf) % n
    if pad:
        xf = torch.cat([xf, xf.new_zeros((*xf.shape[:2], pad, xf.shape[3]))], dim=2)
    xt = all_to_all(xf, mesh, axis_name, split_dim=2, concat_dim=1)
    xt = (torch.fft.ifft if inverse else torch.fft.fft)(xt, dim=1, norm="ortho")
    out = all_to_all(xt, mesh, axis_name, split_dim=1, concat_dim=2)
    return out[:, :, :wf] if pad else out


def sharded_rfft2(mesh, x: torch.Tensor, axis_name: str = "sp") -> torch.Tensor:
    """rfft2 over (H, W) (ortho) of this rank's rows of (B, H, W, C) ->
    this rank's rows of the spectrum, (B, H_loc, W // 2 + 1, C)."""
    xf = torch.fft.rfft(x, dim=2, norm="ortho")
    return _transposed_fft_h(xf, mesh, axis_name, inverse=False)


def sharded_irfft2(mesh, xf: torch.Tensor, w_size: int, axis_name: str = "sp") -> torch.Tensor:
    """Inverse of ``sharded_rfft2``; ``w_size`` is the full W (the one-sided
    axis does not tell W's parity)."""
    xt = _transposed_fft_h(xf, mesh, axis_name, inverse=True)
    return torch.fft.irfft(xt, n=w_size, dim=2, norm="ortho")


class SpatialSharding:
    """This rank's contiguous block of the H rows (axis 1) of (B, H, W, C)
    arrays or tensors (a view)."""

    def __init__(self, parts: int, index: int):
        self.parts, self.index = parts, index

    def __call__(self, t):
        h = t.shape[1]
        if h % self.parts:
            raise ValueError(f"H of {h} does not split over {self.parts} ranks")
        k = h // self.parts
        return t[:, self.index * k:(self.index + 1) * k]


def spatial_sharding(mesh, axis_name: str = "sp") -> SpatialSharding:
    """(B, H, W, C) with H over ``axis_name``."""
    return SpatialSharding(mesh.size(axis_name), mesh.index(axis_name))


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
