"""The collectives of the mesh paths as autograd Functions: the part of
``shard_map`` + ``lax.psum`` that PyTorch leaves to the caller.

Each takes a process group from ``Mesh.group`` and is the identity for
``None`` (an axis of one rank).  All go through
``torch.distributed.all_reduce``, the one collective every backend takes on
CUDA tensors (gloo included, which runs two ranks on one card).

- ``psum``: all-reduce forward, all-reduce backward (``lax.psum`` inside a
  ``shard_map`` whose ranks compute one loss);
- the Megatron pair around a tensor-parallel region: ``copy_to_tp``
  (identity forward, all-reduce backward: at the region's input, so the
  partial input gradients of the shards add up) and ``reduce_from_tp``
  (all-reduce forward, identity backward: on each shard's partial output);
- ``gather_rows``: this rank's rows of a dimension written into a zero tensor
  of the full size and all-reduced; backward keeps this rank's rows (every
  rank computes the same loss on the full tensor).
- ``all_gather``: every rank's tensor, stacked in rank order, by the same
  slot trick; backward all-reduces the gradient and keeps this rank's slot
  (each rank's backward holds its share of the gradient of every slot).  The
  halo exchange of ``parallel/halo.py`` sends only boundary rows through it.
- ``all_to_all``: ``lax.all_to_all(tiled=True)``, as the slices of an
  ``all_gather``: simple and on every backend, but each rank holds the whole
  gathered tensor for a moment (a point-to-point all-to-all moves 1 / n of
  it; gloo takes none on CUDA tensors).  Its backward is the all-to-all with
  the two axes swapped, through the gather's.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Out-of-place sum over ``group`` (``t`` is left alone)."""
    if group is None:
        return t
    y = t.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index, parts):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= parts
        full = x.new_zeros(shape)
        full.narrow(dim, index * ctx.n, ctx.n).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, parts):
        ctx.group, ctx.index = group, index
        full = x.new_zeros((parts, *x.shape))
        full[index].copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group)[ctx.index], None, None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _PSum.apply(x, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_rows(x: torch.Tensor, mesh, axis: str = "sp", dim: int = 2) -> torch.Tensor:
    """The full tensor from every ``axis`` rank's contiguous block of ``dim``."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _GatherRows.apply(x, group, dim, mesh.index(axis), mesh.size(axis))


@torch.no_grad()
def all_reduce_flat(tensors: Iterable[torch.Tensor], group, scale: float = 1.0) -> None:
    """Sum ``tensors`` over ``group`` in place and multiply by ``scale``:
    one flat buffer per dtype, so a step issues one collective per dtype."""
    if group is None:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if scale != 1.0:
            flat.mul_(scale)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): every ``axis`` rank's ``x`` in rank order (complex
    tensors as their real pairs)."""
    group = mesh.group(axis)
    if group is None:
        return x[None]
    if x.is_complex():
        return torch.view_as_complex(all_gather(torch.view_as_real(x), mesh, axis))
    return _AllGather.apply(x, group, mesh.index(axis), mesh.size(axis))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``: rank
    ``i`` keeps block ``i`` of ``split_dim`` from every rank, concatenated
    along ``concat_dim`` in rank order."""
    n, i = mesh.size(axis), mesh.index(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: axis {split_dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    k = x.shape[split_dim] // n
    full = all_gather(x, mesh, axis)
    return torch.cat([full[j].narrow(split_dim, i * k, k) for j in range(n)], dim=concat_dim)
