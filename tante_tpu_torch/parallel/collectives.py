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
