"""Process mesh and axis conventions (counterpart of ``tante_tpu/parallel/mesh.py``).

  dp  data parallelism: every batch is split over 'dp'; parameters are
      replicated and the Trainer all-reduces their gradients.
  tp  tensor parallelism: the heads of a transformer block's q/k/v and the
      hidden units of its MLP are split over 'tp' (the Megatron layout,
      ``parallel/sharding.py``); each block all-reduces twice
      (``ops/fused_block.py:fused_block_apply_tp``).
  sp  spatial sharding of the H axis (FNO's spectral convolutions,
      ``parallel/halo.py``).

A ``Mesh`` is this process's view of a row-major grid of the world's ranks
(rank ``r`` sits at ``np.unravel_index(r, shape)``, as JAX reshapes its
device list): the axis names and sizes, this rank's coordinates, one
``torch.distributed`` process group for every set of axes, and the device
this rank computes on.  The caller initialises the default process group
(``torchrun``, or ``init_process_group`` with an address, world size and
rank); ``make_mesh`` refuses to guess one.  The groups use the default
group's backend: NCCL across cards, gloo where ranks share a card (NCCL
refuses two ranks on one device).
"""

from __future__ import annotations

import itertools
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tante_tpu_torch.ops.backend import resolve_device


class Mesh:
    """This rank's place in a grid of ranks; see the module docstring."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               (int(i) for i in np.unravel_index(self.rank, self.shape))))
        self.device = device
        grid = np.arange(int(np.prod(self.shape))).reshape(self.shape)
        # Every rank creates every group, in the same order (new_group is
        # collective); a rank keeps the one group of each axis set it is in.
        self._groups = {}
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for axes in itertools.combinations(range(n), k):
                rest = [i for i in range(n) if i not in axes]
                lines = np.moveaxis(grid, rest + list(axes), range(n)).reshape(
                    -1, int(np.prod([self.shape[i] for i in axes])))
                for ranks in lines:
                    group = dist.new_group([int(r) for r in ranks])
                    if self.rank in ranks:
                        self._groups[tuple(self.axis_names[i] for i in axes)] = group

    def size(self, *axes: str) -> int:
        """Ranks along ``axes`` together (1 for an axis the mesh lacks)."""
        sizes = dict(zip(self.axis_names, self.shape))
        return int(np.prod([sizes.get(a, 1) for a in axes]))

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes`` (the mesh's order); None when that is this rank
        alone, which every collective of ``parallel/collectives.py`` reads
        as "nothing to reduce"."""
        present = tuple(a for a in self.axis_names if a in axes)
        if self.size(*present) == 1:
            return None
        return self._groups[present]

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, rank {self.rank} at {self.coords})"


def _rank_device(device) -> torch.device:
    """CUDA ``cuda:<local rank % cards>`` unless the caller names a device;
    with one card every rank computes on ``cuda:0``."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    shape: Optional[Tuple[int, ...]] = None,
    device=None,
) -> Mesh:
    """A mesh over the world's ``n_devices`` ranks (all of them by default).

    If ``shape`` is omitted, every rank goes to the first axis ('dp') and
    the trailing axes get size 1.  Raises when no default process group is
    initialised, when ``n_devices`` is not the world size, or when the
    shape does not multiply out to it."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group first "
                           "(torchrun, or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: requested {n} devices but the process group has {world} "
                         "ranks")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axis_names)} != {n} ranks")
    return Mesh(axis_names, shape, _rank_device(device))


def dp_tp_mesh(n_devices: int, tp: Optional[int] = None, device=None) -> Mesh:
    """A (dp, tp) mesh; tp defaults to 2 when divisible, else 1."""
    if tp is None:
        tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return make_mesh(n_devices, ("dp", "tp"), (n_devices // tp, tp), device=device)


class BatchSlice:
    """This rank's part of a global batch: axis 0 split over ``dp`` and,
    with ``sp > 1``, axis 2 (H of a (B, T, H, W, C) field) over ``sp``, in
    contiguous blocks.  Works on numpy arrays and tensors alike (a view)."""

    def __init__(self, dp: int = 1, dp_index: int = 0, sp: int = 1, sp_index: int = 0):
        self.dp, self.dp_index, self.sp, self.sp_index = dp, dp_index, sp, sp_index

    @staticmethod
    def _block(n: int, parts: int, i: int, what: str) -> slice:
        if n % parts:
            raise ValueError(f"{what} of {n} does not split over {parts} ranks")
        k = n // parts
        return slice(i * k, (i + 1) * k)

    def local_batch(self, items):
        """This rank's entries of the global batch ``items`` (axis 0)."""
        return items[self._block(len(items), self.dp, self.dp_index, "a batch")]

    def local_field(self, t):
        """This rank's H rows of a batched field (axis 2)."""
        if self.sp == 1:
            return t
        return t[:, :, self._block(t.shape[2], self.sp, self.sp_index, "H")]

    def __call__(self, t):
        return self.local_field(self.local_batch(t))


def batch_sharding(mesh: Mesh) -> BatchSlice:
    """Axis 0 (batch) over 'dp'; everything else replicated."""
    return BatchSlice(mesh.size("dp"), mesh.index("dp"))


def input_sharding(mesh: Mesh, spatial: bool = False) -> BatchSlice:
    """(B, T, H, ...) model inputs: batch over 'dp' and, when ``spatial``
    and the mesh has an 'sp' axis, H (axis 2) over 'sp'."""
    if spatial and mesh.size("sp") > 1:
        return BatchSlice(mesh.size("dp"), mesh.index("dp"), mesh.size("sp"), mesh.index("sp"))
    return batch_sharding(mesh)


def replicated(mesh: Mesh) -> BatchSlice:
    """Every rank holds the whole array."""
    return BatchSlice()
