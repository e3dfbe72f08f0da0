"""Seeding utilities (counterpart of ``tante_tpu/utils/seeding.py``).

PyTorch's random state is explicit here too: ``set_seed`` seeds the
host-side RNGs (``random``, numpy: the data pipeline's shuffling) and
returns a ``torch.Generator`` on the requested device for the caller to own
(parameter init, dropout masks).  No global torch seed is set.

Under a mesh (``rank_seed``) the dropout seed is the same on every tp and sp
rank of a data-parallel group, so the masks of replicated activations agree,
and differs across dp ranks, which see different samples.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 0xD3, device="cpu") -> torch.Generator:
    """Seed host-side RNGs and return a seeded generator on ``device``."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return torch.Generator(device=device).manual_seed(seed)


def rank_seed(seed: int, mesh=None) -> int:
    """The dropout seed of this rank: ``seed`` shifted by its 'dp' index."""
    return seed if mesh is None else seed + mesh.index("dp")
