"""Rematerialisation (``jax.checkpoint`` / ``nn.remat``) that replays the
caller's dropout generator.

``torch.utils.checkpoint`` restores the global RNG states for the recompute
(``preserve_rng_state``) but not an explicit ``torch.Generator``: a model
that draws its dropout masks from one would recompute with other masks and
differentiate another function.  ``remat`` winds the generator back to where
the forward found it for the recompute, and forward again afterwards, as
JAX's remat replays its key.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def remat(fn: Callable, *args, rng: Optional[torch.Generator] = None):
    """``fn(*args)`` whose activations are recomputed in backward instead of
    saved; ``rng`` is the generator ``fn`` draws from (None: it draws none)."""
    if rng is None:
        return checkpoint(fn, *args, use_reentrant=False)
    start, calls = rng.get_state(), []

    def run(*a):
        if not calls:
            calls.append(1)
            return fn(*a)
        after = rng.get_state()
        rng.set_state(start)
        try:
            return fn(*a)
        finally:
            rng.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)
