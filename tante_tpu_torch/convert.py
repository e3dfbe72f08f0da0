"""Weights carried across from the JAX package.

A flax param path joined with ``/`` (the layout of
``tante_tpu/assets/tante_flagship.npz`` and of a flattened ``model.init``
tree) maps to the torch state-dict key with ``/`` replaced by ``.``: the
port's modules carry the flax names and layouts (Dense ``(in, out)``, conv
HWIO), so no tensor is transposed.  This is the one layout rule.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch


def state_dict_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {
        k.replace("/", "."): torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flat.items()
    }


def load_jax_params(module: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy flax-keyed numpy weights into ``module`` (every parameter must
    be present, with its flax shape)."""
    sd = state_dict_from_jax(flat)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {missing[:8]}, unexpected {extra[:8]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: model has {tuple(own[k].shape)}, weights {tuple(v.shape)}")
    module.load_state_dict(sd)


def seeded_jax_params(module: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Random flax-keyed weights for ``module`` from a numpy seed:
    LayerNorm scale 1 / bias 0, position embeddings kept (sincos), every
    other tensor ~ U(-1/sqrt(n), 1/sqrt(n)) with n the fan-in (the length
    of a 1-D tensor)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        shape = tuple(v.shape)
        if leaf.endswith("_scale"):
            a = np.ones(shape, np.float32)
        elif leaf in ("ln1_bias", "ln2_bias"):
            a = np.zeros(shape, np.float32)
        elif leaf in ("t_emb", "s_emb"):
            a = v.detach().cpu().numpy()
        else:
            bound = 1.0 / math.sqrt(math.prod(shape[:-1]) if len(shape) > 1 else shape[0])
            a = rng.uniform(-bound, bound, size=shape).astype(np.float32)
        out[k.replace(".", "/")] = a
    return out
