"""Weights carried across from the JAX package.

A flax param path joined with ``/`` (the layout of
``tante_tpu/assets/tante_flagship.npz`` and of a flattened ``model.init``
tree) maps to the torch state-dict key with ``/`` replaced by ``.``: the
port's modules carry the flax names and layouts (Dense ``(in, out)``, conv
HWIO), so no tensor is transposed.  This is the one layout rule, and it
holds both ways (``jax_params_from_state_dict``) and for the AdamW moments
(``load_optax_adam_state``), so a tree trained in one package loads in the
other.  It holds for flax's other collections too: a model with BatchNorm
keeps its ``batch_stats`` leaves (``mean``, ``var``) as buffers under the
same rule (``load_jax_variables`` / ``jax_variables_from_module``), and a
flax ``nn.scan`` stack keeps its leading depth axis in the port's parameter.
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


def load_jax_params(module: torch.nn.Module, flat: Mapping[str, np.ndarray], mesh=None) -> None:
    """Copy flax-keyed numpy weights into ``module`` (every parameter must
    be present, with its flax shape).  With a tensor-parallel ``mesh`` the
    full weights are loaded and then split (``parallel.shard_params``); a
    module split already takes this rank's blocks of them."""
    from tante_tpu_torch.parallel import sharding

    sd = state_dict_from_jax(flat)
    split = mesh is not None and any(hasattr(p, "tp_dim") for p in module.parameters())
    own = sharding.full_shapes(module, mesh) if split else module.state_dict()
    # Buffers (BatchNorm statistics) are not flax params: keep the module's.
    names = _buffer_keys(module)
    buffers = {k: v for k, v in module.state_dict().items() if k in names}
    own = {k: v for k, v in own.items() if k not in buffers}
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {missing[:8]}, unexpected {extra[:8]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: model has {tuple(own[k].shape)}, weights {tuple(v.shape)}")
    if split:
        module.load_state_dict({**buffers, **sharding.shard_state_dict(module, sd, mesh)})
        return
    module.load_state_dict({**buffers, **sd})
    if mesh is not None:
        sharding.shard_params(module, mesh)


def _buffer_keys(module: torch.nn.Module) -> set:
    return {k for k, _ in module.named_buffers()}


def load_jax_variables(module: torch.nn.Module, params: Mapping[str, np.ndarray],
                       batch_stats: Mapping[str, np.ndarray] | None = None, mesh=None) -> None:
    """A flax variables tree, flattened per collection: ``params`` as
    ``load_jax_params``, then ``batch_stats`` (every BatchNorm ``mean`` /
    ``var``, flax-keyed) into the module's buffers, all of them or none."""
    load_jax_params(module, params, mesh)
    if batch_stats is None:
        return
    stats = state_dict_from_jax(batch_stats)
    own = {k: b for k, b in module.named_buffers() if k in module.state_dict()}
    if set(stats) != set(own):
        raise KeyError(f"batch_stats keys differ from the module's buffers: "
                       f"{sorted(set(stats) ^ set(own))[:8]}")
    with torch.no_grad():
        for k, v in stats.items():
            if tuple(own[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: model has {tuple(own[k].shape)}, "
                                 f"batch_stats {tuple(v.shape)}")
            own[k].copy_(v)


def jax_variables_from_module(module: torch.nn.Module) -> dict[str, dict[str, np.ndarray]]:
    """The way back for a whole module: {"params": ..., "batch_stats": ...},
    each flax-keyed f32 numpy (``batch_stats`` empty without buffers)."""
    flat = jax_params_from_state_dict(module.state_dict())
    stats = {k.replace(".", "/") for k in _buffer_keys(module)}
    return {"params": {k: v for k, v in flat.items() if k not in stats},
            "batch_stats": {k: v for k, v in flat.items() if k in stats}}


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The way back: a torch ``state_dict`` as flax-keyed f32 numpy arrays
    (unflatten on ``/`` for a flax param tree).  Copies: the arrays do not
    follow later in-place updates of the parameters.  A tensor-parallel
    model's full tensors: ``parallel.gather_params(model, mesh)``."""
    return {k.replace(".", "/"): v.detach().float().cpu().numpy().copy() for k, v in sd.items()}


def load_optax_adam_state(optimizer: torch.optim.Optimizer, module: torch.nn.Module, count: int,
                          mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray]) -> None:
    """Set ``torch.optim.AdamW``'s state from an optax ``ScaleByAdamState``
    given as numpy: ``count`` -> every parameter's ``step``, the flax-keyed
    first and second moments ``mu`` / ``nu`` -> ``exp_avg`` / ``exp_avg_sq``."""
    named = {k.replace(".", "/"): p for k, p in module.named_parameters()}
    if set(named) != set(mu) or set(named) != set(nu):
        raise KeyError(f"moment keys differ from the module's parameters: "
                       f"{sorted(set(named) ^ set(mu))[:8]}")
    for key, p in named.items():
        if tuple(mu[key].shape) != tuple(p.shape) or tuple(nu[key].shape) != tuple(p.shape):
            raise ValueError(f"{key}: parameter {tuple(p.shape)}, moments "
                             f"{tuple(mu[key].shape)} / {tuple(nu[key].shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(np.array(mu[key], np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[key], np.float32)).to(p.device),
        }


def seeded_jax_params(module: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Random flax-keyed weights for ``module`` from a numpy seed:
    the fused blocks' LayerNorm scale 1 / bias 0, position embeddings kept
    (sincos), every other tensor ~ U(-1/sqrt(n), 1/sqrt(n)) with n the
    fan-in: the product of all dims but the last (the length of a 1-D
    tensor), and for a tensor with a trailing [re, im] axis (spectral weights
    (Cin, Cout, *modes, 2), Tucker cores and factors) its first dim (Cin;
    each mode mixes Cin inputs) or, for a Tucker factor (dim, rank, 2), the
    rank it is summed over.  Buffers (BatchNorm statistics) are not drawn.
    A module overrides the rule for its own parameters in ``seed_rules``:
    "gain" (1 + the uniform draw: norm weights, soft gates, LayerScale
    gammas, near the identity), "normal" (N(0, 1), the JAX init of embedding
    tables and latents) or "keep" (the module's own values, e.g. a
    coordinate grid)."""
    rng = np.random.default_rng(seed)
    complex_leaves = {
        name for m in module.modules() for name in getattr(m, "mode_space_params", ())}
    out = {}
    buffers = _buffer_keys(module)
    for k, v in module.state_dict().items():
        if k in buffers:
            continue
        *parents, leaf = k.split(".")
        shape = tuple(v.shape)
        rule = getattr(module.get_submodule(".".join(parents)), "seed_rules", {}).get(leaf)

        def uniform(fan_in, offset=0.0):
            bound = 1.0 / math.sqrt(fan_in)
            return (offset + rng.uniform(-bound, bound, size=shape)).astype(np.float32)

        if rule == "keep" or leaf in ("t_emb", "s_emb"):
            a = v.detach().cpu().numpy()
        elif rule == "normal":
            a = rng.normal(size=shape).astype(np.float32)
        elif rule == "gain":
            a = uniform(shape[0], offset=1.0)
        elif leaf.endswith("_scale"):
            a = np.ones(shape, np.float32)
        elif leaf in ("ln1_bias", "ln2_bias"):
            a = np.zeros(shape, np.float32)
        elif leaf in complex_leaves and shape[-1] == 2 and len(shape) >= 3:
            a = uniform(shape[1] if leaf.startswith("factor_") else shape[0])
        else:
            a = uniform(math.prod(shape[:-1]) if len(shape) > 1 else shape[0])
        out[k.replace(".", "/")] = a
    return out
