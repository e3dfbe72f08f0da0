"""Tensor-parallel parameter layout (counterpart of
``tante_tpu/parallel/sharding.py``).

The Megatron layout: q/k/v projections split over their output (head)
columns, the attention output projection over its input rows, the MLP's fc1
over its output columns and fc2 over its input rows; one all-reduce after
each half of a block and none inside it.  Everything else (convs, norms,
embeddings, the axis propagators) is replicated.  The rules are the JAX
package's ``_TP_RULES`` on the port's state-dict keys (flax paths with ``/``
-> ``.``); a dimension is split only when it divides by the tp size.

On a module the port splits only what runs split: the parameters of a block
that declares ``tp_shardable(tp)`` (``models/common.py:
FusedTransformerBlock`` with a ``tp_mesh`` and an even geometry).  A block
whose geometry does not split keeps whole weights and computes the unsplit
block on every tp rank; the JAX package shards by divisibility alone and
lets XLA partition that fallback.  Same values (ROADMAP.md section 3).

A split parameter holds this rank's contiguous block and carries the split
dimension as ``tp_dim``; ``gather_params`` and the optimizer-state helpers
undo the split for checkpoints and for ``convert.jax_params_from_state_dict``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from tante_tpu_torch.parallel.collectives import all_reduce

# key regex -> the dimension split over tp: -1 the last (output columns), 0 the first.
_TP_RULES = [
    (re.compile(r"(q_proj|k_proj|v_proj)\.kernel$"), -1),
    (re.compile(r"(q_proj|k_proj|v_proj)\.bias$"), 0),
    (re.compile(r"out_proj\.kernel$"), 0),
    (re.compile(r"fc1\.Dense_0\.kernel$"), -1),
    (re.compile(r"fc1\.Dense_0\.bias$"), 0),
    (re.compile(r"fc2\.Dense_0\.kernel$"), 0),
    # FusedTransformerBlock's flat parameters: the same layout.
    (re.compile(r"(^|\.)(wq|wk|wv|w1)$"), -1),
    (re.compile(r"(^|\.)(bq|bk|bv|b1)$"), 0),
    (re.compile(r"(^|\.)(wo|w2)$"), 0),
]


def _rule(key: str, shape, tp: int) -> Optional[int]:
    for pattern, dim in _TP_RULES:
        if pattern.search(key):
            dim = dim % len(shape)
            return dim if shape[dim] % tp == 0 else None
    return None


def param_shardings(module_or_state, mesh) -> Dict[str, Optional[int]]:
    """Parameter key -> the dimension split over 'tp', or None (replicated).

    A state dict (or any mapping of key -> tensor) gets the rules by key and
    divisibility, as the JAX package's ``param_shardings`` gives its tree;
    a module gets them only for the parameters of blocks that run split.
    A mesh without a 'tp' axis (size 1) splits nothing: the JAX package's
    ``enable_tp`` flag is that case and is not carried over."""
    tp = mesh.size("tp")
    on = tp > 1
    if isinstance(module_or_state, Mapping):
        return {k: _rule(k, v.shape, tp) if on else None for k, v in module_or_state.items()}
    out = {}
    for key, p in module_or_state.named_parameters():
        owner = module_or_state.get_submodule(key.rpartition(".")[0])
        if hasattr(p, "tp_dim"):  # split already
            out[key] = p.tp_dim
        elif on and getattr(owner, "tp_shardable", lambda _: False)(tp):
            out[key] = _rule(key, p.shape, tp)
        else:
            out[key] = None
    return out


def shard_block(p, tp: int, index: int):
    """Rank ``index``'s blocks of one block's flat parameters ``p`` (a
    NamedTuple with ``FusedTransformerBlock``'s names: ``BlockParams`` or a
    half's) over ``tp`` ranks, by the rules above."""
    def cut(name, t):
        dim = _rule(name, t.shape, tp)
        if dim is None:
            return t
        n = t.shape[dim] // tp
        return t.narrow(dim, index * n, n).contiguous()

    return type(p)(*(cut(f, t) for f, t in zip(p._fields, p)))


def _local(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.size("tp")
    return t.narrow(dim, mesh.index("tp") * n, n).clone()


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Replace every parameter that runs split by this rank's contiguous
    block of it, in place (new ``nn.Parameter``s: build the optimizer
    after this).  Returns ``model``."""
    for key, dim in param_shardings(model, mesh).items():
        parent, _, leaf = key.rpartition(".")
        owner = model.get_submodule(parent)
        old = getattr(owner, leaf)
        if dim is None or hasattr(old, "tp_dim"):
            continue
        new = nn.Parameter(_local(old.detach(), dim, mesh), requires_grad=old.requires_grad)
        new.tp_dim = dim
        setattr(owner, leaf, new)
    return model


def _gather(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] *= mesh.size("tp")
    full = t.new_zeros(shape)
    full.narrow(dim, mesh.index("tp") * t.shape[dim], t.shape[dim]).copy_(t)
    return all_reduce(full, mesh.group("tp"))


def _split_dims(model: nn.Module) -> Dict[str, int]:
    return {k: p.tp_dim for k, p in model.named_parameters() if hasattr(p, "tp_dim")}


@torch.no_grad()
def gather_params(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The model's full ``state_dict``: split parameters gathered over 'tp'
    (every rank of the tp group must call this; each gets the result)."""
    dims = _split_dims(model)
    return {k: _gather(v, dims[k], mesh) if k in dims else v
            for k, v in model.state_dict().items()}


def full_shapes(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """Meta tensors with the full shapes of the model's ``state_dict``: the
    template a gathered checkpoint is checked against."""
    dims = _split_dims(model)
    out = {}
    for k, v in model.state_dict().items():
        shape = list(v.shape)
        if k in dims:
            shape[dims[k]] *= mesh.size("tp")
        out[k] = torch.empty(shape, dtype=v.dtype, device="meta")
    return out


def shard_state_dict(model: nn.Module, full: Mapping[str, torch.Tensor], mesh) -> dict:
    """This rank's blocks of a full ``state_dict`` for a model split by
    ``shard_params``."""
    dims = _split_dims(model)
    return {k: _local(v, dims[k], mesh) if k in dims else v for k, v in full.items()}


def _params_in_order(optimizer: torch.optim.Optimizer):
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return params


@torch.no_grad()
def gather_optimizer_state(optimizer: torch.optim.Optimizer, mesh) -> dict:
    """``optimizer.state_dict()`` with the moments of split parameters
    gathered over 'tp' (a collective, like ``gather_params``)."""
    sd = optimizer.state_dict()
    for i, p in enumerate(_params_in_order(optimizer)):
        state = sd["state"].get(i)
        if state is None or not hasattr(p, "tp_dim"):
            continue
        sd["state"][i] = {k: _gather(v, p.tp_dim, mesh) if torch.is_tensor(v) and v.shape == p.shape
                          else v for k, v in state.items()}
    return sd


def shard_optimizer_state(optimizer: torch.optim.Optimizer, full: dict, mesh) -> dict:
    """The inverse of ``gather_optimizer_state``: this rank's blocks of the
    moments of split parameters, ready for ``optimizer.load_state_dict``."""
    sd = {"state": dict(full["state"]), "param_groups": full["param_groups"]}
    for i, p in enumerate(_params_in_order(optimizer)):
        state = sd["state"].get(i)
        if state is None or not hasattr(p, "tp_dim"):
            continue
        n = p.shape[p.tp_dim] * mesh.size("tp")
        sd["state"][i] = {k: _local(v, p.tp_dim, mesh)
                          if torch.is_tensor(v) and v.dim() == p.dim() and v.shape[p.tp_dim] == n
                          else v for k, v in state.items()}
    return sd
