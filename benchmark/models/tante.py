"""TANTE in the benchmark: the program under test built through the port's
normal path, its weights, its plain reference, and its counts.

The program: the configuration file's copy of the repository YAML's
``model`` node through the port's ``instantiate``, then
``Predictor.from_numpy``, as ``Predictor.from_experiment`` builds it.  The weights: the configuration's
asset read as numpy by its path, or drawn on the device from the run's seed
in one call.  Both sides get the same weights and the same inputs; the
reference (``reference/tante.py``) takes nothing the program made.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import numpy as np
import torch

from harness.core import ROOT, derived_seed, rel_l2
from models import tante_count as count
from reference import tante as ref

# The f32 block kernels of the port, by symbol: the single-block kernel
# (canonical T and rearranged blocks) and the chain / group kernel.
BLOCK_KERNELS = re.compile(r"fused_(?:block|chain)_sm90_f32_kernel")


def geometry(config: dict):
    g = config["geometry"]
    return tuple(g["resolution"]), g["n_fields"]


# -- weights ------------------------------------------------------------------------

def _leaf_rule(key: str, shape: tuple):
    """(offset, half-width) of the uniform draw of one leaf: LayerNorm
    scales near 1 and biases near 0, embeddings in [-1, 1], every other
    tensor in +-1/sqrt(fan in) (the product of all dims but the last, or the
    length of a vector)."""
    leaf = key.rsplit("/", 1)[-1]
    if leaf.endswith("_scale"):
        return 1.0, 0.1
    if leaf in ("ln1_bias", "ln2_bias"):
        return 0.0, 0.1
    if leaf in ("t_emb", "s_emb"):
        return 0.0, 1.0
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    return 0.0, 1.0 / math.sqrt(fan_in)


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flax-keyed float32 weights on ``device``."""
    res, n_fields = geometry(config)
    shapes = ref.param_shapes(config["model"], res, n_fields)
    asset = config.get("weights", {}).get("asset")
    if asset:
        with np.load(ROOT / asset) as npz:
            if set(npz.files) != set(shapes):
                raise KeyError(f"{asset}: keys differ from the configuration's: "
                               f"{sorted(set(npz.files) ^ set(shapes))[:8]}")
            return {k: torch.from_numpy(np.asarray(npz[k], np.float32)).to(device)
                    for k in shapes}
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, "weights"))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2).sub_(1)
    out = {}
    for (key, shape), part in zip(shapes.items(), flat.split(sizes)):
        offset, half = _leaf_rule(key, shape)
        out[key] = part.reshape(shape).mul_(half).add_(offset)
    return out


def _numpy(w: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in w.items()}


# -- the program ----------------------------------------------------------------------

def metadata(config: dict):
    from tante_tpu_torch.data.metadata import TanteMetadata

    g = config["geometry"]
    return TanteMetadata(
        dataset_name=g["dataset"], n_spatial_dims=2, spatial_resolution=tuple(g["resolution"]),
        field_names={0: list(g["fields"]), 1: [], 2: []},
        boundary_condition_types=list(g["boundary_conditions"]), n_files=1,
        n_trajectories_per_file=[1], n_steps_per_trajectory=[g["n_steps_per_trajectory"]],
        n_fields=g["n_fields"])


def _program_model(config: dict):
    from tante_tpu_torch.config import instantiate

    return instantiate(config["model"], dset_metadata=metadata(config),
                       seed=config["seed"], device="cpu")


def predictor(config: dict, w: Dict[str, torch.Tensor], device):
    from tante_tpu_torch.serve import Predictor

    return Predictor.from_numpy(_program_model(config), _numpy(w), metadata=metadata(config),
                                device=device)


def rollout_call(pred, traffic: dict):
    """history -> the timed call's answer: (frames, r_t of each call or
    None, calls or None)."""
    n, k = traffic["n_steps"], traffic.get("max_frames_per_call", 0)
    if traffic["api"] == "rollout":
        return lambda h: (pred.rollout(h, n), None, None)
    if traffic["api"] == "rollout_adaptive":
        return lambda h: pred.rollout_adaptive(h, n, max_frames_per_call=k)
    raise ValueError(f"unknown rollout api {traffic['api']!r}")


# -- the reference and the comparisons ----------------------------------------

def reference_rollout(config: dict, w: Dict[str, torch.Tensor], history: torch.Tensor,
                      traffic: dict, precision: str = "f32"):
    model = ref.PlainTANTE(config["model"], w, precision)
    with torch.no_grad(), ref.f32_products():
        if traffic["api"] == "rollout":
            return ref.rollout_fixed(model, history, traffic["n_steps"]), None, None
        frames, rts, emits = ref.rollout_adaptive(model, history, traffic["n_steps"],
                                                  traffic["max_frames_per_call"])
        return frames, np.asarray(rts), len(emits)


def compare_rollout(got, want) -> Dict[str, float]:
    """The numbers compared for one rollout: the frames' relative L2
    distance; for an adaptive rollout also the largest gap of a call's mean
    r_t and the difference in calls."""
    out = {"frames_rel_l2": rel_l2(got[0], want[0])}
    if want[1] is not None:
        calls = abs(int(got[2]) - int(want[2]))
        n = min(len(got[1]), len(want[1]))
        out["rt_gap"] = float(np.max(np.abs(np.asarray(got[1][:n]) - want[1][:n])))
        out["calls_gap"] = float(calls)
    return out


# -- counts -----------------------------------------------------------------------

def emits_of(heads: List[object], traffic: dict) -> List[int]:
    """Frames each head call of a rollout emitted: clip(floor(r_t of the
    first sample), 1, K) for an adaptive call, one otherwise."""
    k = traffic.get("max_frames_per_call", 0) or traffic.get("n_steps", 1)
    return [1 if rt is None else min(max(int(math.floor(float(rt[0]))), 1), k) for rt in heads]


def rollout_ops(config: dict, traffic: dict, emits: List[int]) -> float:
    res, n_fields = geometry(config)
    return count.rollout_ops(config["model"], res, n_fields, traffic["batch"], emits)


def block_bound_s(config: dict, traffic: dict, calls: int, peaks: dict):
    """-> (the least time of ``calls`` model calls' blocks, the bound that
    sets most of it: "operations" or "bytes")."""
    res, _ = geometry(config)
    per_call, kind = count.block_bound_s(config["model"], res, traffic["batch"],
                                         peaks["tf32_flops"], peaks["hbm_bytes_per_s"])
    return calls * per_call, kind
