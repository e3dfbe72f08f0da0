"""Autoregressive rollouts (counterpart of ``tante_tpu/train/rollout.py``).

The JAX package's ``lax.scan`` / ``lax.while_loop`` become Python loops.
Emission semantics are the JAX ones exactly:

- ``rollout_fixed`` / ``rollout_tante_latent``: ceil(n_steps / chunk)
  calls, the window slides by the emitted chunk.  The TANTE form encodes
  each frame once (latents are cached) and, when the CNN pyramid is clean,
  keeps frames as Morton-packed rows across the decode -> Taylor -> encode
  round trip.
- ``rollout_adaptive_eval`` / ``rollout_adaptive_eval_tante``: each call
  emits ``clip(floor(r_t[0]), 1, K)`` frames (batch-wide, from sample 0),
  or the whole K-frame block with ``force_budget``.  Reading floor(r_t[0])
  is one host sync per model call.

Adaptive rollouts return ``(frames, rt_log, n_calls)`` with ``rt_log`` a
(n_steps,) f32 tensor padded with NaN past the realised calls.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from tante_tpu_torch.models.enc_dec_cnn import PATCH_MAP
from tante_tpu_torch.ops.convs import morton_pack_grouped, morton_unpack_grouped


def rollout_fixed(apply_fn: Callable, window: torch.Tensor, n_steps: int, chunk: int):
    """window (B, T, ...) -> (B, n_steps, ...); apply_fn emits ``chunk`` frames."""
    t_in = window.shape[1]
    ys = []
    for _ in range(math.ceil(n_steps / chunk)):
        y = apply_fn(window)
        window = torch.cat([window, y], dim=1)[:, -t_in:]
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :n_steps]


def rollout_tante_latent(model, x: torch.Tensor, n_steps: int, out_dtype=None):
    """Fixed-step TANTE rollout with cached frame latents.

    out_dtype: storage dtype of the EMITTED frames only; the Taylor
    expansion point rides at full precision either way."""
    t_in = model.in_T
    chunk = int(model.output_length or 1)
    x = x[:, -t_in:]
    n_calls = math.ceil(n_steps / chunk)
    if model.morton_io_ok():
        ps = PATCH_MAP[model.patch_scale]
        res = tuple(x.shape[2:4])
        lat = model.encode(morton_pack_grouped(x.to(model.dtype), ps), packed="morton")
        u = morton_pack_grouped(x[:, -1:], ps)
        packed = "morton"
    else:
        lat = model.encode(x)
        u = x[:, -1:]
        packed = False
    ys = []
    for _ in range(n_calls):
        frames = model.head(lat, u, packed=packed)
        new_lat = model.encode(frames, packed=packed)
        lat = torch.cat([lat, new_lat], dim=1)[:, -t_in:]
        ys.append(frames if out_dtype is None else frames.to(out_dtype))
        u = frames[:, -1:]
    y = torch.cat(ys, dim=1)[:, :n_steps]
    return morton_unpack_grouped(y, ps, res) if packed else y


def _emit(rt: torch.Tensor, k: int, force_budget: bool) -> int:
    if force_budget:
        return k
    return min(max(int(math.floor(float(rt[0]))), 1), k)


def rollout_adaptive_eval(
    apply_fn: Callable, window: torch.Tensor, n_steps: int,
    max_frames_per_call: int = 0, force_budget: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """apply_fn: window -> (frames (B, K, ...), rt (B,)), K =
    max_frames_per_call or n_steps (capped at n_steps)."""
    t_in = window.shape[1]
    k = min(max_frames_per_call if max_frames_per_call > 0 else n_steps, n_steps)
    ys, rts, cum = [], [], 0
    while cum < n_steps:
        frames, rt = apply_fn(window)
        emit = _emit(rt, k, force_budget)
        ys.append(frames[:, :emit])
        window = torch.cat([window, frames], dim=1)[:, emit : emit + t_in]
        rts.append(rt.mean().float())
        cum += emit
    return torch.cat(ys, dim=1)[:, :n_steps], _rt_log(rts, n_steps, window.device), len(rts)


def _rt_log(rts, n_steps, device) -> torch.Tensor:
    log = torch.full((n_steps,), float("nan"), dtype=torch.float32, device=device)
    log[: len(rts)] = torch.stack(rts)
    return log


def rollout_adaptive_eval_tante(
    model, window: torch.Tensor, n_steps: int, max_frames_per_call: int = 0,
    out_dtype=None, force_budget: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``rollout_adaptive_eval`` for TANTE on Morton-packed frames: the
    window rides in the compute dtype, u(0) at full precision, and the
    physical layout is restored once after the loop.  Falls back to the
    generic engine when the model has no Morton path.

    out_dtype: storage dtype of the emitted frames."""
    k = min(max_frames_per_call if max_frames_per_call > 0 else n_steps, n_steps)
    if not model.morton_io_ok():
        y, rt_log, n_calls = rollout_adaptive_eval(
            lambda w: model(w, float(k)), window, n_steps, k, force_budget
        )
        return (y if out_dtype is None else y.to(out_dtype)), rt_log, n_calls

    t_in = model.in_T
    window = window[:, -t_in:]
    ps = PATCH_MAP[model.patch_scale]
    res = tuple(window.shape[2:4])
    win = morton_pack_grouped(window.to(model.dtype), ps)
    u = morton_pack_grouped(window[:, -1:], ps)
    ys, rts, cum = [], [], 0
    while cum < n_steps:
        lat = model.encode(win, packed="morton")
        frames, rt = model.head(lat, u, float(k), packed="morton")
        emit = _emit(rt, k, force_budget)
        ys.append(frames[:, :emit] if out_dtype is None else frames[:, :emit].to(out_dtype))
        win = torch.cat([win, frames.to(win.dtype)], dim=1)[:, emit : emit + t_in]
        u = frames[:, emit - 1 : emit]
        rts.append(rt.mean().float())
        cum += emit
    y = torch.cat(ys, dim=1)[:, :n_steps]
    return morton_unpack_grouped(y, ps, res), _rt_log(rts, n_steps, window.device), len(rts)
