"""Autoregressive rollouts (counterpart of ``tante_tpu/train/rollout.py``).

The JAX package's ``lax.scan`` / ``lax.while_loop`` become Python loops.
Emission semantics are the JAX ones exactly:

- ``rollout_fixed`` / ``rollout_tante_latent``: ceil(n_steps / chunk)
  calls, the window slides by the emitted chunk; ``rollout_fixed_stateful``
  also returns the model's state (BatchNorm statistics) after them.  The
  TANTE form encodes each frame once (latents are cached) and, when the CNN
  pyramid is clean, keeps frames as Morton-packed rows across the decode ->
  Taylor -> encode round trip.
- ``rollout_adaptive_eval`` / ``rollout_adaptive_eval_tante``: each call
  emits ``clip(floor(r_t[0]), 1, K)`` frames (batch-wide, from sample 0),
  or the whole K-frame block with ``force_budget``.  Reading floor(r_t[0])
  is one host sync per model call.
- ``rollout_adaptive_train``: the adaptive trainer's one-frame engine,
  n_steps calls of one frame each, r_t logged; no host sync.
- ``rollout_adaptive_train_vf``: the differentiable variable-frame engine.
  Every sample consumes ``clip(floor(r_t_i), 1, K)`` frames of its K-frame
  block at its own offset; a slot calls the model only while some sample
  still consumes (one host sync per slot to decide).  Ranks that call the
  model together (a tp group, whose every call holds collectives) decide
  each slot together: one all-reduce of one flag, as JAX's SPMD
  ``lax.cond`` decides over the global batch.

Adaptive rollouts return ``(frames, rt_log, n_calls)`` with ``rt_log`` a
(n_steps,) f32 tensor padded with NaN past the realised calls.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from tante_tpu_torch.models.enc_dec_cnn import PATCH_MAP
from tante_tpu_torch.ops.convs import morton_pack_grouped, morton_unpack_grouped
from tante_tpu_torch.parallel.collectives import all_reduce, psum
from tante_tpu_torch.utils.profiling import count, span
from tante_tpu_torch.utils.remat import remat as remat_call


def rollout_fixed(apply_fn: Callable, window: torch.Tensor, n_steps: int, chunk: int):
    """window (B, T, ...) -> (B, n_steps, ...); apply_fn emits ``chunk`` frames."""
    t_in = window.shape[1]
    ys = []
    for _ in range(math.ceil(n_steps / chunk)):
        y = apply_fn(window)
        window = torch.cat([window, y], dim=1)[:, -t_in:]
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :n_steps]


def rollout_fixed_stateful(apply_fn: Callable, window: torch.Tensor, n_steps: int, chunk: int,
                           module: torch.nn.Module):
    """``rollout_fixed`` for a model with mutable state (BatchNorm
    statistics): -> (frames (B, n_steps, ...), the state after the last
    call).  The state is ``module``'s buffers, which each call of
    ``apply_fn`` updates in place, once per call in call order, as the JAX
    scan carries ``batch_stats``; the returned dict holds copies."""
    y = rollout_fixed(apply_fn, window, n_steps, chunk)
    state = module.state_dict(keep_vars=True)
    return y, {k: state[k].detach().clone() for k, _ in module.named_buffers() if k in state}


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


def rollout_adaptive_train(apply_fn: Callable, window: torch.Tensor, n_steps: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame per call, r_t collected.  apply_fn: window -> (frames
    (B, 1, ...), rt (B,)).  -> (y (B, n_steps, ...), rts (n_steps, B))."""
    t_in = window.shape[1]
    ys, rts = [], []
    for _ in range(n_steps):
        frames, rt = apply_fn(window)
        window = torch.cat([window, frames], dim=1)[:, -t_in:]
        ys.append(frames)
        rts.append(rt)
    return torch.cat(ys, dim=1)[:, :n_steps], torch.stack(rts)


def _any_active(active: torch.Tensor, group) -> bool:
    """Whether a slot calls the model: a sample of this rank, or of any rank
    of ``group``, still consumes (one host sync; one all-reduce of one flag
    under a group)."""
    flag = active.any()
    if group is not None:
        flag = all_reduce(flag.float().reshape(1), group)[0] > 0
    count("host_syncs")
    return bool(flag)


def rollout_adaptive_train_vf(
    apply_fn: Callable, window: torch.Tensor, n_steps: int, k: int, remat: bool = False,
    rng: torch.Generator | None = None, group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Variable-frame adaptive training rollout (differentiable).

    apply_fn: window -> (frames (B, k, ...), rt (B,)); k is the model's
    static emission count.  n_steps slots (the one-frame worst case); in
    each, every sample still short of n_steps frames (``active``) consumes
    ``clip(floor(r_t_i), 1, k)`` frames of its block, written into a
    (B, n_steps + k) buffer at its own offset ``cum_i`` and slid into its own
    window.  A finished sample keeps its window and frames: its part of the
    block is blended out before the write.  Frames a later block overwrites
    get zero gradient, so a frame is trained iff it is used.  The reads,
    writes and slides index each sample's offset with index tensors, out of
    place (an in-place write into a buffer autograd saved fails in backward).

    A slot where no sample is active calls no model; it logs rt = 0,
    active = False and the unchanged cum, as JAX's ``lax.cond`` skip branch.
    Deciding that is one host sync per slot.

    remat: recompute each model call in backward (``jax.checkpoint``);
    ``rng``, the dropout generator ``apply_fn`` draws from, is replayed for
    the recompute.

    group: the process group of the ranks that roll out together (under a
    mesh, all of its ranks).  A slot then calls the model while a sample of
    any of them is active, on every one of them: the tp ranks' calls hold
    all-reduces, which would wait forever for a rank that skipped, and a dp
    rank whose own samples are done computes the call JAX's global
    ``lax.cond`` makes for it (its blocks blended out, its r_t logged as
    JAX logs it).
    -> (y (B, n_steps, ...), rts (n_steps, B), actives (n_steps, B) bool,
    cums (n_steps, B) int32: each sample's frame offset before each slot).
    """
    t_in, b, dev = window.shape[1], window.shape[0], window.device
    out = window.new_zeros((b, n_steps + k) + window.shape[2:])
    rows = torch.arange(b, device=dev)[:, None]
    block_idx, window_idx = torch.arange(k, device=dev), torch.arange(t_in, device=dev)
    cum = torch.zeros(b, dtype=torch.long, device=dev)
    rts, actives, cums = [], [], []
    for _ in range(n_steps):
        active = cum < n_steps
        cums.append(cum)
        if not _any_active(active, group):  # every later slot is skipped too
            break
        frames, rt = remat_call(apply_fn, window, rng=rng) if remat else apply_fn(window)
        emit = torch.where(active, torch.floor(rt).long().clamp(1, k), 0)
        # The block lands at the offset clamped into the buffer, as
        # dynamic_update_slice clamps (only a finished sample's offset passes
        # n_steps, and its block is blended back to what is there).
        at = cum.clamp(max=n_steps)[:, None] + block_idx
        mask = active.reshape((b,) + (1,) * (frames.ndim - 1))
        out = out.index_put((rows, at), torch.where(mask, frames.to(out.dtype), out[rows, at]))
        cat = torch.cat([window, frames.to(window.dtype)], dim=1)
        window = cat[rows, emit[:, None] + window_idx]  # emit_i = 0 keeps the window
        rts.append(rt)
        actives.append(active)
        cum = cum + emit
    skipped = n_steps - len(rts)
    rts += [rts[0].new_zeros(b)] * skipped
    actives += [active.new_zeros(b)] * skipped
    cums += [cum] * (n_steps - len(cums))
    return (out[:, :n_steps], torch.stack(rts), torch.stack(actives),
            torch.stack(cums).to(torch.int32))


def _emit(rt: torch.Tensor, k: int, force_budget: bool, group=None) -> tuple[int, torch.Tensor]:
    """-> (the call's emission, its mean r_t).  Under ``group`` (the ranks
    that roll out together) both are the global batch's, as JAX's GSPMD
    rollout reads them: the first sample is group rank 0's (dp rank 0's),
    the mean is over every rank's samples (one all-reduce; the tp ranks of
    a dp rank hold the same samples and count them alike, which leaves the
    mean as it is).  Every rank of the group emits alike, so their model
    calls, and the collectives inside them, stay in step.  With
    ``force_budget`` the host reads nothing."""
    if force_budget:
        return k, _first_and_mean(rt, group)[1]
    with span("rollout.read_rt"):
        first, mean = _first_and_mean(rt, group)
        count("host_syncs")
        return min(max(int(math.floor(float(first))), 1), k), mean


def _first_and_mean(rt: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """The first sample's r_t and the mean r_t, on the device (``_emit``)."""
    if group is None:
        return rt[0], rt.mean().float()
    r = rt.float()
    lead = r[0] if dist.get_rank(group) == 0 else r.new_zeros(())
    s = psum(torch.stack([lead, r.sum(), r.new_tensor(r.numel())]), group)
    return s[0], s[1] / s[2]


def rollout_adaptive_eval(
    apply_fn: Callable, window: torch.Tensor, n_steps: int,
    max_frames_per_call: int = 0, force_budget: bool = False, group=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """apply_fn: window -> (frames (B, K, ...), rt (B,)), K =
    max_frames_per_call or n_steps (capped at n_steps).  ``group``: the
    process group of the ranks that roll out together when ``window`` is
    this rank's block of a global batch (``_emit``)."""
    t_in = window.shape[1]
    k = min(max_frames_per_call if max_frames_per_call > 0 else n_steps, n_steps)
    ys, rts, cum = [], [], 0
    while cum < n_steps:
        frames, rt = apply_fn(window)
        emit, rt_mean = _emit(rt, k, force_budget, group)
        ys.append(frames[:, :emit])
        window = torch.cat([window, frames], dim=1)[:, emit : emit + t_in]
        rts.append(rt_mean)
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
        emit, rt_mean = _emit(rt, k, force_budget)
        ys.append(frames[:, :emit] if out_dtype is None else frames[:, :emit].to(out_dtype))
        win = torch.cat([win, frames.to(win.dtype)], dim=1)[:, emit : emit + t_in]
        u = frames[:, emit - 1 : emit]
        rts.append(rt_mean)
        cum += emit
    y = torch.cat(ys, dim=1)[:, :n_steps]
    return morton_unpack_grouped(y, ps, res), _rt_log(rts, n_steps, window.device), len(rts)
