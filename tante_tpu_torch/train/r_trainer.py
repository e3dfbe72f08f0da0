"""Time-adaptive trainer (counterpart of ``tante_tpu/train/r_trainer.py``).

What it changes in ``Trainer``, as the JAX package does:

- the model is called with ``out_T = train_out_T``.  At the default 1.5 each
  call emits one frame while the confidence head still learns a continuous
  r_t: ``rollout_adaptive_train``, n_steps calls over the whole batch.  At
  ``train_out_T >= 2`` each call emits a static floor(train_out_T)-frame
  Taylor block and every sample consumes floor(r_t_i) of it:
  ``rollout_adaptive_train_vf``, whose model calls are recomputed in backward
  under ``gradient_checkpointing`` (on by default there);
- the loss adds the r_t band penalty, ``MSE(y_pred, y, rt_avg, rt_eps, rt_n,
  rt_band_hi)``, on the mean r_t over the slots where a sample consumed
  frames; with ``rt_supervision > 0`` (vf only) also a per-sample regression
  of each consuming call's r_t onto the number of frames its block stays
  accurate (``rt_sup_mode`` "growth": error at most ``rt_sup_growth`` times
  the block's first-frame error; "abs": at most ``rt_sup_tau``), the target
  detached;
- gradients are clipped by value (1.0) and ``n_steps_output`` defaults to 4;
- an epoch logs rt, rt_var and "steps" (model calls per 4 target frames,
  calls * B / 4) beside the loss; validation rolls out adaptively at
  ``out_T = n_steps_rollout`` (``rollout_adaptive_eval``) and appends the
  mean r_t to ``saved_rt.txt``.

``train_step`` returns (loss, rt_avg, rt_var, calls), 0-d tensors on the
device; an epoch reads them back once.  Under a mesh the r_t statistics are
the global batch's, as JAX's GSPMD step computes them: the masked sums and
the active count are summed over 'dp' (``psum``, whose backward sums the
gradient over 'dp' too) before the band penalty, which is not linear in
them; ``calls`` counts the slots where a sample of any rank was active.
The validation rollout emits by the global batch's first sample (dp rank
0's) and logs the global batch's mean r_t.  Every rank of the mesh decides
the rollouts' slots and emissions together, so the tp ranks' model calls,
whose blocks all-reduce, stay in step (``train/rollout.py``).
"""

from __future__ import annotations

import time
import warnings
from typing import Any

import torch

from tante_tpu_torch.parallel.collectives import psum
from tante_tpu_torch.train.rollout import (
    rollout_adaptive_eval,
    rollout_adaptive_train,
    rollout_adaptive_train_vf,
)
from tante_tpu_torch.train.trainer import Trainer

TRAIN_OUT_T = 1.5  # caps r_t in (1.001, 1.501) -> one frame per call


class R_Trainer(Trainer):
    """``train_out_T`` / ``rt_band_hi``: the reference trains at out_T = 1.5
    and anchors the r_t band at 4, so any rt_eps > 0.5 puts the band out of
    reach under the 1.5 cap (a constant uphill gradient through the
    straight-through clip; the constructor warns).  ``train_out_T >= 2``
    selects the variable-frame engine and ``rt_band_hi`` raises the anchor
    with it.  The defaults are the reference's semantics."""

    def __init__(self, *args: Any, **kwargs: Any):
        kwargs.setdefault("grad_clip", "value")
        kwargs.setdefault("n_steps_output", 4)
        self.train_out_T = float(kwargs.pop("train_out_T", TRAIN_OUT_T))
        self.rt_band_hi = float(kwargs.pop("rt_band_hi", 4.0))
        self.rt_supervision = float(kwargs.pop("rt_supervision", 0.0))
        self.rt_sup_growth = float(kwargs.pop("rt_sup_growth", 4.0))
        self.rt_sup_mode = str(kwargs.pop("rt_sup_mode", "growth"))
        self.rt_sup_tau = float(kwargs.pop("rt_sup_tau", 0.5))
        if self.rt_sup_mode not in ("growth", "abs"):
            raise ValueError(f"rt_sup_mode must be growth|abs: {self.rt_sup_mode}")
        self.vf = self.train_out_T >= 2.0
        self.k = int(self.train_out_T) if self.vf else 1
        self.gradient_checkpointing = bool(kwargs.pop("gradient_checkpointing", self.vf))
        super().__init__(*args, **kwargs)
        band_up = min(1.0 + self.rt_eps, self.rt_band_hi)
        if band_up > self.train_out_T:
            warnings.warn(
                f"r_t band target {band_up} is unreachable under the"
                f" train_out_T={self.train_out_T} cap: the band penalty"
                " becomes a constant uphill gradient through the"
                " straight-through clip and can drift the backbone into"
                " divergence. Raise train_out_T (variable-frame training)"
                " or lower rt_eps/rt_band_hi.",
                stacklevel=2,
            )

    def _dp_group(self):
        return None if self.mesh is None else self.mesh.group("dp")

    def _rollout_group(self):
        """Every rank of the mesh: they decide the adaptive rollouts' slots
        and emissions together (``train/rollout.py``)."""
        return None if self.mesh is None else self.mesh.group(*self.mesh.axis_names)

    def _adaptive_loss(self, x: torch.Tensor, y: torch.Tensor):
        """-> (loss, rt_avg, rt_var, calls, rollout): the objective of one
        train step on this rank's batch, its r_t statistics over the global
        batch, and the rollout's per-slot record on this rank: ``rts``, and
        for the variable-frame engine ``actives`` and ``cums`` too, each
        (n_steps, B)."""
        n_steps, k, group = self.n_steps_output, self.k, self._dp_group()
        gen = self.dropout_generator

        def apply(w):
            return self.model(w, self.train_out_T, deterministic=False, generator=gen)

        if self.vf:
            y_pred, rts, actives, cums = rollout_adaptive_train_vf(
                apply, x, n_steps, k, remat=self.gradient_checkpointing, rng=gen,
                group=self._rollout_group())
            w = actives.to(rts.dtype)
            n_act = torch.clamp(psum(w.sum(), group), min=1.0)
            rt_avg = psum((rts * w).sum(), group) / n_act
            with torch.no_grad():
                rt_var = torch.sqrt(psum(((rts - rt_avg) ** 2 * w).sum(), group) / n_act)
                # A slot ran one real model call iff a sample was consuming in it.
                calls = (psum(actives.any(dim=1).float(), group) > 0).sum().float()
        else:
            y_pred, rts = rollout_adaptive_train(apply, x, n_steps)
            actives = cums = None
            n = rts.numel() * (1 if group is None else self.mesh.size("dp"))
            rt_avg = psum(rts.sum(), group) / n
            with torch.no_grad():  # jnp.std(rts, ddof=1) over the global batch
                rt_var = torch.sqrt(psum(((rts - rt_avg) ** 2).sum(), group) / (n - 1))
            calls = torch.tensor(float(n_steps), device=x.device)
        y_pred = y_pred.to(y.dtype)
        loss = self.train_loss_fn(y_pred, y, rt_avg, self.rt_eps, self.rt_n, self.rt_band_hi)
        if self.vf and self.rt_supervision > 0.0:
            target = self._rt_target(y_pred, y, cums)
            sup = (rts - target) ** 2
            loss = loss + self.rt_supervision * psum((sup * w).sum(), group) / n_act
        rollout = {"rts": rts.detach(), "actives": actives, "cums": cums}
        return loss, rt_avg.detach(), rt_var, calls, rollout

    @torch.no_grad()
    def _rt_target(self, y_pred, y, cums) -> torch.Tensor:
        """(n_steps, B): for each slot and sample, how many frames of its
        k-frame block, starting at its offset, stay accurate in a row
        (clipped to [1, k]); the per-frame error is edge-padded so every
        window stays in bounds."""
        k, n_steps = self.k, self.n_steps_output
        err = ((y_pred - y) ** 2).mean(dim=tuple(range(2, y.ndim)))  # (B, n_steps)
        err_pad = torch.cat([err, err[:, -1:].expand(-1, k)], dim=1)
        at = cums.long().clamp(max=n_steps)[..., None] + torch.arange(k, device=err.device)
        blk_err = err_pad[torch.arange(err.shape[0], device=err.device)[None, :, None], at]
        if self.rt_sup_mode == "abs":
            ok = blk_err <= self.rt_sup_tau
        else:
            ok = blk_err <= self.rt_sup_growth * blk_err[..., :1] + 1e-8
        good = torch.cumprod(ok.to(err.dtype), dim=-1)
        return good.sum(dim=-1).clamp(1.0, float(k))

    def train_step(self, x: torch.Tensor, y: torch.Tensor):
        """One optimizer step -> (loss, rt_avg, rt_var, calls) on the device."""
        self._begin_step()
        loss, rt_avg, rt_var, calls, _ = self._adaptive_loss(x, y)
        self._finish_step(loss)
        return self._dp_mean(loss.detach()), rt_avg, rt_var, calls

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor, y: torch.Tensor):
        """Adaptive rollout at out_T = n_steps_rollout -> (loss, rt_log,
        n_calls)."""
        self.model.eval()
        n = self.n_steps_rollout
        y_pred, rt_log, n_calls = rollout_adaptive_eval(lambda w: self.model(w, float(n)), x, n,
                                                        group=self._rollout_group())
        loss = self.eval_loss_fn(y_pred.to(y.dtype), y, None).mean()
        return self._dp_mean(loss), rt_log, n_calls

    # ------------------------------------------------------------------
    def train_one_epoch(self, epoch: int, dataloader) -> tuple:
        n_batches = max(1, len(dataloader))
        dp = 1 if self.mesh is None else self.mesh.size("dp")
        stats, batch = [], 0
        start = time.time()
        for b in dataloader:
            (x,), y = self.formatter.process_input(b)
            batch = x.shape[0] * dp
            stats.append(torch.stack([t.float() for t in self.train_step(x, y)]))
        # One host sync per epoch (the vf engine syncs once per slot besides).
        loss, rt, rt_var, calls = (torch.stack(stats).cpu().double().T if stats
                                   else torch.zeros(4, 1, dtype=torch.float64))
        epoch_loss = float(loss.sum()) / n_batches
        logs = {
            "time_per_train_iter": (time.time() - start) / n_batches,
            "train_loss": epoch_loss,
            "rt": float(rt.mean()),
            "rt_var": float(rt_var.mean()),
            # Model calls per 4 target frames (the reference's len(Rts) / 4 for
            # its batch of one; the batch shares one call sequence here).
            "steps": float(calls.mean()) * batch / 4,
            "lr": self._lr(self.global_step),
        }
        return epoch_loss, logs

    def validation_loop(self, dataloader, epoch: int = 0) -> float:
        n_batches = max(1, len(dataloader))
        losses, rts = [], []
        for batch in dataloader:
            (x,), y = self.formatter.process_input(batch)
            loss, rt_log, n_calls = self.eval_step(x, y)
            losses.append(loss)
            rts.append(rt_log[:n_calls])
        val_loss = float(torch.stack(losses).sum()) / n_batches if losses else 0.0
        if self.is_chief:
            self.metric_logger.append_scalar_file("saved_loss.txt", val_loss)
            if rts:
                self.metric_logger.append_scalar_file("saved_rt.txt", float(torch.cat(rts).mean()))
        return val_loss
