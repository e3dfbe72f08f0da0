"""Time-adaptive evaluator (counterpart of ``tante_tpu/train/r_evaler.py``).

The batch-level adaptive rollout (``rollout_adaptive_eval_tante``, Morton
fast path where the model has one) at ``out_T = n_steps_rollout``, so the
model emits floor(r_t) frames per call, capped at ``out_T_max`` frames a call
when that is set.  The report adds to the ``Evaler``'s four metrics the mean
r_t, the mean model calls per rollout, the mean rollout wall-clock time and
five-number summaries of the per-batch L2RE and r_t.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from tante_tpu_torch.train.evaler import Evaler
from tante_tpu_torch.train.rollout import rollout_adaptive_eval_tante

logger = logging.getLogger(__name__)


def five_number_summary(data) -> dict:
    arr = np.asarray(data, dtype=np.float64)
    return {
        "min": float(np.min(arr)),
        "q1": float(np.percentile(arr, 25)),
        "median": float(np.median(arr)),
        "q3": float(np.percentile(arr, 75)),
        "max": float(np.max(arr)),
    }


class R_Evaler(Evaler):
    """``out_T_max``: the per-call Taylor frame cap K (0: n_steps_rollout, the
    reference's semantics); exact whenever the realised floor(r_t) <= K."""

    def __init__(self, *args: Any, rt_eps: float = 0.5, rt_n: int = 2, out_T_max: int = 0,
                 **kwargs: Any):
        self.rt_eps = rt_eps
        self.rt_n = rt_n
        self.out_T_max = out_T_max
        self.calls = []  # (rt_log, n_calls) of each rollout
        super().__init__(*args, **kwargs)

    @torch.no_grad()
    def _rollout(self, x: torch.Tensor) -> torch.Tensor:
        """The frames; each rollout's (rt_log, n_calls) goes to ``calls``."""
        n = self.n_steps_rollout
        k = min(self.out_T_max, n) if self.out_T_max else n
        y, rt_log, n_calls = rollout_adaptive_eval_tante(self.model, x, n, max_frames_per_call=k)
        self.calls.append((rt_log, n_calls))
        return y

    def Eval(self, mode: str = "common"):
        test_loader = self.datamodule.test_dataloader()
        if mode == "common":
            (test_loss, std, rt_mean, step_mean, time_used, summary_error,
             summary_rt) = self.validation_loop(test_loader)
            logger.info("Test Loss: %s", test_loss)
            logger.info("std: %s", std)
            logger.info("rt: %s, Step: %s, Time used: %s", rt_mean, step_mean, time_used)
            logger.info("error: %s, rt: %s", summary_error, summary_rt)
            report = {
                "metrics": dict(zip(self.loss_names, test_loss)),
                "variance": dict(zip(self.loss_names, std)),
                "rt_mean": rt_mean,
                "model_calls_per_rollout": step_mean,
                "mean_rollout_time_s": time_used,
                "error_summary": summary_error,
                "rt_summary": summary_rt,
            }
            self.metric_logger.log(report)
            return report

    def validation_loop(self, dataloader):
        """The ``Evaler``'s loop, then the mean r_t and model calls per
        rollout and the five-number summaries of per-batch L2RE and r_t."""
        self.calls = []
        means, variances, time_used = super().validation_loop(dataloader)
        rt_list = [float(rt_log[:n].mean()) for rt_log, n in self.calls]
        steps = [int(n) for _, n in self.calls]
        return (
            means,
            variances,
            sum(rt_list) / max(1, len(rt_list)),
            sum(steps) / max(1, len(steps)),
            time_used,
            five_number_summary(self.batch_losses[1]),
            five_number_summary(rt_list),
        )
