"""Fixed-step Evaler (counterpart of ``tante_tpu/train/evaler.py``).

The 4-metric report (MSE, L2RE, NNMSE, VRMSE, each under its own name) over
the datamodule's test split: per-batch means, across-batch variances
(``ddof=1``) and the mean wall-clock time of a rollout (the clock stops
after ``torch.cuda.synchronize()`` on the card).

Fixed-step TANTE rolls out with cached frame latents
(``rollout_tante_latent``); CViT (``cvit=True``) through
``cvit_full_grid_rollout``: the full H*W query grid in ``num_query_points``
chunks (the last padded with the first sites), the whole model re-run per
chunk, as the JAX package does; every other model through ``rollout_fixed``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from tante_tpu_torch.data.datamodule import AbstractDataModule, get_formatter
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.train.rollout import rollout_fixed, rollout_tante_latent
from tante_tpu_torch.train.trainer import set_compute_dtype
from tante_tpu_torch.utils.checkpoint import CheckpointManager
from tante_tpu_torch.utils.logging import MetricLogger

logger = logging.getLogger(__name__)


def full_grid_coords(h: int, w: int) -> np.ndarray:
    """All (H*W, 2) normalised grid coordinates, row-major."""
    hh, ww = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([hh.flatten() / (h - 1), ww.flatten() / (w - 1)], axis=-1).astype(np.float32)


def cvit_full_grid_rollout(model, x: torch.Tensor, y_shape, n_steps: int,
                           num_query_points: int) -> torch.Tensor:
    """Autoregressive CViT rollout reconstructing the full field per call:
    (B, T, H, W, C) -> (B, n_steps, H, W, C)."""
    b, _, h, w, c = y_shape
    coords = full_grid_coords(h, w)
    n = coords.shape[0]
    pad = (-n) % num_query_points  # padded with the first sites, dropped after
    coords_p = np.concatenate([coords, coords[:pad]], axis=0) if pad else coords
    chunks = torch.from_numpy(coords_p).to(x.device).split(num_query_points)

    def call_model(window):
        ys = torch.cat([model(window, chunk, deterministic=True) for chunk in chunks], dim=2)
        return ys[:, :, :n].reshape(b, ys.shape[1], h, w, c)

    return rollout_fixed(call_model, x, n_steps, int(getattr(model, "output_length", 1) or 1))


class Evaler:
    def __init__(
        self,
        checkpoint_folder: str,
        formatter: str,
        model: torch.nn.Module,
        datamodule: AbstractDataModule,
        eval_loss_fn1: Callable,
        eval_loss_fn2: Callable,
        eval_loss_fn3: Callable,
        eval_loss_fn4: Callable,
        enable_amp: bool = False,
        amp_type: str = "bfloat16",
        checkpoint_path: str = "",
        n_steps_rollout: int = 8,
        batch_size: int = 4,
        cvit: bool = False,
        num_query_points: int = 1024,
        metric_logger: Optional[MetricLogger] = None,
        device=None,
        **_unused: Any,
    ):
        if enable_amp and amp_type != "bfloat16":
            raise ValueError(f"amp_type '{amp_type}': only bfloat16 mixed precision exists")
        self.device = resolve_device(device)
        self.checkpoint_folder = checkpoint_folder
        self.datamodule = datamodule
        self.loss_fns = [eval_loss_fn1, eval_loss_fn2, eval_loss_fn3, eval_loss_fn4]
        self.loss_names = ["MSE", "L2RE", "NNMSE", "VRMSE"]
        self.n_steps_rollout = n_steps_rollout
        self.batch_size = batch_size
        self.cvit = cvit
        self.num_query_points = num_query_points
        self.dset_metadata = datamodule.train_dataset.metadata
        self.formatter = get_formatter(formatter, self.dset_metadata)
        self.metric_logger = metric_logger or MetricLogger(checkpoint_folder)

        # f32 weights on the device; bf16 only as the compute dtype.
        self.model = model.to(self.device, torch.float32).eval()
        if enable_amp:
            set_compute_dtype(self.model, torch.bfloat16)

        self.ckpt = CheckpointManager(checkpoint_folder)
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)

    def load_checkpoint(self, checkpoint_path: str) -> None:
        """Model weights only, validated key by key and shape by shape
        against the model, so a stale checkpoint fails with a clear message."""
        logger.info("Loading checkpoint from %s", checkpoint_path)
        self.model.load_state_dict(
            self.ckpt.restore_params(checkpoint_path, self.model.state_dict()))

    @torch.no_grad()
    def _rollout(self, x: torch.Tensor) -> torch.Tensor:
        if self.cvit:
            y_shape = (x.shape[0], self.n_steps_rollout, *x.shape[2:])
            return cvit_full_grid_rollout(self.model, x, y_shape, self.n_steps_rollout,
                                          self.num_query_points)
        # Fixed-step TANTE caches frame latents (each frame encoded once).
        if isinstance(self.model, TANTE) and self.model.deg:
            return rollout_tante_latent(self.model, x, self.n_steps_rollout)
        chunk = int(getattr(self.model, "output_length", 1) or 1)
        return rollout_fixed(lambda w: self.model(w, deterministic=True), x,
                             self.n_steps_rollout, chunk)

    def Eval(self, mode: str = "common"):
        test_loader = self.datamodule.test_dataloader()
        if mode == "common":
            test_loss, std, time_used = self.validation_loop(test_loader)
            logger.info("Test Loss: %s", test_loss)
            logger.info("std: %s", std)
            logger.info("Time used: %s", time_used)
            report = {
                "metrics": dict(zip(self.loss_names, test_loss)),
                "variance": dict(zip(self.loss_names, std)),
                "mean_rollout_time_s": time_used,
            }
            self.metric_logger.log(report)
            return report

    def validation_loop(self, dataloader):
        """-> (per-metric means, their variances over batches, mean rollout
        time); the per-batch values stay in ``batch_losses``."""
        self.batch_losses = seq_losses = [[] for _ in self.loss_fns]
        times = []
        n_batches = max(1, len(dataloader))
        for batch in dataloader:
            (x,), y = self.formatter.process_input(batch)
            t0 = time.perf_counter()
            y_pred = self._rollout(x)
            if y_pred.device.type == "cuda":
                torch.cuda.synchronize(y_pred.device)
            times.append(time.perf_counter() - t0)
            y_pred = y_pred.to(y.dtype)
            if y_pred.shape != y.shape:
                raise ValueError(f"Mismatching shapes between reference {tuple(y.shape)} and "
                                 f"prediction {tuple(y_pred.shape)}")
            for i, fn in enumerate(self.loss_fns):
                seq_losses[i].append(float(fn(y_pred, y, None).mean()))
        means = [sum(s) / n_batches for s in seq_losses]
        variances = [float(np.var(s, ddof=1)) if len(s) > 1 else 0.0 for s in seq_losses]
        return means, variances, sum(times) / max(1, len(times))
