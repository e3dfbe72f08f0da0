"""Fixed-step Trainer (counterpart of ``tante_tpu/train/trainer.py``).

One train step: ``rollout_fixed`` with ``deterministic=False`` -> loss ->
backward -> global-norm clip (1.0) -> AdamW -> schedule step.  bf16 "AMP"
is native mixed precision: activations in bfloat16 through the modules'
compute ``dtype`` while parameters and optimizer state stay float32; no
GradScaler (bf16 has f32's exponent range).

Per-epoch behaviour as in the JAX trainer: LR staircase per epoch, "recent"
saved every epoch and "best" on validation improvement (with a working
``best_val_loss``), ``saved_loss.txt`` appends, scalars
{time_per_train_iter, train_loss, steps_per_sec_per_chip,
frames_per_sec_per_chip, lr, valid}.

CViT (``cvit=True``): a train step samples ``num_query_points`` grid sites
per batch (``sample_query_coords``, the JAX package's numpy stream) and
takes the loss on those points; evaluation reconstructs the full grid in
chunks (``train/evaler.py:cvit_full_grid_rollout``).

Parallelism (``mesh``, a ``parallel.Mesh`` over a process group the
caller initialised; ``data_parallel=True`` without one builds a dp mesh
over the world when it has more than one rank):

- tp > 1: a model with ``tp_mesh`` (TANTE) runs its blocks tensor-parallel
  and ``parallel.shard_params`` leaves this rank's shards in every block
  whose geometry splits; a block that does not split keeps whole weights and
  computes the unsplit block on every tp rank.
- sp > 1: a model with ``sp_mesh`` shards H (FNO: its spectral
  convolutions; AttentionUNet: the whole forward, every 3x3 conv
  halo-exchanging first); batches arrive as this rank's rows and the
  prediction and target are gathered (``gather_rows``) before the loss.
  Other models log a warning and keep H whole.
- dp: batches are split over 'dp'; after backward one all-reduce per
  gradient dtype takes the mean over 'dp' (and the sum over 'sp', whose
  ranks each hold part of one field's gradient).  The clip's global norm is
  the unsplit model's (``optimizers.global_norm``).
- The losses a step returns and the epoch logs are the global batch's, as
  on one device; only rank 0 logs and writes checkpoints, which hold the
  gathered full tensors (a tp checkpoint loads on one device and back).

Mutable model state (BatchNorm statistics, ``ops/norms.py``): a train step
runs the model with ``deterministic=False``, so every BatchNorm takes the
batch's statistics and moves its running ones (buffers, in place) once per
model call, as the JAX scan carries them (``rollout_fixed_stateful``);
validation runs on the running ones.  Under a mesh every BatchNorm's
statistics are the global batch's, summed over the axes that split it ('dp',
'sp') inside autograd.  The statistics are buffers, so checkpoints and resume
carry them.

A parameter the loss does not reach (DPOT's unused cls head) gets a zero
gradient, so AdamW decays it as optax updates every leaf of the tree.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from tante_tpu_torch.data.datamodule import AbstractDataModule, get_formatter
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.norms import BatchNorm
from tante_tpu_torch.parallel import sharding
from tante_tpu_torch.parallel.collectives import all_reduce, all_reduce_flat, gather_rows
from tante_tpu_torch.train.rollout import rollout_fixed
from tante_tpu_torch.utils.checkpoint import CheckpointManager
from tante_tpu_torch.utils.logging import MetricLogger
from tante_tpu_torch.utils.seeding import rank_seed

logger = logging.getLogger(__name__)


def sample_query_coords(rng: np.random.Generator, h: int, w: int, m: int):
    """Random query sites for CViT training: ``m`` distinct grid sites, their
    normalised (h, w) coordinates and indices (the JAX package's function,
    same numpy stream)."""
    flat = rng.permutation(h * w)[:m]
    h_idx, w_idx = flat // w, flat % w
    coords = np.stack(
        [h_idx.astype(np.float32) / (h - 1), w_idx.astype(np.float32) / (w - 1)], axis=-1)
    return coords, h_idx.astype(np.int32), w_idx.astype(np.int32)


def set_compute_dtype(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Switch every module's compute ``dtype`` IN PLACE (the JAX trainer
    clones the model with ``dtype=bfloat16``); parameters keep their storage
    dtype and are cast at use.  A model without a compute dtype of its own
    (AViT) raises ``TypeError``, as ``model.clone(dtype=...)`` does in JAX,
    rather than half-casting its inner layers."""
    if not isinstance(getattr(model, "dtype", None), torch.dtype):
        raise TypeError(f"{type(model).__name__} has no compute dtype: it cannot run in "
                        f"{dtype} mixed precision")
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
    return model


class Trainer:
    def __init__(
        self,
        checkpoint_folder: str,
        formatter: str,
        model: torch.nn.Module,
        datamodule: AbstractDataModule,
        optimizer: Any,  # AdamW spec (train/optimizers.py)
        train_loss_fn: Callable,
        eval_loss_fn: Callable,
        max_epoch: int,
        lr_scheduler: Optional[Any] = None,
        enable_amp: bool = False,
        amp_type: str = "bfloat16",
        checkpoint_path: str = "",
        n_steps_output: int = 1,
        n_steps_rollout: int = 8,
        rt_eps: float = 0.5,
        rt_n: int = 2,
        cvit: bool = False,
        num_query_points: int = 1024,
        seed: int = 0,
        metric_logger: Optional[MetricLogger] = None,
        grad_clip: str = "norm",
        mesh: Optional[Any] = None,
        data_parallel: bool = False,
        device=None,
        **_unused: Any,
    ):
        if mesh is None and data_parallel:
            import torch.distributed as dist

            if dist.is_initialized() and dist.get_world_size() > 1:
                from tante_tpu_torch.parallel import make_mesh

                mesh = make_mesh(axis_names=("dp",), device=device)
        if enable_amp and amp_type != "bfloat16":
            raise ValueError(f"amp_type '{amp_type}': only bfloat16 mixed precision exists")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None and device is None else resolve_device(device)
        self.checkpoint_folder = checkpoint_folder
        self.datamodule = datamodule
        self.train_loss_fn = train_loss_fn
        self.eval_loss_fn = eval_loss_fn
        self.max_epoch = max_epoch
        self.n_steps_output = n_steps_output
        self.n_steps_rollout = n_steps_rollout
        self.rt_eps = rt_eps
        self.rt_n = rt_n
        self.cvit = cvit
        self.num_query_points = num_query_points
        self.rng = np.random.default_rng(seed)  # CViT query sites
        self.starting_epoch = 1
        self.best_val_loss: Optional[float] = None
        self.starting_val_loss = float("inf")

        self.dset_metadata = datamodule.train_dataset.metadata
        self.formatter = get_formatter(formatter, self.dset_metadata)
        self.is_chief = mesh is None or mesh.rank == 0  # logs and writes checkpoints
        self.metric_logger = metric_logger or MetricLogger(checkpoint_folder)

        # f32 master weights on the device; bf16 only as the compute dtype.
        self.model = model.to(self.device, torch.float32)
        if enable_amp:
            set_compute_dtype(self.model, torch.bfloat16)
        self.sp_sharded = False
        if mesh is not None:
            self._place_on_mesh(mesh, datamodule)
        # Dropout masks: the trainer's own generator, on the model's device.
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, mesh))

        steps_per_epoch = max(1, len(datamodule.train_dataloader()))
        self.steps_per_epoch = steps_per_epoch
        if lr_scheduler is not None:
            self.lr_schedule = lr_scheduler.as_step_schedule(steps_per_epoch)
        else:
            self.lr_schedule = optimizer.lr
        self.optimizer, self._clip = optimizer.make(self.model.parameters(), grad_clip=grad_clip,
                                                    mesh=mesh)
        self.global_step = 0
        self.last_grad_norm: Optional[torch.Tensor] = None

        self.ckpt = CheckpointManager(checkpoint_folder)
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)

    def _place_on_mesh(self, mesh, datamodule) -> None:
        """The JAX Trainer's ``clone(tp_mesh=...)`` / ``clone(sp_mesh=...)``
        and ``shard_params``, in place."""
        if mesh.size("tp") > 1 and hasattr(self.model, "tp_mesh"):
            self.model.set_tp_mesh(mesh)
        if mesh.size("sp") > 1:
            if hasattr(self.model, "sp_mesh"):
                self.model.set_sp_mesh(mesh)
                self.sp_sharded = True
            else:
                logger.warning("mesh has an 'sp' axis but %s has no spatial-sharding support "
                               "(sp_mesh); the H axis stays replicated", type(self.model).__name__)
        # BatchNorm statistics over the global batch: every rank that holds
        # another part of it (JAX: the jit reductions over the dp-sharded
        # batch, and stat_axes under sp).
        stat_group = mesh.group("dp", "sp") if self.sp_sharded else mesh.group("dp")
        for m in self.model.modules():
            if isinstance(m, BatchNorm):
                m.group = stat_group
        if mesh.size(*mesh.axis_names) > 1:
            from tante_tpu_torch.parallel.mesh import input_sharding

            if hasattr(datamodule, "sharding"):
                datamodule.sharding = input_sharding(mesh, spatial=self.sp_sharded)
            sharding.shard_params(self.model, mesh)

    def _dp_mean(self, value: torch.Tensor) -> torch.Tensor:
        """A per-rank loss as the global batch's: the mean over 'dp'."""
        if self.mesh is None or self.mesh.size("dp") == 1:
            return value
        return all_reduce(value, self.mesh.group("dp")) / self.mesh.size("dp")

    def _reduce_grads(self) -> None:
        """Mean over 'dp' and sum over 'sp' of every gradient, one
        all-reduce per dtype (tp ranks already agree, or hold their shards')."""
        if self.mesh is None:
            return
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        all_reduce_flat(grads, self.mesh.group("dp", "sp"), 1.0 / self.mesh.size("dp"))

    # ------------------------------------------------------------------
    def _model_chunk(self) -> int:
        """Frames emitted per model call."""
        return int(getattr(self.model, "output_length", 1) or 1)

    def _lr(self, step: int) -> float:
        return float(self.lr_schedule(step)) if callable(self.lr_schedule) else self.lr_schedule

    def _loss(self, x, y, n_steps: int, loss_metric: Callable, deterministic: bool):
        kw = {} if deterministic else {"generator": self.dropout_generator}
        if self.cvit and not deterministic:
            # The loss on num_query_points random grid sites of the frames.
            coords, h_idx, w_idx = sample_query_coords(
                self.rng, y.shape[2], y.shape[3], self.num_query_points)
            y_pts = y[:, :, torch.as_tensor(h_idx, dtype=torch.long, device=y.device),
                      torch.as_tensor(w_idx, dtype=torch.long, device=y.device)]
            y_pred = self.model(x, torch.from_numpy(coords).to(x.device), deterministic=False,
                                **kw)
            if y_pred.shape != y_pts.shape:
                raise ValueError(f"CViT prediction {tuple(y_pred.shape)} != sampled reference "
                                 f"{tuple(y_pts.shape)}; set model.out_steps == "
                                 "trainer.n_steps_output")
            return loss_metric(y_pred.to(y.dtype), y_pts, None).mean()
        if self.cvit:
            # Imported here: train/evaler.py imports this module.
            from tante_tpu_torch.train.evaler import cvit_full_grid_rollout

            y_pred = cvit_full_grid_rollout(self.model, x, y.shape, n_steps,
                                            self.num_query_points)
            return loss_metric(y_pred.to(y.dtype), y, None).mean()
        y_pred = rollout_fixed(
            lambda w: self.model(w, deterministic=deterministic, **kw), x, n_steps,
            self._model_chunk())
        if self.sp_sharded:  # every sp rank takes the loss on the whole field
            y_pred, y = gather_rows(y_pred, self.mesh), gather_rows(y, self.mesh)
        return loss_metric(y_pred.to(y.dtype), y, None).mean()

    def _begin_step(self) -> None:
        """Training mode, the schedule's learning rate at ``global_step``,
        gradients cleared: what comes before a train step's forward."""
        self.model.train()
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr(self.global_step)
        self.optimizer.zero_grad(set_to_none=True)

    def _finish_step(self, loss: torch.Tensor) -> None:
        """Backward, the gradients' reduction over the mesh, the clip and
        the AdamW update."""
        loss.backward()
        for p in self.model.parameters():
            if p.grad is None and p.requires_grad:  # optax updates every leaf
                p.grad = torch.zeros_like(p)
        self._reduce_grads()
        self.last_grad_norm = self._clip(self.model.parameters())
        self.optimizer.step()
        self.global_step += 1

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch; returns the loss (on the device).
        The learning rate is the schedule's at the current ``global_step``."""
        self._begin_step()
        loss = self._loss(x, y, self.n_steps_output, self.train_loss_fn, deterministic=False)
        self._finish_step(loss)
        return self._dp_mean(loss.detach())

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self._dp_mean(
            self._loss(x, y, self.n_steps_rollout, self.eval_loss_fn, deterministic=True))

    # ------------------------------------------------------------------
    def save_model(self, epoch: int, validation_loss: float, name: str) -> None:
        """Under a mesh every rank takes part in gathering the split tensors
        and rank 0 writes them."""
        params, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.mesh is not None:
            params = sharding.gather_params(self.model, self.mesh)
            opt = sharding.gather_optimizer_state(self.optimizer, self.mesh)
        if self.is_chief:
            self.ckpt.save(name, params, opt, epoch, validation_loss, self.best_val_loss)
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()  # the checkpoint exists for every rank from here on

    def load_checkpoint(self, checkpoint_path: str) -> None:
        """Full tensors on every rank, re-split under a mesh."""
        logger.info("Loading checkpoint from %s", checkpoint_path)
        template = (self.model.state_dict() if self.mesh is None
                    else sharding.full_shapes(self.model, self.mesh))
        restored = self.ckpt.restore(checkpoint_path, {"params": template})
        params, opt = restored["params"], restored["opt_state"]
        if self.mesh is not None:
            params = sharding.shard_state_dict(self.model, params, self.mesh)
            opt = sharding.shard_optimizer_state(self.optimizer, opt, self.mesh)
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(opt)
        self.best_val_loss = restored["best_validation_loss"]
        self.starting_val_loss = (
            restored["validation_loss"] if restored["validation_loss"] is not None
            else float("inf"))
        self.starting_epoch = restored["epoch"] + 1
        # The LR schedule is a pure function of the step; fast-forward the count.
        self.global_step = (self.starting_epoch - 1) * self.steps_per_epoch

    # ------------------------------------------------------------------
    def train_one_epoch(self, epoch: int, dataloader) -> tuple:
        n_batches = max(1, len(dataloader))
        batch_frames = 0
        losses = []
        start = time.time()
        for batch in dataloader:
            batch_frames = batch["input"].shape[0] * self.n_steps_output
            (x,), y = self.formatter.process_input(batch)
            losses.append(self.train_step(x, y))
        # One host sync per epoch, not per step: the losses stay on the device.
        epoch_loss = float(torch.stack(losses).sum()) / n_batches if losses else 0.0
        elapsed = time.time() - start
        logs = {
            "time_per_train_iter": elapsed / n_batches,
            "train_loss": epoch_loss,
            "steps_per_sec_per_chip": n_batches / elapsed,
            "frames_per_sec_per_chip": n_batches * batch_frames / elapsed,
            "lr": self._lr(self.global_step),
        }
        return epoch_loss, logs

    def validation_loop(self, dataloader, epoch: int = 0) -> float:
        n_batches = max(1, len(dataloader))
        losses = []
        for batch in dataloader:
            (x,), y = self.formatter.process_input(batch)
            losses.append(self.eval_step(x, y))
        val_loss = float(torch.stack(losses).sum()) / n_batches if losses else 0.0
        if self.is_chief:
            self.metric_logger.append_scalar_file("saved_loss.txt", val_loss)
        return val_loss

    def train(self) -> None:
        train_loader = self.datamodule.train_dataloader()
        val_loader = self.datamodule.val_dataloader()
        val_loss = self.starting_val_loss

        for epoch in range(self.starting_epoch, self.max_epoch + 1):
            train_loader.set_epoch(epoch)
            logger.info("Epoch %d/%d: starting training", epoch, self.max_epoch)
            train_loss, train_logs = self.train_one_epoch(epoch, train_loader)
            logger.info("Epoch %d/%d: avg training loss %s", epoch, self.max_epoch, train_loss)
            if self.is_chief:
                self.metric_logger.log(train_logs, step=epoch)
            self.save_model(epoch, val_loss, "recent")

            logger.info("Epoch %d/%d: starting validation", epoch, self.max_epoch)
            val_loss = self.validation_loop(val_loader, epoch=epoch)
            logger.info("Epoch %d/%d: avg validation loss %s", epoch, self.max_epoch, val_loss)
            if self.is_chief:
                self.metric_logger.log({"valid": val_loss}, step=epoch)
            if self.best_val_loss is None or val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.save_model(epoch, val_loss, "best")
