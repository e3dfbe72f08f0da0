"""Batch-inference serving API (counterpart of ``tante_tpu/serve.py``).

    from tante_tpu_torch.serve import Predictor
    p = Predictor.from_experiment("tante", experiment="TANTE_AM", root_path=".",
                                  choose="best")          # config + trained checkpoint
    p = Predictor.from_numpy(model, flat_params)            # flax-keyed npz dict
    frames = p.rollout(history, n_steps=16)                 # (B, 16, H, W, C)
    frames, rt, calls = p.rollout_adaptive(history, 16, max_frames_per_call=8)

Fixed-step TANTE rollouts use the latent-caching path; adaptive models use
the adaptive loop, where a large r_t genuinely skips model calls; any other
model (FNO, TFNO, UNO, AViT, CViT on the full grid) rolls out through
``rollout_fixed``.  A Predictor serves on the card unless it is given
``device="cpu"``; results are tensors on its device.
"""

from __future__ import annotations

import os
from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from tante_tpu_torch.config import instantiate, load_config, set_ckpt
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.train.rollout import (
    rollout_adaptive_eval_tante,
    rollout_fixed,
    rollout_tante_latent,
)
from tante_tpu_torch.train.trainer import set_compute_dtype
from tante_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from tante_tpu_torch.utils.profiling import count, span


class Predictor:
    """Serves ``model`` on ``device``: the card unless the caller passes
    "cpu", wherever the model was built.

    The model's parameters are cast IN PLACE to its compute dtype
    (``model.dtype``): every use casts them to that dtype anyway, so the
    outputs are bit-identical, and a bf16 model call then launches no
    per-call weight casts (~180 fewer small kernels per TANTE call).  The
    exception are the spectral weights (a module names them in
    ``mode_space_params``): mode space is f32 under every compute dtype, so
    they stay f32; so do the parameters a module names in ``f32_params``
    (LayerNorm's, CViT's embeddings and RBF grid: the JAX package computes
    with them in f32).  The parameters also stop requiring gradients: serving
    takes none, and ``torch.matmul`` of a 2-D weight that requires a gradient
    with a batched field folds the field into a matrix, which for a
    channel-major field is a transposing copy of the whole field per layer."""

    def __init__(self, model: torch.nn.Module, metadata: Any = None, device=None):
        self.device = resolve_device(device)
        dtype = getattr(model, "dtype", None) or torch.float32
        keep = {id(m._parameters[name]) for m in model.modules()
                for name in getattr(m, "mode_space_params", ()) + getattr(m, "f32_params", ())}
        with span("serve.place"):
            model.to(self.device).requires_grad_(False)
            for t in (*model.parameters(), *model.buffers()):
                if t.is_floating_point() and id(t) not in keep:
                    t.data = t.data.to(dtype)
        self.model = model.eval()
        self.metadata = metadata

    @classmethod
    def from_experiment(cls, config_name: str, experiment: Optional[str] = None,
                        root_path: Optional[str] = None, choose: str = "best",
                        overrides: Optional[List[str]] = None, config_dir: Optional[str] = None,
                        device=None) -> "Predictor":
        """A trained experiment: the config (with ``overrides``; ``experiment``
        and ``root_path`` replace the config's), its datamodule for the
        metadata, the model with the ``choose`` checkpoint's weights
        (``<root_path>/experiments/<experiment>/<choose>/state.pt``), in the
        evaler's compute dtype (bf16 under ``evaler.enable_amp``, as the
        ``Evaler`` evaluates it; f32 as the shipped configs set it, where
        TANTE's blocks run the f32 kernels).  Raises FileNotFoundError
        without that checkpoint."""
        cfg = load_config(config_name, config_dir=config_dir, overrides=overrides or [])
        if experiment is not None:
            cfg.experiment = experiment
        if root_path is not None:
            cfg.root_path = root_path
        cfg, folder = set_ckpt(cfg, choose=choose)
        ckpt_path = cfg.evaler.checkpoint_path
        if not ckpt_path or not os.path.exists(os.path.join(ckpt_path, STATE_FILE)):
            raise FileNotFoundError(
                f"no '{choose}' checkpoint under {cfg.root_path}/experiments/{cfg.experiment}")

        device = resolve_device(device)
        datamodule = instantiate(cfg.data, seed=cfg.seed, device=device)
        md = datamodule.train_dataset.metadata
        model = instantiate(cfg.model, dset_metadata=md, seed=cfg.seed, device="cpu")
        with span("serve.load_weights"):
            model.load_state_dict(
                CheckpointManager(folder).restore_params(ckpt_path, model.state_dict()))
        if cfg.evaler.get("enable_amp", False):
            set_compute_dtype(model, torch.bfloat16)
        return cls(model, metadata=md, device=device)

    @classmethod
    def from_numpy(cls, model: torch.nn.Module, flat_params: Mapping[str, np.ndarray],
                   metadata: Any = None, device=None) -> "Predictor":
        """Load flax-keyed (``"a/b/c"``) numpy weights, e.g. an npz asset."""
        with span("serve.load_weights"):
            load_jax_params(model, flat_params)
        return cls(model, metadata, device)

    def _history(self, history) -> torch.Tensor:
        return torch.as_tensor(history, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def rollout(self, history, n_steps: int, out_dtype=None) -> torch.Tensor:
        """history (B, T, H, W, C) -> predicted frames (B, n_steps, H, W, C)."""
        with span("serve.rollout"):
            x = self._history(history)
            if not getattr(self.model, "deg", True):
                return rollout_adaptive_eval_tante(self.model, x, n_steps, out_dtype=out_dtype)[0]
            if isinstance(self.model, TANTE):
                return rollout_tante_latent(self.model, x, n_steps, out_dtype=out_dtype)
            chunk = int(getattr(self.model, "output_length", 1) or 1)
            y = rollout_fixed(self.model, x, n_steps, chunk)
            return y if out_dtype is None else y.to(out_dtype)

    @torch.inference_mode()
    def rollout_adaptive(self, history, n_steps: int, max_frames_per_call: int = 0,
                         out_dtype=None):
        """Adaptive rollout with diagnostics: (frames, rt per realised call
        (numpy), n_calls).  ``max_frames_per_call`` caps the Taylor block of
        a call (0: n_steps)."""
        if getattr(self.model, "deg", True):
            raise ValueError("model is fixed-step (deg=True); use rollout()")
        with span("serve.rollout"):
            y, rt_log, n_calls = rollout_adaptive_eval_tante(
                self.model, self._history(history), n_steps, max_frames_per_call,
                out_dtype=out_dtype,
            )
            with span("serve.read_log"):
                count("host_syncs")
                rt = rt_log[:n_calls].cpu().numpy()
        return y, rt, n_calls

