"""Batch-inference serving API (counterpart of ``tante_tpu/serve.py``).

    from tante_tpu_torch.serve import Predictor
    p = Predictor.from_numpy(model, flat_params)            # flax-keyed npz dict
    frames = p.rollout(history, n_steps=16)                 # (B, 16, H, W, C)
    frames, rt, calls = p.rollout_adaptive(history, 16, max_frames_per_call=8)

Fixed-step TANTE rollouts use the latent-caching path; adaptive models use
the adaptive loop, where a large r_t genuinely skips model calls.  Results
are tensors on the model's device.  ``from_experiment`` (config +
checkpoint) waits for the config/checkpoint port.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.train.rollout import (
    rollout_adaptive_eval_tante,
    rollout_fixed,
    rollout_tante_latent,
)


class Predictor:
    """Serves ``model`` (moved to ``device``, CUDA by default).

    The model's parameters are cast IN PLACE to its compute dtype
    (``model.dtype``): every use casts them to that dtype anyway, so the
    outputs are bit-identical, and a bf16 model call then launches no
    per-call weight casts (~180 fewer small kernels per TANTE call)."""

    def __init__(self, model: torch.nn.Module, metadata: Any = None, device=None):
        self.device = resolve_device(device if device is not None else _model_device(model))
        dtype = getattr(model, "dtype", None) or torch.float32
        self.model = model.to(self.device, dtype).eval()
        self.metadata = metadata

    @classmethod
    def from_numpy(cls, model: torch.nn.Module, flat_params: Mapping[str, np.ndarray],
                   metadata: Any = None, device=None) -> "Predictor":
        """Load flax-keyed (``"a/b/c"``) numpy weights, e.g. an npz asset."""
        load_jax_params(model, flat_params)
        return cls(model, metadata, device)

    def _history(self, history) -> torch.Tensor:
        return torch.as_tensor(history, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def rollout(self, history, n_steps: int, out_dtype=None) -> torch.Tensor:
        """history (B, T, H, W, C) -> predicted frames (B, n_steps, H, W, C)."""
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
        y, rt_log, n_calls = rollout_adaptive_eval_tante(
            self.model, self._history(history), n_steps, max_frames_per_call,
            out_dtype=out_dtype,
        )
        return y, rt_log[:n_calls].cpu().numpy(), n_calls


def _model_device(model: torch.nn.Module):
    p = next(model.parameters(), None)
    return None if p is None else p.device
