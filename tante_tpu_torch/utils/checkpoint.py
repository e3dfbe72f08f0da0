"""Checkpointing with the reference's experiment-folder conventions
(counterpart of ``tante_tpu/utils/checkpoint.py``).

- every epoch: save "recent" with {params, opt_state, meta: epoch,
  validation_loss, best_validation_loss},
- on val improvement: save "best",
- resume: restore model + optimizer, continue from epoch + 1,
- eval: restore model weights only.

A checkpoint is a directory ``<folder>/{recent,best}`` (the orbax names)
holding one ``state.pt``: ``torch.save`` of the model's and the optimizer's
``state_dict`` on the CPU plus the meta scalars.  It is written to
``<name>.tmp`` first and renamed, so a crash never leaves a half-written
checkpoint under the final name.

Under a mesh the Trainer gathers tensor-parallel parameters and their AdamW
moments before it saves (``parallel/sharding.py``) and splits them again
after it restores, so a checkpoint always holds full tensors: one written
under tp loads on one device, and the other way round.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch

STATE_FILE = "state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Save/restore (params, opt_state, scalars) under an experiment folder."""

    def __init__(self, checkpoint_folder: str):
        self.checkpoint_folder = os.path.abspath(checkpoint_folder)
        os.makedirs(self.checkpoint_folder, exist_ok=True)

    # -- save -----------------------------------------------------------
    def save(self, name: str, params: Mapping[str, torch.Tensor], opt_state: Any, epoch: int,
             validation_loss: Optional[float], best_validation_loss: Optional[float]) -> str:
        """``params``: a model ``state_dict``; ``opt_state``: an optimizer
        ``state_dict``."""
        path = os.path.join(self.checkpoint_folder, name)
        nan = float("nan")
        payload = {
            "params": _to_cpu(params),
            "opt_state": _to_cpu(opt_state),
            "meta": {
                "epoch": int(epoch),
                "validation_loss": nan if validation_loss is None else float(validation_loss),
                "best_validation_loss": (
                    nan if best_validation_loss is None else float(best_validation_loss)),
            },
        }
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        return path

    # -- restore --------------------------------------------------------
    @staticmethod
    def _validate_tree(template: Mapping[str, Any], restored: Optional[Mapping[str, Any]],
                       path: str, what: str) -> None:
        """Raise a clear error when a checkpoint doesn't fit the model (a
        stale checkpoint from a different geometry or architecture)."""
        t_shapes = {k: tuple(v.shape) for k, v in template.items()}
        r_shapes = {k: tuple(v.shape) for k, v in (restored or {}).items()}
        missing = sorted(set(t_shapes) - set(r_shapes))[:5]
        extra = sorted(set(r_shapes) - set(t_shapes))[:5]
        bad_shapes = sorted(
            f"{k}: ckpt{r_shapes[k]} != model{t_shapes[k]}"
            for k in set(t_shapes) & set(r_shapes) if t_shapes[k] != r_shapes[k]
        )[:5]
        if missing or extra or bad_shapes:
            raise ValueError(
                f"Checkpoint at {path} does not match the current {what} "
                f"(stale checkpoint from a different architecture/geometry?). "
                f"Missing in checkpoint: {missing}; unexpected in checkpoint: "
                f"{extra}; shape mismatches: {bad_shapes}. Delete or move the "
                f"experiment folder to start fresh."
            )

    @staticmethod
    def _read(path: str) -> Dict[str, Any]:
        # weights_only: tensors, containers and scalars, never pickled code.
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)

    def restore(self, path: str, template: Mapping[str, Any]) -> Dict[str, Any]:
        """Restore a checkpoint; ``template["params"]`` is the model's
        ``state_dict``, which the checkpoint's must match key by key and
        shape by shape."""
        raw = self._read(path)
        self._validate_tree(template["params"], raw.get("params"), path, "model")
        meta = raw["meta"]
        best, val = float(meta["best_validation_loss"]), float(meta["validation_loss"])
        return {
            "params": raw["params"],
            "opt_state": raw["opt_state"],
            "epoch": int(meta["epoch"]),
            "validation_loss": None if math.isnan(val) else val,
            "best_validation_loss": None if math.isnan(best) else best,
        }

    def restore_params(self, path: str, params_template: Mapping[str, torch.Tensor]):
        """Eval-style restore of model weights only, cast to the template's
        dtypes."""
        restored = self._read(path).get("params")
        self._validate_tree(params_template, restored, path, "model")
        return {k: restored[k].to(v.dtype) for k, v in params_template.items()}
