from tante_tpu_torch.train.rollout import (
    rollout_adaptive_eval,
    rollout_adaptive_eval_tante,
    rollout_fixed,
    rollout_tante_latent,
)

__all__ = [
    "rollout_adaptive_eval",
    "rollout_adaptive_eval_tante",
    "rollout_fixed",
    "rollout_tante_latent",
]
