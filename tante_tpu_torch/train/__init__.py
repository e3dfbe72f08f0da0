from tante_tpu_torch.train.evaler import Evaler
from tante_tpu_torch.train.metrics import L2RE, MSE, NMSE, NNMSE, NRMSE, RMSE, VMSE, VRMSE, Metric
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.r_evaler import R_Evaler, five_number_summary
from tante_tpu_torch.train.r_trainer import R_Trainer
from tante_tpu_torch.train.rollout import (
    rollout_adaptive_eval,
    rollout_adaptive_eval_tante,
    rollout_adaptive_train,
    rollout_adaptive_train_vf,
    rollout_fixed,
    rollout_fixed_stateful,
    rollout_tante_latent,
)
from tante_tpu_torch.train.schedules import LinearWarmupCosineAnnealingLR
from tante_tpu_torch.train.trainer import Trainer

__all__ = [
    "AdamW", "Evaler", "L2RE", "LinearWarmupCosineAnnealingLR", "MSE", "Metric", "NMSE", "NNMSE",
    "NRMSE", "RMSE", "R_Evaler", "R_Trainer", "Trainer", "VMSE", "VRMSE",
    "five_number_summary",
    "rollout_adaptive_eval",
    "rollout_adaptive_eval_tante",
    "rollout_adaptive_train",
    "rollout_adaptive_train_vf",
    "rollout_fixed",
    "rollout_fixed_stateful",
    "rollout_tante_latent",
]
