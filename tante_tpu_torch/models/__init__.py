from tante_tpu_torch.models.tante import TANTE, Interprator

__all__ = ["TANTE", "Interprator"]
