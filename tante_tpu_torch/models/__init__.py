from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE, Interprator
from tante_tpu_torch.models.tfno import TFNO
from tante_tpu_torch.models.uno import UNO

__all__ = ["FNO", "TANTE", "TFNO", "UNO", "Interprator"]
