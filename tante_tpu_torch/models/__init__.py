from tante_tpu_torch.models.avit import AViT
from tante_tpu_torch.models.common import TransformerBlock
from tante_tpu_torch.models.cvit import CViT
from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE, Interprator
from tante_tpu_torch.models.tfno import TFNO
from tante_tpu_torch.models.uno import UNO

__all__ = ["AViT", "CViT", "FNO", "TANTE", "TFNO", "TransformerBlock", "UNO", "Interprator"]
