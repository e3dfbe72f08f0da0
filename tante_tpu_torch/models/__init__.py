from tante_tpu_torch.models.afno import AFNO
from tante_tpu_torch.models.avit import AViT
from tante_tpu_torch.models.common import TransformerBlock
from tante_tpu_torch.models.cvit import CViT
from tante_tpu_torch.models.dpot import DPOT
from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE, Interprator
from tante_tpu_torch.models.tfno import TFNO
from tante_tpu_torch.models.unet_att import AttentionUNet
from tante_tpu_torch.models.unet_convnext import UNetConvNext
from tante_tpu_torch.models.uno import UNO

__all__ = ["AFNO", "AViT", "AttentionUNet", "CViT", "DPOT", "FNO", "TANTE", "TFNO",
           "TransformerBlock", "UNO", "UNetConvNext", "Interprator"]
