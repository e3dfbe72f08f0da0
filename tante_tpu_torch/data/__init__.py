from tante_tpu_torch.data.datamodule import WaveDataModule, get_formatter
from tante_tpu_torch.data.loader import DataLoader
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.data.synthetic import WaveDataset, make_well_arrays

__all__ = ["DataLoader", "TanteMetadata", "WaveDataModule", "WaveDataset", "get_formatter",
           "make_well_arrays"]
