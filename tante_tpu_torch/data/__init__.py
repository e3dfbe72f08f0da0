from tante_tpu_torch.data.datamodule import TanteDataModule, WaveDataModule, get_formatter
from tante_tpu_torch.data.dataset import TanteDataset
from tante_tpu_torch.data.loader import DataLoader
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.data.synthetic import (
    WaveDataset,
    compute_windows,
    make_well_arrays,
    make_well_dataset,
)

__all__ = ["DataLoader", "TanteDataModule", "TanteDataset", "TanteMetadata", "WaveDataModule",
           "WaveDataset", "compute_windows", "get_formatter", "make_well_arrays",
           "make_well_dataset"]
