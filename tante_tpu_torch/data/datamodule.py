"""DataModule + batch formatters (counterpart of
``tante_tpu/data/datamodule.py``).

``WaveDataModule`` builds train/val/test ``WaveDataset``s over in-memory
synthetic waves (val and test use ``eval_steps_output`` as their output
window) and hands out prefetching loaders.  ``TanteDataModule`` (the HDF5
reader behind the same interface) waits for the data-layer slice.

Formatters: the port is channels-last end to end like the JAX package, so
both formatter names map to layout-preserving implementations that own
``nan_to_num``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple

import torch

from tante_tpu_torch.data.loader import DataLoader
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.data.synthetic import WaveDataset, make_well_arrays, wave_field_names
from tante_tpu_torch.ops.backend import resolve_device


class AbstractDataModule(ABC):
    @abstractmethod
    def train_dataloader(self) -> DataLoader: ...

    @abstractmethod
    def val_dataloader(self) -> DataLoader: ...

    @abstractmethod
    def test_dataloader(self) -> DataLoader: ...


class WaveDataModule(AbstractDataModule):
    """``TanteDataModule``'s surface over ``make_well_arrays`` waves.
    ``waves``: that function's arguments (resolution, n_trajectories,
    n_steps, with_pressure, seed, ...); ``seed`` here is the loaders'
    shuffle seed, as in ``TanteDataModule``."""

    def __init__(self, batch_size: int, waves: Optional[Dict[str, Any]] = None,
                 n_steps_input: int = 1, n_steps_output: int = 1, eval_steps_output: int = 2,
                 dt_stride: int = 1, data_workers: int = 4, seed: int = 0, device=None,
                 dataset_name: str = "synthetic_waves"):
        self.device = resolve_device(device)
        waves = dict(waves or {})
        arrays = make_well_arrays(splits=("train", "valid", "test"), **waves)
        names = wave_field_names(len(waves.get("resolution", (32, 64))),
                                 waves.get("with_t2", False), waves.get("with_pressure", False))

        def build(split: str, n_out: int) -> WaveDataset:
            return WaveDataset(arrays[split], names, n_steps_input, n_out, dt_stride,
                               dataset_name)

        self.train_dataset = build("train", n_steps_output)
        self.val_dataset = build("valid", eval_steps_output)
        self.test_dataset = build("test", eval_steps_output)
        self.dataset_name = dataset_name
        self.batch_size = batch_size
        self.data_workers = data_workers
        self.seed = seed
        # This rank's part of each global batch under a mesh
        # (``parallel.mesh.input_sharding``); the Trainer sets it.
        self.sharding = None

    def _loader(self, dataset, shuffle: bool) -> DataLoader:
        return DataLoader(dataset, batch_size=self.batch_size, shuffle=shuffle, drop_last=True,
                          num_workers=self.data_workers, seed=self.seed, device=self.device,
                          sharding=self.sharding)

    def train_dataloader(self) -> DataLoader:
        return self._loader(self.train_dataset, shuffle=True)

    def val_dataloader(self) -> DataLoader:
        # The reference shuffles val too.
        return self._loader(self.val_dataset, shuffle=True)

    def test_dataloader(self) -> DataLoader:
        return self._loader(self.test_dataset, shuffle=False)

    def __repr__(self) -> str:
        return f"<{self.__class__.__name__}: {self.dataset_name} in memory>"


class AbstractDataFormatter(ABC):
    def __init__(self, metadata: TanteMetadata):
        self.metadata = metadata

    @abstractmethod
    def process_input(self, data: Dict) -> Tuple: ...

    @abstractmethod
    def process_output(self, output): ...


class DefaultChannelsLastFormatter(AbstractDataFormatter):
    def process_input(self, data: Dict) -> Tuple:
        x = torch.nan_to_num(data["input"])
        y = torch.nan_to_num(data["output"])
        return (x,), y

    def process_output(self, output):
        return output


class DefaultChannelsFirstFormatter(DefaultChannelsLastFormatter):
    """Reference-name parity; the layout stays channels-last."""


def get_formatter(name: str, metadata: TanteMetadata) -> AbstractDataFormatter:
    if name == "channels_first_default":
        return DefaultChannelsFirstFormatter(metadata)
    if name == "channels_last_default":
        return DefaultChannelsLastFormatter(metadata)
    raise ValueError(f"Unknown formatter '{name}'")
