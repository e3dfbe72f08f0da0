"""DataModules + batch formatters (counterpart of
``tante_tpu/data/datamodule.py``).

``TanteDataModule`` builds train/val/test ``TanteDataset``s over a Well HDF5
tree, ``WaveDataModule`` ``WaveDataset``s over in-memory synthetic waves
(needing no ``h5py``); both use ``eval_steps_output`` as the val and test
output window and hand out prefetching loaders on ``device`` (CUDA unless
the caller passes "cpu").  Under a mesh the Trainer sets ``sharding``, and
each loader keeps this rank's part of every global batch.

Formatters: the port is channels-last end to end like the JAX package, so
both formatter names map to layout-preserving implementations that own
``nan_to_num``.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Literal, Optional, Tuple

import torch

from tante_tpu_torch.data.dataset import TanteDataset
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


class TanteDataModule(AbstractDataModule):
    """The Well HDF5 tree at ``<base_path>/<dataset_name>``.  With
    ``use_wellpack`` each split is decoded once into a WellPack cache under
    ``wellpack_cache_dir`` (default ``<base_path>/<dataset_name>/wellpack_cache``)
    and batched by the native loader; the Python ``DataLoader`` stands in
    when that loader's library cannot be built."""

    def __init__(
        self,
        base_path: str,
        dataset_name: str,
        batch_size: int,
        include_filters: Optional[List[str]] = None,
        exclude_filters: Optional[List[str]] = None,
        n_steps_input: int = 1,
        n_steps_output: int = 1,
        eval_steps_output: int = 2,
        dt_stride: int = 1,
        world_size: int = 1,
        data_workers: int = 4,
        rank: int = 0,
        seed: int = 0,
        use_wellpack: bool = False,
        wellpack_cache_dir: Optional[str] = None,
        dataset_kws: Optional[Dict[Literal["train", "val", "test"], Dict[str, Any]]] = None,
        device=None,
        **_unused: Any,
    ):
        self.device = resolve_device(device)

        def build(split: str, n_out: int, key: str) -> TanteDataset:
            return TanteDataset(
                base_path=base_path, dataset_name=dataset_name, split_name=split,
                include_filters=include_filters, exclude_filters=exclude_filters,
                n_steps_input=n_steps_input, n_steps_output=n_out, dt_stride=dt_stride,
                **((dataset_kws or {}).get(key) or {}),
            )

        self.train_dataset = build("train", n_steps_output, "train")
        self.val_dataset = build("valid", eval_steps_output, "val")
        self.test_dataset = build("test", eval_steps_output, "test")
        self.base_path = base_path
        self.dataset_name = dataset_name
        self.batch_size = batch_size
        self.world_size = world_size
        self.data_workers = data_workers
        self.rank = rank
        self.seed = seed
        self.sharding = None  # this rank's part of each global batch; the Trainer sets it
        self.use_wellpack = use_wellpack
        self.wellpack_cache_dir = wellpack_cache_dir or os.path.join(
            base_path, dataset_name, "wellpack_cache")
        self._wellpack_paths: Dict[str, str] = {}

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1

    def _wellpack_loader(self, dataset, split: str, shuffle: bool):
        from tante_tpu_torch.data.wellpack import WellPackLoader, build_cache, get_library

        if get_library() is None:
            return None
        key = f"{split}_{dataset.n_steps_output}"
        if key not in self._wellpack_paths:
            path = os.path.join(self.wellpack_cache_dir, f"{key}.wpk")
            if not os.path.exists(path):
                build_cache(dataset, path)
            self._wellpack_paths[key] = path
        return WellPackLoader(
            self._wellpack_paths[key], n_steps_input=dataset.n_steps_input,
            n_steps_output=dataset.n_steps_output, dt_stride=dataset.dt_stride,
            batch_size=self.batch_size, shuffle=shuffle, seed=self.seed,
            num_threads=self.data_workers, sharding=self.sharding, device=self.device)

    def _loader(self, dataset, shuffle: bool, split: str):
        if self.use_wellpack:
            loader = self._wellpack_loader(dataset, split, shuffle)
            if loader is not None:
                return loader
        return DataLoader(dataset, batch_size=self.batch_size, shuffle=shuffle, drop_last=True,
                          num_workers=self.data_workers, seed=self.seed, device=self.device,
                          sharding=self.sharding)

    def train_dataloader(self):
        return self._loader(self.train_dataset, shuffle=True, split="train")

    def val_dataloader(self):
        # The reference shuffles val too.
        return self._loader(self.val_dataset, shuffle=True, split="valid")

    def test_dataloader(self):
        return self._loader(self.test_dataset, shuffle=False, split="test")

    def __repr__(self) -> str:
        return f"<{self.__class__.__name__}: {self.dataset_name} on {self.base_path}>"


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
