"""The Well HDF5 windowed dataset, host side, numpy out (counterpart of
``tante_tpu/data/dataset.py``).

Items are channels-last float32 numpy arrays ``{'input': (T_in, H, W, C),
'output': (T_out, H, W, C)}``; batching, shuffling and the copy to the card
live in ``loader.py`` (or ``wellpack.py``).  The arithmetic is the JAX
reader's, step for step, so an item equals JAX's bit for bit.

File-format contract (the reference's, The Well's):
  <base>/<name>/stats.yaml                  per-field mean/std
  <base>/<name>/data/<split>/*.hdf5         one or more trajectory files with
    attrs: n_trajectories, n_spatial_dims, dataset_name
    groups: dimensions (attrs spatial_dims; datasets time + spatial dims),
            boundary_conditions/<bc> (attr bc_type),
            t0_fields/t1_fields/t2_fields (attr field_names; per-field
            datasets with attrs sample_varying, time_varying)

Window math: windows per trajectory = total_steps - (1 + dt*(n_in + n_out -
1)) + 1 (``synthetic.compute_windows``); index -> (file, trajectory, window
start) through cumulative offsets and searchsorted, the first offset forced
to -1.

``h5py``, ``yaml`` and ``fsspec`` are imported where they are used: the
card's machine may lack ``h5py``, and the rest of the port runs without it.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.data.synthetic import compute_windows

# HDF5 chunk cache of 8 MiB; for non-local paths, fsspec block-cached reads
# of 8 MiB blocks (the reference's IO_PARAMS).
H5_PARAMS = {"rdcc_nbytes": 8 * 1024 * 1024}
FSSPEC_PARAMS = {"cache_type": "blockcache", "block_size": 8 * 1024 * 1024}


@contextlib.contextmanager
def _closing_h5(f):
    """Close an ``_open_h5`` handle and its underlying fsspec file (h5py
    does not close a file object it was handed)."""
    try:
        yield f
    finally:
        TanteDataset._close_h5(f)


class TanteDataset:
    """Sliding-window dataset over a split directory of Well HDF5 files."""

    def __init__(
        self,
        base_path: str = "./dataset",
        dataset_name: Optional[str] = None,
        split_name: str = "train",
        include_filters: Optional[List[str]] = None,
        exclude_filters: Optional[List[str]] = None,
        n_steps_input: int = 1,
        n_steps_output: int = 1,
        dt_stride: int = 1,
        min_std: float = 1e-4,
        **_unused: Any,
    ):
        import fsspec
        import yaml

        # Local paths open with plain h5py; remote URIs (s3://, gs://,
        # memory://, ...) read through an fsspec blockcache.
        self._fs, _ = fsspec.core.url_to_fs(base_path)
        proto = self._fs.protocol
        proto = proto[0] if isinstance(proto, (tuple, list)) else proto
        self._is_local = proto in ("file", "local")

        self.data_path = "/".join([base_path.rstrip("/"), dataset_name, "data", split_name])
        self.normalization_path = "/".join([base_path.rstrip("/"), dataset_name, "stats.yaml"])
        self.n_steps_input = n_steps_input
        self.n_steps_output = n_steps_output
        self.dt_stride = dt_stride

        with self._fs.open(self.normalization_path, "r") as f:
            stats = yaml.safe_load(f)
        # Per-field z-score stats, the std clipped from below.
        self.means = {k: np.asarray(v, dtype=np.float32) for k, v in stats["mean"].items()}
        self.stds = {k: np.clip(np.asarray(v, dtype=np.float32), min_std, None)
                     for k, v in stats["std"].items()}

        listed = self._fs.ls(self.data_path, detail=False)
        files = sorted(self._fs.unstrip_protocol(p) if not self._is_local else p
                       for p in listed if p.endswith((".h5", ".hdf5")))
        if include_filters:
            files = [f for inc in include_filters for f in files if inc in f]
        for exc in exclude_filters or []:
            files = [f for f in files if exc not in f]
        if not files:
            raise FileNotFoundError(f"No HDF5 files found in path {self.data_path}")
        self.files_paths = sorted(files)

        self._handles: List[Optional[Any]] = [None] * len(self.files_paths)
        self.metadata = self._build_metadata()

    def _open_h5(self, path: str):
        import h5py

        if self._is_local:
            return h5py.File(path, "r", **H5_PARAMS)
        # The fsspec handle (and its blockcache) rides on the h5py file so
        # that ``_close_h5`` releases both.
        raw = self._fs.open(path, "rb", **FSSPEC_PARAMS)
        f = h5py.File(raw, "r", **H5_PARAMS)
        f._tante_raw = raw
        return f

    @staticmethod
    def _close_h5(f) -> None:
        raw = getattr(f, "_tante_raw", None)
        f.close()
        if raw is not None:
            raw.close()

    # ------------------------------------------------------------------
    def _build_metadata(self) -> TanteMetadata:
        self.n_trajectories_per_file: List[int] = []
        self.n_steps_per_trajectory: List[int] = []
        self.n_windows_per_trajectory: List[int] = []
        self.file_index_offsets: List[int] = [0]
        sizes, ndims, names, bcs = set(), set(), set(), set()
        self.field_names: Dict[int, List[str]] = {i: [] for i in range(3)}

        for index, path in enumerate(self.files_paths):
            with _closing_h5(self._open_h5(path)) as f:
                trajectories = int(f.attrs["n_trajectories"])
                steps = f["dimensions"]["time"].shape[-1]
                windows = compute_windows(steps, self.n_steps_input, self.n_steps_output,
                                          self.dt_stride)
                if windows <= 0:
                    raise ValueError(
                        f"{steps} steps is not enough for file {path} to allow "
                        f"{self.n_steps_input} input and {self.n_steps_output} output "
                        f"steps with stride {self.dt_stride}")
                self.n_trajectories_per_file.append(trajectories)
                self.n_steps_per_trajectory.append(steps)
                self.n_windows_per_trajectory.append(windows)
                self.file_index_offsets.append(
                    self.file_index_offsets[-1] + trajectories * windows)
                spatial_dims = list(f["dimensions"].attrs["spatial_dims"])
                sizes.add(tuple(f["dimensions"][d].shape[-1] for d in spatial_dims))
                ndims.add(int(f.attrs["n_spatial_dims"]))
                names.add(str(f.attrs["dataset_name"]))
                for bc in f["boundary_conditions"]:
                    bcs.add(str(f["boundary_conditions"][bc].attrs["bc_type"]))
                if index == 0:
                    # Tensor-order naming: an order-k field gets one name per
                    # spatial-dim k-tuple.
                    for i in range(3):
                        group = f[f"t{i}_fields"]
                        dim_tuples = ["".join(xyz)
                                      for xyz in itertools.product(spatial_dims, repeat=i)]
                        for field in group.attrs["field_names"]:
                            for dims in dim_tuples:
                                if group[field].attrs["time_varying"]:
                                    self.field_names[i].append(
                                        f"{field}_{dims}" if dims else field)

        self.file_index_offsets[0] = -1  # searchsorted convention
        self.len = self.file_index_offsets[-1]
        self._offsets_np = np.asarray(self.file_index_offsets)

        return TanteMetadata(
            dataset_name=names.pop(),
            n_spatial_dims=ndims.pop(),
            spatial_resolution=tuple(map(int, sizes.pop())),
            field_names=self.field_names,
            boundary_condition_types=sorted(bcs),
            n_files=len(self.files_paths),
            n_trajectories_per_file=self.n_trajectories_per_file,
            n_steps_per_trajectory=self.n_steps_per_trajectory,
            n_fields=sum(map(len, self.field_names.values())),
        )

    # ------------------------------------------------------------------
    def _file(self, file_idx: int):
        """This file's handle, opened on first use and kept."""
        if self._handles[file_idx] is None:
            self._handles[file_idx] = self._open_h5(self.files_paths[file_idx])
        return self._handles[file_idx]

    def _reconstruct_fields(self, f, sample_idx: int, time_idx: int, n_steps: int,
                            dt: int) -> List[np.ndarray]:
        """Read and normalise one window: channels-last blocks, one per
        time-varying field (order 0: 1 channel, order 1: d, order 2: d*d)."""
        blocks: List[np.ndarray] = []
        for order in range(3):
            group = f[f"t{order}_fields"]
            for name in group.attrs["field_names"]:
                field = group[name]
                if not field.attrs["time_varying"]:
                    continue
                index: Tuple = ()
                if field.attrs["sample_varying"]:
                    index = index + (sample_idx,)
                index = index + (slice(time_idx, time_idx + n_steps * dt, dt),)
                data = np.asarray(field[index], dtype=np.float32)
                if name in self.means:
                    data = data - self.means[name]
                if name in self.stds:
                    data = data / self.stds[name]
                if order == 0:
                    data = data[..., None]  # (T, ..., 1)
                elif order == 2:
                    data = data.reshape(*data.shape[:-2], -1)  # flatten d x d
                blocks.append(data)
        return blocks

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if not 0 <= index < self.len:
            raise IndexError(index)
        file_idx = int(np.searchsorted(self._offsets_np, index, side="right") - 1)
        windows = self.n_windows_per_trajectory[file_idx]
        local = index - max(self.file_index_offsets[file_idx], 0)
        sample_idx, time_idx = local // windows, local % windows
        blocks = self._reconstruct_fields(self._file(file_idx), sample_idx, time_idx,
                                          self.n_steps_input + self.n_steps_output,
                                          self.dt_stride)
        field = np.concatenate(blocks, axis=-1)  # (T, H, W, C)
        return {"input": field[: self.n_steps_input], "output": field[self.n_steps_input :]}

    def __len__(self) -> int:
        return self.len

    def close(self) -> None:
        for i, h in enumerate(self._handles):
            if h is not None:
                self._close_h5(h)
                self._handles[i] = None

    def __del__(self):  # best effort: close() is the way to release the files
        try:
            self.close()
        except Exception:
            pass

    def __repr__(self) -> str:
        return f"<{self.__class__.__name__}: {self.data_path}>"
