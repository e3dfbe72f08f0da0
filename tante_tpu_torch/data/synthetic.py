"""Synthetic travelling-wave fields (counterpart of
``tante_tpu/data/synthetic.py``), in memory or as Well-format HDF5.

``make_well_arrays`` draws from the rng in the order the JAX package's
``make_well_dataset`` does (per split, per file: phases, then speeds) and
builds the same fields; ``make_well_dataset`` writes them as the same HDF5
tree.  ``WaveDataset`` windows the arrays with ``TanteDataset``'s index math,
so item ``i`` of a split equals item ``i`` of ``TanteDataset`` over the files
written from the same arguments (the stats there are mean 0 / std 1, so
normalisation is the identity): the in-memory route needs no ``h5py``.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Sequence

import numpy as np

from tante_tpu_torch.data.metadata import TanteMetadata


def _well_files(splits, n_files_per_split, n_trajectories, n_steps, resolution, with_t2,
                with_pressure, seed, speed_range, difficulty_ramp):
    """(split, wave speeds, (n_trajectories, n_steps, *resolution, C) f32
    array) per file, drawn in ``make_well_dataset``'s order."""
    rng = np.random.default_rng(seed)
    d = len(resolution)
    if d not in (2, 3):
        raise ValueError(f"resolution must be 2-D or 3-D, got {resolution}")
    grids = np.meshgrid(
        *[np.linspace(0, 2 * np.pi, s, endpoint=False) for s in resolution], indexing="ij")
    bshape = (1, 1) + (1,) * d
    t = np.arange(n_steps, dtype=np.float32).reshape(1, n_steps, *([1] * d))
    k1, k2 = (1, 2, 1)[:d], (3, 1, 2)[:d]
    lo, hi = speed_range
    for split in splits:
        for _ in range(n_files_per_split):
            phase = rng.uniform(0, 2 * np.pi, size=(n_trajectories,)).reshape(
                (n_trajectories,) + bshape[1:]).astype(np.float32)
            if difficulty_ramp:
                speeds = np.linspace(lo, hi, n_trajectories, dtype=np.float32)
            else:
                speeds = rng.uniform(lo, hi, size=(n_trajectories,)).astype(np.float32)
            speed = speeds.reshape((n_trajectories,) + bshape[1:])

            def wave(*ks, amp=1.0):
                space = sum(k * g for k, g in zip(ks, grids))
                return amp * np.sin(space[(None, None)] + phase + speed * t).astype(np.float32)

            channels = [wave(*k1) + 0.5 * wave(*k2)]
            if with_pressure:
                channels.append(wave(*k2) + 0.25 * wave(*k1))
            channels += [wave(*np.roll(k1, i), amp=1.0 - 0.3 * i) for i in range(d)]
            if with_t2:
                channels += [wave(*np.roll(k1, i), amp=1.0 - 0.1 * i) for i in range(d * d)]
            yield split, speeds, np.stack(channels, axis=-1).astype(np.float32)


def make_well_arrays(
    splits: Sequence[str] = ("train", "valid", "test"),
    n_files_per_split: int = 1,
    n_trajectories: int = 3,
    n_steps: int = 24,
    resolution: tuple = (32, 64),
    with_t2: bool = False,
    with_pressure: bool = False,
    seed: int = 0,
    speed_range: tuple = (0.1, 0.3),
    difficulty_ramp: bool = False,
) -> Dict[str, List[np.ndarray]]:
    """split -> one ``(n_trajectories, n_steps, *resolution, C)`` f32 array
    per file, channels in the reader's order: t0 fields (density[,
    pressure]), the d velocity components, then the d*d stress components."""
    out: Dict[str, List[np.ndarray]] = {split: [] for split in splits}
    for split, _, arr in _well_files(splits, n_files_per_split, n_trajectories, n_steps,
                                     resolution, with_t2, with_pressure, seed, speed_range,
                                     difficulty_ramp):
        out[split].append(arr)
    return out


def make_well_dataset(
    base_path: str,
    dataset_name: str = "synthetic_waves",
    splits: Sequence[str] = ("train", "valid", "test"),
    n_files_per_split: int = 1,
    n_trajectories: int = 3,
    n_steps: int = 24,
    resolution: tuple = (32, 64),
    with_t2: bool = False,
    with_pressure: bool = False,
    seed: int = 0,
    speed_range: tuple = (0.1, 0.3),
    difficulty_ramp: bool = False,
) -> str:
    """Write ``make_well_arrays``' fields as a Well-format HDF5 tree with its
    ``stats.yaml`` (mean 0, std 1); returns its root directory.  Same files,
    read back, as the JAX package's writer for the same arguments: one
    dataset per field (density[, pressure] (N, T, *res), velocity (..., d),
    stress (..., d, d)), the same dimensions, boundary conditions, attributes
    and ``wave_speeds``."""
    import h5py
    import yaml

    d = len(resolution)
    root = os.path.join(base_path, dataset_name)
    os.makedirs(root, exist_ok=True)
    t0_names = ["density", "pressure"] if with_pressure else ["density"]

    stats = {"mean": {}, "std": {}}
    for nm in t0_names:
        stats["mean"][nm] = 0.0
        stats["std"][nm] = 1.0
    stats["mean"]["velocity"] = [0.0] * d
    stats["std"]["velocity"] = [1.0] * d
    if with_t2:
        stats["mean"]["stress"] = [[0.0] * d] * d
        stats["std"]["stress"] = [[1.0] * d] * d
    with open(os.path.join(root, "stats.yaml"), "w") as f:
        yaml.safe_dump(stats, f)

    dim_names = ("x", "y", "z")[:d]
    file_index = {split: 0 for split in splits}
    for split, speeds, arr in _well_files(splits, n_files_per_split, n_trajectories, n_steps,
                                          resolution, with_t2, with_pressure, seed, speed_range,
                                          difficulty_ramp):
        split_dir = os.path.join(root, "data", split)
        os.makedirs(split_dir, exist_ok=True)
        path = os.path.join(split_dir, f"{dataset_name}_{split}_{file_index[split]}.hdf5")
        file_index[split] += 1
        n0 = len(t0_names)
        with h5py.File(path, "w") as f:
            f.attrs["n_trajectories"] = n_trajectories
            f.attrs["n_spatial_dims"] = d
            f.attrs["dataset_name"] = dataset_name
            dims = f.create_group("dimensions")
            dims.attrs["spatial_dims"] = list(dim_names)
            dims.create_dataset("time", data=np.arange(n_steps, dtype=np.float32))
            for name, size in zip(dim_names, resolution):
                dims.create_dataset(name, data=np.linspace(0, 1, size, dtype=np.float32))
            bcs = f.create_group("boundary_conditions")
            for name in dim_names:
                bcs.create_group(name).attrs["bc_type"] = "PERIODIC"
            f.attrs["wave_speeds"] = speeds

            fields = {
                "t0": [(nm, arr[..., i]) for i, nm in enumerate(t0_names)],
                "t1": [("velocity", arr[..., n0:n0 + d])],
                "t2": ([("stress", arr[..., n0 + d:].reshape(*arr.shape[:-1], d, d))]
                       if with_t2 else []),
            }
            for order, entries in fields.items():
                group = f.create_group(f"{order}_fields")
                group.attrs["field_names"] = [nm for nm, _ in entries]
                for nm, data in entries:
                    ds = group.create_dataset(nm, data=np.ascontiguousarray(data))
                    ds.attrs["sample_varying"] = True
                    ds.attrs["time_varying"] = True
    return root


def compute_windows(total_steps: int, n_steps_input: int, n_steps_output: int,
                    dt_stride: int) -> int:
    elapsed = 1 + dt_stride * (n_steps_input + n_steps_output - 1)
    return max(0, total_steps - elapsed + 1)


def wave_field_names(d: int, with_t2: bool = False, with_pressure: bool = False):
    """The reader's tensor-order naming: order-k fields get one name per
    spatial-dim k-tuple."""
    dims = ("x", "y", "z")[:d]
    t0 = ["density", "pressure"] if with_pressure else ["density"]
    t1 = [f"velocity_{a}" for a in dims]
    t2 = [f"stress_{a}{b}" for a, b in itertools.product(dims, repeat=2)] if with_t2 else []
    return {0: t0, 1: t1, 2: t2}


class WaveDataset:
    """Sliding windows over in-memory trajectory files: items are
    ``{'input': (T_in, *spatial, C), 'output': (T_out, *spatial, C)}`` f32,
    index -> (file, trajectory, window start) as in ``TanteDataset``."""

    def __init__(self, files: Sequence[np.ndarray], field_names: Dict[int, List[str]],
                 n_steps_input: int = 1, n_steps_output: int = 1, dt_stride: int = 1,
                 dataset_name: str = "synthetic_waves"):
        if not files:
            raise ValueError("WaveDataset needs at least one trajectory file")
        self.files = list(files)
        self.n_steps_input = n_steps_input
        self.n_steps_output = n_steps_output
        self.dt_stride = dt_stride
        self.n_windows_per_trajectory = []
        offsets = [0]
        for f in self.files:
            windows = compute_windows(f.shape[1], n_steps_input, n_steps_output, dt_stride)
            if windows <= 0:
                raise ValueError(
                    f"{f.shape[1]} steps is not enough to allow {n_steps_input} input and "
                    f"{n_steps_output} output steps with stride {dt_stride}")
            self.n_windows_per_trajectory.append(windows)
            offsets.append(offsets[-1] + f.shape[0] * windows)
        self._offsets = np.asarray(offsets)
        resolution = tuple(int(s) for s in self.files[0].shape[2:-1])
        self.metadata = TanteMetadata(
            dataset_name=dataset_name,
            n_spatial_dims=len(resolution),
            spatial_resolution=resolution,
            field_names=field_names,
            boundary_condition_types=["PERIODIC"],
            n_files=len(self.files),
            n_trajectories_per_file=[f.shape[0] for f in self.files],
            n_steps_per_trajectory=[f.shape[1] for f in self.files],
            n_fields=sum(map(len, field_names.values())),
        )
        if self.metadata.n_fields != self.files[0].shape[-1]:
            raise ValueError(
                f"{self.metadata.n_fields} field names for {self.files[0].shape[-1]} channels")

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if not 0 <= index < len(self):
            raise IndexError(index)
        file_idx = int(np.searchsorted(self._offsets, index, side="right") - 1)
        windows = self.n_windows_per_trajectory[file_idx]
        local = index - int(self._offsets[file_idx])
        sample_idx, time_idx = local // windows, local % windows
        n = self.n_steps_input + self.n_steps_output
        field = self.files[file_idx][sample_idx, time_idx : time_idx + n * self.dt_stride
                                     : self.dt_stride]
        return {"input": field[: self.n_steps_input], "output": field[self.n_steps_input :]}
