"""Synthetic travelling-wave fields held in memory (counterpart of
``tante_tpu/data/synthetic.py`` + ``tante_tpu/data/dataset.py``).

This is the JAX package's synthetic Well dataset without the HDF5 file in
between, not a new capability: ``make_well_arrays`` draws from the rng in
the order ``make_well_dataset`` does (per split, per file: phases, then
speeds) and builds the same fields, and ``WaveDataset`` windows them with
``TanteDataset``'s index math, so item ``i`` of a split equals item ``i`` of
``TanteDataset`` over the files ``make_well_dataset`` writes from the same
arguments (the stats there are mean 0 / std 1, so normalisation is the
identity).  The HDF5 reader itself waits for a later slice.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

from tante_tpu_torch.data.metadata import TanteMetadata


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
    out: Dict[str, List[np.ndarray]] = {}
    for split in splits:
        files = []
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
            files.append(np.stack(channels, axis=-1).astype(np.float32))
        out[split] = files
    return out


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
