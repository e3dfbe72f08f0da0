"""Dataset metadata handed to every model constructor.

The port's own copy of ``tante_tpu/data/dataset.py:TanteMetadata`` (that
module imports h5py, which the serving path does not need)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class TanteMetadata:
    dataset_name: str
    n_spatial_dims: int
    spatial_resolution: Tuple[int, ...]
    field_names: Dict[int, List[str]]
    boundary_condition_types: List[str]
    n_files: int
    n_trajectories_per_file: List[int]
    n_steps_per_trajectory: List[int]
    n_fields: int

    @property
    def sample_shapes(self) -> Dict[str, List[int]]:
        return {
            "input_fields": [*self.spatial_resolution, self.n_fields],
            "output_fields": [*self.spatial_resolution, self.n_fields],
            "space_grid": [*self.spatial_resolution, self.n_spatial_dims],
        }
