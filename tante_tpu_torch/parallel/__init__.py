from tante_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    dp_tp_mesh,
    input_sharding,
    make_mesh,
    replicated,
)
from tante_tpu_torch.parallel.sharding import gather_params, param_shardings, shard_params

__all__ = [
    "Mesh",
    "make_mesh",
    "dp_tp_mesh",
    "batch_sharding",
    "input_sharding",
    "replicated",
    "param_shardings",
    "shard_params",
    "gather_params",
]
