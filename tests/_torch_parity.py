"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
one JAX ``init`` flattened to numpy and loaded into the port through
``tante_tpu_torch.convert``, at the small TANTE geometry the tests share."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.tante import TANTE

B, T, H, W, F = 2, 4, 32, 64, 4
KW = dict(in_T=T, taylor_order=1, attn_axes="THWTHW", embed_dim=128, patch_scale=8,
          n_head=4, mlp_ratio=1.0, output_length=1)
PS = (2, 2, 2)


def metadata(cls, res=(H, W)):
    return cls(dataset_name="t", n_spatial_dims=2, spatial_resolution=tuple(res),
               field_names={0: ["f"] * F, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
               n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[32],
               n_fields=F)


def flatten(params):
    return {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}


@functools.lru_cache(maxsize=None)
def models(deg: bool, rt_bias: float | None = None):
    """(jax model, jax params, port model) sharing one init.  ``rt_bias``
    zeroes the interprator's last layer and sets its bias, so every call
    reports r_t = clip(rt_bias, 0, out_T - 1) + 1.001."""
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata), deg=deg, **KW)
    x = jnp.zeros((1, T, H, W, F), jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), x, *(() if deg else (2.5,)))
    if rt_bias is not None:
        head = params["params"]["interprators_0"]["TorchDense_2"]["Dense_0"]
        head["kernel"] = jnp.zeros_like(head["kernel"])
        head["bias"] = jnp.full_like(head["bias"], rt_bias)
    tm = TANTE(dset_metadata=metadata(TanteMetadata), deg=deg, device="cpu", **KW)
    load_jax_params(tm, flatten(params))
    return jm, params, tm.eval()


def frames(seed, n=T):
    return np.random.default_rng(seed).normal(size=(B, n, H, W, F)).astype(np.float32)
