"""Port parity at the TANTE geometries the other parity files leave out, f32
on the CPU: ``patch_scale`` 2, 4, 16 and 32 (every ``PATCH_MAP`` pyramid but
8 and 64); 48x80 and 24x40 frames at patch 8; ``taylor_order`` 3 with
``output_length`` 2 (``THW-HW-T``) in both modes; ``taylor_order`` 2 with
``THWT-LYX`` (adaptive); ``THW-A`` at patch 16 with ``output_length`` 3; and
patch 16 at overlap 0.25.

One case: the JAX model and the port's from one seeded parameter tree
(adaptive models with the interprator head that reports r_t = 3.601, so
that each call emits 3 frames), the model call, then the serving rollout
(``Predictor.rollout`` against ``rollout_tante_latent``, or
``Predictor.rollout_adaptive`` against ``rollout_adaptive_eval_tante`` with
n_calls and the r_t log).  Limit 1e-5: f32 in another summation order
(probes of these geometries matched at <= 7.2e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F, flatten, metadata, transplant
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.train import rollout as jroll
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.serve import Predictor

ATOL = RTOL = 1e-5
RT_BIAS, K = 2.6, 4  # r_t = clip(2.6, 0, K - 1) + 1.001: 3 frames a call

BASE = dict(in_T=2, taylor_order=1, attn_axes="THW", embed_dim=32, patch_scale=8, n_head=2,
            mlp_ratio=1.0, output_length=1, deg=True)
# name -> (frame size, model arguments beside BASE)
CASES = {
    "patch2": ((32, 64), dict(patch_scale=2)),
    "patch4": ((32, 64), dict(patch_scale=4)),
    "patch16": ((32, 64), dict(patch_scale=16)),
    "patch32": ((32, 64), dict(patch_scale=32)),
    "frames48x80": ((48, 80), {}),
    "frames24x40": ((24, 40), {}),
    "order3_fixed": ((32, 64), dict(taylor_order=3, output_length=2, attn_axes="THW-HW-T")),
    "order3_adaptive": ((32, 64), dict(taylor_order=3, output_length=2, attn_axes="THW-HW-T",
                                       deg=False)),
    "order2_lyx_adaptive": ((32, 64), dict(taylor_order=2, attn_axes="THWT-LYX", deg=False)),
    "thw_a_patch16": ((32, 64), dict(taylor_order=2, attn_axes="THW-A", patch_scale=16,
                                     output_length=3)),
    "patch16_overlap25": ((32, 64), dict(patch_scale=16, overlap_ratio=0.25)),
}


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_tante_geometry_matches_jax(name):
    res, extra = CASES[name]
    kw = {**BASE, **extra}
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, res), **kw)
    tm = TANTE(dset_metadata=metadata(TanteMetadata, res), device="cpu", **kw)
    params, tm = transplant(jm, tm, np.zeros((1, 2, *res, F), np.float32), seed=4)
    x = np.random.default_rng(8).normal(size=(2, 2, *res, F)).astype(np.float32)
    pred = Predictor(tm, device="cpu")
    if kw["deg"]:
        n = 2 * kw["output_length"]  # two model calls
        want = jax.jit(lambda p, x: jroll.rollout_tante_latent(jm, p, x, n))(
            params, jnp.asarray(x))
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        assert got.shape == (2, kw["output_length"], *res, F)
        close(got, want[:, :kw["output_length"]])  # the first call's frames
        close(pred.rollout(x, n), want)
        return
    for i in range(kw["taylor_order"]):
        head = params["params"][f"interprators_{i}"]["TorchDense_2"]["Dense_0"]
        head["kernel"] = jnp.zeros_like(head["kernel"])
        head["bias"] = jnp.full_like(head["bias"], RT_BIAS)
    load_jax_params(tm, flatten(params))
    want, want_rt, want_calls = jax.jit(lambda p, x: jroll.rollout_adaptive_eval_tante(
        jm, p, x, 5, max_frames_per_call=K))(params, jnp.asarray(x))
    with torch.no_grad():
        frames, rt = tm(torch.from_numpy(x), float(K))
    assert frames.shape == (2, K, *res, F)
    close(frames[:, :3], want[:, :3])  # the first call emits 3 of its K frames
    close(rt, np.full(2, want_rt[0]))
    y, rt_log, calls = pred.rollout_adaptive(x, 5, max_frames_per_call=K)
    assert calls == int(want_calls) == 2
    close(rt_log, np.asarray(want_rt)[:calls])
    close(y, want)
