"""Port parity of TANTE beyond the shared test geometry: the reference's own
``tante_cnn`` / ``tante_ad`` torch state_dicts (``tests/fixtures/transplant.npz``,
mapped by ``tests/test_model_transplant.py``'s layout rules) loaded into the
port, and a second-order Taylor TANTE against the JAX package (forward,
latent rollout, adaptive rollout), f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flatten, metadata
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.train import rollout as jroll
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.train import rollout as troll
from test_model_transplant import (
    EMBED, FIXTURES, PATCH, T, _metadata, _nhwc, sd_of, tante_params,
)


def port_metadata():
    md = _metadata()
    return TanteMetadata(**{k: getattr(md, k) for k in (
        "dataset_name", "n_spatial_dims", "spatial_resolution", "field_names",
        "boundary_condition_types", "n_files", "n_trajectories_per_file",
        "n_steps_per_trajectory", "n_fields")})


def reference_tante(tag, deg, output_length):
    """The port's TANTE at ``build_tante``'s geometry with the reference's
    ``tag`` weights."""
    fx = np.load(FIXTURES)
    tm = TANTE(in_T=T, dset_metadata=port_metadata(), taylor_order=1, attn_axes="THW",
               embed_dim=EMBED, patch_scale=PATCH, n_head=4, mlp_ratio=1.0, dropout=0.0,
               output_length=output_length, deg=deg, device="cpu")
    load_jax_params(tm, flatten({"params": tante_params(sd_of(fx, tag), "cnn", deg=deg)}))
    return fx, tm.eval()


def test_reference_tante_cnn_state_dict_loads_into_the_port():
    fx, tm = reference_tante("tante_cnn", deg=True, output_length=2)
    with torch.no_grad():
        got = tm(torch.from_numpy(_nhwc(fx["tante_cnn.x"])))
    # test_model_transplant.py's tolerance for the JAX package: 1e-4.
    np.testing.assert_allclose(got.numpy(), _nhwc(fx["tante_cnn.y"]), atol=1e-4, rtol=0)


def test_reference_tante_ad_state_dict_loads_into_the_port():
    fx, tm = reference_tante("tante_ad", deg=False, output_length=1)
    with torch.no_grad():
        got, rt = tm(torch.from_numpy(_nhwc(fx["tante_ad.x"])), 4.0)
    np.testing.assert_allclose(rt.numpy(), fx["tante_ad.rt"], atol=1e-4, rtol=0)
    # The reference emits floor(R_t[0]) frames; the port computes the static
    # n_frames(out_T) = 4 budget: the frames the reference emitted agree.
    n_ref = fx["tante_ad.y"].shape[1]
    assert got.shape[1] == 4 >= n_ref
    np.testing.assert_allclose(got[:, :n_ref].numpy(), _nhwc(fx["tante_ad.y"]), atol=1e-4,
                               rtol=0)


# ---- taylor_order = 2 ------------------------------------------------------------

RES, B2, F2 = (32, 64), 2, 4
KW2 = dict(in_T=4, taylor_order=2, attn_axes="THW-HWT", frame_interval=0.5,
           output_length=3, embed_dim=32, patch_scale=8, n_head=4, mlp_ratio=1.0)
# f32, another summation order, compounded over the rollout's calls.
ATOL = RTOL = 1e-4


def order2(deg, rt_bias=None):
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, RES), deg=deg, **KW2)
    x0 = jnp.zeros((1, 4, *RES, F2), jnp.float32)
    params = jm.init(jax.random.PRNGKey(7), x0, *(() if deg else (2.5,)))
    if rt_bias is not None:  # every call's r_t = clip(rt_bias, 0, out_T - 1) + 1.001
        for i in range(2):
            head = params["params"][f"interprators_{i}"]["TorchDense_2"]["Dense_0"]
            head["kernel"] = jnp.zeros_like(head["kernel"])
            head["bias"] = jnp.full_like(head["bias"], rt_bias)
    tm = TANTE(dset_metadata=metadata(TanteMetadata, RES), deg=deg, device="cpu", **KW2)
    load_jax_params(tm, flatten(params))
    return jm, params, tm.eval()


def inputs(seed, n=4):
    return np.random.default_rng(seed).normal(size=(B2, n, *RES, F2)).astype(np.float32)


@pytest.mark.parametrize("deg", [True, False])
def test_taylor_order_2_forward_matches_jax(deg):
    jm, params, tm = order2(deg)
    x = inputs(1)
    args = () if deg else (4.0,)
    want = jm.apply(params, jnp.asarray(x), *args)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *args)
    if deg:
        assert got.shape == (B2, 3, *RES, F2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    else:
        assert got[0].shape == (B2, 4, *RES, F2)  # n_frames(4.0) Taylor frames
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_taylor_order_2_latent_rollout_matches_jax():
    jm, params, tm = order2(True)
    x = inputs(2)
    want = jroll.rollout_tante_latent(jm, params, jnp.asarray(x), 7)
    with torch.no_grad():
        got = troll.rollout_tante_latent(tm, torch.from_numpy(x), 7)
    assert got.shape == (B2, 7, *RES, F2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_taylor_order_2_adaptive_rollout_matches_jax():
    # r_t = clip(1.6, 0, 3) + 1.001 = 2.601 at K = 4: 2 frames a call, 4 calls.
    jm, params, tm = order2(False, rt_bias=1.6)
    x = inputs(3)
    want, want_rt, want_calls = jroll.rollout_adaptive_eval_tante(
        jm, params, jnp.asarray(x), 7, max_frames_per_call=4)
    with torch.no_grad():
        got, got_rt, got_calls = troll.rollout_adaptive_eval_tante(
            tm, torch.from_numpy(x), 7, max_frames_per_call=4)
    assert got_calls == int(want_calls) == 4
    np.testing.assert_allclose(got_rt.numpy()[:got_calls], np.asarray(want_rt)[:got_calls],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
