"""Port parity: the TANTE model's modules (``tante_tpu_torch.models``)
against the JAX package, f32 on the CPU.  One JAX ``init`` per model is
flattened to numpy and loaded into the port through ``convert.py``, and
both see the same seeded numpy input.

Geometry: in_T=4, 32x64 frames of 4 fields, patch_scale=8 (latent 4x8),
embed 128, 4 heads.  Tolerance 1e-4 abs / 1e-4 rel: f32 through a dozen
matmul layers summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import B, F, H, KW, PS, T, W, flatten, frames, metadata, models
from tante_tpu.models.attn_backbone import AttnBackbone as JaxBackbone
from tante_tpu.ops.convs import morton_pack_grouped as jax_mpg
from tante_tpu_torch.convert import load_jax_params, state_dict_from_jax
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.attn_backbone import AttnBackbone
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import convs as tconvs

ATOL = RTOL = 1e-4


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_state_dict_keys_are_the_flax_paths():
    jm, params, tm = models(False)
    flat = flatten(params)
    assert set(state_dict_from_jax(flat)) == set(tm.state_dict())
    assert tuple(tm.encoder.RealConv2d_0.Conv_0.kernel.shape) == flat[
        "encoder/RealConv2d_0/Conv_0/kernel"].shape == (2, 2, F, 32)


def test_load_rejects_missing_or_misshapen_weights():
    jm, params, tm = models(True)
    flat = flatten(params)
    with pytest.raises(KeyError):
        load_jax_params(tm, {k: v for k, v in flat.items() if "t_emb" not in k})
    bad = dict(flat)
    bad["t_emb"] = np.zeros((1, 2, 128), np.float32)
    with pytest.raises(ValueError):
        load_jax_params(tm, bad)


def test_morton_pack_round_trip_matches_jax():
    x = frames(0)
    got = tconvs.morton_pack_grouped(torch.from_numpy(x), PS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mpg(jnp.asarray(x), PS)))
    back = tconvs.morton_unpack_grouped(got, PS, (H, W))
    np.testing.assert_array_equal(back.numpy(), x)
    packed = tconvs.pack_patches(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tconvs.unpack_patches(packed, 2).numpy(), x)


@pytest.mark.parametrize("packed", [False, "morton"])
def test_encoder_matches_jax(packed):
    jm, params, tm = models(True)
    x = frames(1)
    xin = np.array(jax_mpg(jnp.asarray(x), PS)) if packed else x
    want = jm.apply(params, jnp.asarray(xin), method="encode", packed=packed)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(xin), packed=packed)
    assert got.shape == want.shape == (B, T, 4, 8, 128)
    close(got, want)


@pytest.mark.parametrize("packed", [False, "morton"])
def test_decoder_matches_jax(packed):
    jm, params, tm = models(True)
    z = np.random.default_rng(2).normal(size=(B, 1, 4, 8, 128)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(z),
                    method=lambda m, z: m.decoders[0](z, packed_out=packed))
    with torch.no_grad():
        got = tm.decoders_0(torch.from_numpy(z), packed_out=packed)
    assert got.shape == want.shape
    close(got, want)


def test_backbone_matches_jax():
    shape = (T, 4, 8, 128)
    jb = JaxBackbone(tensor_shape=shape, attn_axes="THWTHW", n_head=4, mlp_ratio=1.0)
    x = np.random.default_rng(4).normal(size=(B, *shape)).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(5), jnp.asarray(x))
    tb = AttnBackbone(shape, "THWTHW", 4, 1.0)
    load_jax_params(tb, flatten(params))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    close(got, jb.apply(params, jnp.asarray(x)))


def test_backbone_other_axes_match_jax():
    """L / Y / X / A and the rearranged T path (C=64 < 128 leaves the
    canonical gate) through the same block math."""
    shape = (T, 4, 8, 64)
    axes = "LYXAT"
    jb = JaxBackbone(tensor_shape=shape, attn_axes=axes, n_head=4, mlp_ratio=2.0)
    x = np.random.default_rng(6).normal(size=(1, *shape)).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(6), jnp.asarray(x))
    tb = AttnBackbone(shape, axes, 4, 2.0)
    load_jax_params(tb, flatten(params))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    close(got, jb.apply(params, jnp.asarray(x)))


def test_channel_axis_is_not_ported():
    with pytest.raises(NotImplementedError):
        AttnBackbone((T, 4, 8, 64), "TC", 4)


@pytest.mark.parametrize("deg", [True, False])
def test_head_matches_jax(deg):
    jm, params, tm = models(deg)
    lat = np.random.default_rng(7).normal(size=(B, T, 4, 8, 128)).astype(np.float32)
    u = np.array(jax_mpg(jnp.asarray(frames(8, 1)), PS))
    want = jm.apply(params, jnp.asarray(lat), jnp.asarray(u), 3.0, method="head",
                    packed="morton")
    with torch.no_grad():
        got = tm.head(torch.from_numpy(lat), torch.from_numpy(u), 3.0, packed="morton")
    if deg:
        close(got, want)
    else:
        assert got[0].shape == want[0].shape == (B, 3, 32, 256)
        close(got[0], want[0])
        close(got[1], want[1])


@pytest.mark.parametrize("deg", [True, False])
def test_tante_call_matches_jax(deg):
    jm, params, tm = models(deg)
    x = frames(9, T + 1)  # one extra frame: the model keeps the last in_T
    args = () if deg else (2.5,)
    want = jm.apply(params, jnp.asarray(x), *args)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *args)
    if deg:
        assert got.shape == want.shape == (B, 1, H, W, F)
        close(got, want)
    else:
        assert got[0].shape == want[0].shape == (B, 2, H, W, F)
        close(got[0], want[0])
        close(got[1], want[1])


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, building the model with no device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TANTE(dset_metadata=metadata(TanteMetadata), **KW)
