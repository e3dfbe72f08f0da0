"""Port parity: the FNO family (``SpectralLayer``, the FNO encoder/decoder,
``TANTE(enc_dec_type="fno")``, FNO, TFNO, UNO) against the JAX package, f32
on the CPU.  One JAX ``init`` per model is flattened to numpy and loaded into
the port through ``convert.py``; both see the same seeded numpy input.

Small geometry: 32x48 (or 16x24) frames of 4 fields, in_T=4, hidden 8-16,
2 layers.  Tolerance 1e-4 abs / 1e-4 rel: f32 through forward and inverse
DFTs and a few matmul layers summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F, T, flatten, metadata, transplant
from test_model_transplant import EMBED, FIXTURES, PATCH, _metadata, _nhwc, sd_of, tante_params
from tante_tpu.data import TanteDataModule
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.data.synthetic import make_well_dataset
from tante_tpu.models.fno import FNO as JaxFNO
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.models.tfno import TFNO as JaxTFNO
from tante_tpu.models.uno import UNO as JaxUNO
from tante_tpu.models.uno import bicubic_resize as jax_bicubic_resize
from tante_tpu.ops.convs import RealConv2d as JaxRealConv2d
from tante_tpu.ops.convs import RealTransConv2d as JaxRealTransConv2d
from tante_tpu.ops.pooling import resize_bilinear as jax_resize_bilinear
from tante_tpu.ops.spectral import SpectralLayer as JaxSpectralLayer
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train.optimizers import AdamW as JaxAdamW
from tante_tpu.train.rollout import rollout_tante_latent as jax_rollout_tante_latent
from tante_tpu.train.trainer import Trainer as JaxTrainer
from tante_tpu_torch.convert import (
    jax_params_from_state_dict,
    load_jax_params,
    seeded_jax_params,
    state_dict_from_jax,
)
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.models.tfno import TFNO
from tante_tpu_torch.models.uno import UNO, bicubic_resize
from tante_tpu_torch.ops import fused_spectral as fs
from tante_tpu_torch.ops.convs import RealConv2d, RealTransConv2d
from tante_tpu_torch.ops.pooling import resize_bilinear
from tante_tpu_torch.ops.spectral import SpectralLayer
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.rollout import rollout_fixed, rollout_tante_latent
from tante_tpu_torch.train.trainer import Trainer

ATOL = RTOL = 1e-4
H, W = 32, 48
TANTE_KW = dict(in_T=T, taylor_order=1, attn_axes="THW", embed_dim=32, patch_scale=8, n_head=4,
                mlp_ratio=1.0, output_length=1, enc_dec_type="fno", modes1=8, modes2=8)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---- layers ---------------------------------------------------------------


def test_spectral_layer_matches_jax():
    x = rand(0, 2, 16, 24, 5)
    tl = SpectralLayer(5, 7, 4, 6, gen=torch.Generator().manual_seed(0))
    params, tl = transplant(JaxSpectralLayer(5, 7, 4, 6), tl, x)
    assert set(tl.state_dict()) == {"weight", "w0.kernel", "w0.bias"}
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    close(got, JaxSpectralLayer(5, 7, 4, 6).apply(params, jnp.asarray(x)))
    with pytest.raises(ValueError):
        tl(torch.from_numpy(x[..., :4]))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("p", [4, 3])
def test_padded_patch_convs_match_jax(p, transposed):
    """Patches of 3 and more pad by (p - 1) // 2 (the FNO pyramid's 4x4
    stage): the shifted-frame matmul, and the crop + bilinear resize of the
    transposed conv, against flax's padded convs."""
    gen = torch.Generator().manual_seed(0)
    if transposed:
        x = rand(1, 2, 4, 6, 5)
        jm, tm = JaxRealTransConv2d(7, p), RealTransConv2d(5, 7, p, gen=gen)
    else:
        x = rand(1, 2, 4 * p, 6 * p, 5)
        jm, tm = JaxRealConv2d(7, p), RealConv2d(5, 7, p, gen=gen)
    params, tm = transplant(jm, tm, x)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == ((2, 4 * p, 6 * p, 7) if transposed else (2, 4, 6, 7))
    close(got, want)
    with pytest.raises(ValueError):  # the packed modes need an unpadded patch
        tm(torch.from_numpy(x), **({"packed_out": True} if transposed else {"packed_in": True}))


@pytest.mark.parametrize("hw,out_hw", [((16, 24), (4, 6)), ((4, 6), (16, 24)), ((9, 7), (5, 14)),
                                       ((8, 12), (8, 12)), ((1, 1), (2, 3))])
def test_resizes_match_jax_image_resize(hw, out_hw):
    """``bicubic_resize`` (UNO) and ``resize_bilinear`` (the transposed patch
    conv) alone: Keys a = -0.5 / triangle kernel, half-pixel centres,
    antialiased when downsampling."""
    x = rand(2, 2, *hw, 3)
    close(bicubic_resize(torch.from_numpy(x), out_hw),
          jax_bicubic_resize(jnp.asarray(x), out_hw), atol=1e-5, rtol=1e-5)
    close(resize_bilinear(torch.from_numpy(x), out_hw),
          jax_resize_bilinear(jnp.asarray(x), out_hw), atol=1e-5, rtol=1e-5)


# ---- TANTE with the FNO encoder/decoder ---------------------------------------


@pytest.fixture(scope="module")
def tante_fno():
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, (H, W)), **TANTE_KW)
    tm = TANTE(dset_metadata=metadata(TanteMetadata, (H, W)), device="cpu", **TANTE_KW)
    params, tm = transplant(jm, tm, np.zeros((1, T, H, W, F), np.float32), seed=1)
    return jm, params, tm


def test_tante_fno_keys_and_gates(tante_fno):
    jm, params, tm = tante_fno
    assert "encoder.SpectralLayer_1.w0.kernel" in tm.state_dict()
    assert tuple(tm.decoders_0.SpectralLayer_1.weight.shape) == (4, F, 8, 8, 2)
    assert not tm.morton_io_ok() and not jm.bind(params).morton_io_ok()
    with pytest.raises(ValueError):
        TANTE(dset_metadata=metadata(TanteMetadata, (H, W)), device="cpu",
              **{**TANTE_KW, "enc_dec_type": "unet"})


def test_enc_fno_matches_jax(tante_fno):
    jm, params, tm = tante_fno
    x = rand(3, 2, T, H, W, F)
    want = jm.apply(params, jnp.asarray(x), method="encode")
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x))
    assert got.shape == want.shape == (2, T, H // 8, W // 8, 32)
    close(got, want)


def test_dec_fno_matches_jax(tante_fno):
    jm, params, tm = tante_fno
    z = rand(4, 2, 1, H // 8, W // 8, 32)
    want = jm.apply(params, jnp.asarray(z), method=lambda m, z: m.decoders[0](z))
    with torch.no_grad():
        got = tm.decoders_0(torch.from_numpy(z))
    assert got.shape == want.shape == (2, 1, H, W, F)
    close(got, want)


def test_tante_fno_forward_matches_jax(tante_fno):
    jm, params, tm = tante_fno
    x = rand(5, 2, T + 1, H, W, F)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close(got, jm.apply(params, jnp.asarray(x)))


def test_tante_fno_latent_rollout_matches_jax(tante_fno):
    """8 steps on physical frames (no Morton route for this encoder), each
    frame encoded once; also equal to the plain sliding-window rollout."""
    jm, params, tm = tante_fno
    x = rand(6, 2, T, H, W, F)
    want = jax_rollout_tante_latent(jm, params, jnp.asarray(x), 8)
    with torch.no_grad():
        got = rollout_tante_latent(tm, torch.from_numpy(x), 8)
        plain = rollout_fixed(tm, torch.from_numpy(x), 8, 1)
    assert got.shape == want.shape == (2, 8, H, W, F)
    close(got, want)
    close(got, plain, atol=1e-5, rtol=1e-5)


def test_reference_tante_fno_state_dict_loads_into_the_port():
    """The reference's own torch state_dict (tests/fixtures/transplant.npz)
    mapped by the layout rules of tests/test_model_transplant.py."""
    fx = np.load(FIXTURES)
    flat = flatten({"params": tante_params(sd_of(fx, "tante_fno"), "fno", deg=True)})
    md = _metadata()
    tm = TANTE(in_T=4, dset_metadata=TanteMetadata(**{
        k: getattr(md, k) for k in ("dataset_name", "n_spatial_dims", "spatial_resolution",
                                    "field_names", "boundary_condition_types", "n_files",
                                    "n_trajectories_per_file", "n_steps_per_trajectory",
                                    "n_fields")}),
        taylor_order=1, attn_axes="THW", embed_dim=EMBED, patch_scale=PATCH, n_head=4,
        mlp_ratio=1.0, dropout=0.0, enc_dec_type="fno", modes1=4, modes2=4, output_length=2,
        device="cpu")
    load_jax_params(tm, flat)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(_nhwc(fx["tante_fno.x"])))
    close(got, _nhwc(fx["tante_fno.y"]), rtol=0)


# ---- FNO / TFNO / UNO -------------------------------------------------------------


FNO_KW = dict(in_T=T, modes1=8, modes2=8, hidden_channels=16, n_layers=2)


@pytest.mark.parametrize("layout", ["cw", "wc"])
@pytest.mark.parametrize("cls", ["FNO", "TFNO"])
def test_fno_and_tfno_match_jax(cls, layout):
    jcls, tcls = {"FNO": (JaxFNO, FNO), "TFNO": (JaxTFNO, TFNO)}[cls]
    x = rand(7, 2, T, H, W, F)
    jm = jcls(dset_metadata=metadata(JaxMetadata, (H, W)), layout=layout, **FNO_KW)
    tm = tcls(dset_metadata=metadata(TanteMetadata, (H, W)), layout=layout, device="cpu",
              **FNO_KW)
    params, tm = transplant(jm, tm, x, seed=2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jm.apply(params, jnp.asarray(x))
    assert got.shape == want.shape == (2, 1, H, W, F)
    close(got, want)


def test_fno_layouts_share_one_parameter_tree_and_checkpointing_changes_nothing():
    md = metadata(TanteMetadata, (H, W))
    x = torch.from_numpy(rand(8, 2, T, H, W, F))
    cw = FNO(dset_metadata=md, device="cpu", **FNO_KW)
    wc = FNO(dset_metadata=md, layout="wc", device="cpu", gradient_checkpointing=True, **FNO_KW)
    wc.load_state_dict(cw.state_dict())
    y_cw, y_wc = cw(x), wc(x)
    close(y_cw.detach(), y_wc.detach())
    y_cw.square().sum().backward()
    y_wc.square().sum().backward()
    for (k, a), b in zip(cw.named_parameters(), wc.parameters()):
        close(a.grad, b.grad, atol=1e-4 * float(a.grad.abs().max()) + 1e-8)
    # sp_mesh (H sharding, tests/test_torch_parallel.py) forces channels-last,
    # as in the JAX package; without it the constructor's layout comes back.
    sharded = FNO(dset_metadata=md, device="cpu", sp_mesh=object(), **FNO_KW)
    assert not sharded.cw and not any(getattr(m, "cw", False) for m in sharded.modules())
    sharded.set_sp_mesh(None)
    assert sharded.cw and all(m.cw for m in sharded.modules() if hasattr(m, "cw"))
    with pytest.raises(ValueError):
        FNO(dset_metadata=md, device="cpu", layout="hw", **FNO_KW)


def test_fno_3d_matches_jax():
    shape = (6, 8, 10)
    kw = dict(in_T=2, modes1=4, modes2=4, modes3=6, hidden_channels=8, n_layers=2)

    def md(cls):
        m = metadata(cls, shape)
        m.n_spatial_dims = 3
        return m

    x = rand(9, 1, 2, *shape, F)
    jm = JaxFNO(dset_metadata=md(JaxMetadata), **kw)
    tm = FNO(dset_metadata=md(TanteMetadata), device="cpu", **kw)
    assert not tm.cw  # 3-D fields take the channels-last layout
    params, tm = transplant(jm, tm, x, seed=3)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jm.apply(params, jnp.asarray(x))
    assert got.shape == want.shape == (1, 1, *shape, F)
    close(got, want)


@pytest.mark.parametrize("pad", [0, 2])
def test_uno_matches_jax(pad):
    """Width 6: every level's channel count is a multiple of nothing; 32x48
    drives the D/32 levels to a 1x1 grid (no kept mode, FFT route)."""
    x = rand(10, 2, T, H, W, F)
    jm = JaxUNO(in_T=T, dset_metadata=metadata(JaxMetadata, (H, W)), width=6, pad=pad)
    tm = UNO(in_T=T, dset_metadata=metadata(TanteMetadata, (H, W)), width=6, pad=pad,
             device="cpu")
    params, tm = transplant(jm, tm, x, seed=4)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jm.apply(params, jnp.asarray(x))
    assert got.shape == want.shape == (2, 1, H, W, F)
    close(got, want)


# ---- serving and training ---------------------------------------------------------


def test_predictor_keeps_spectral_weights_f32_and_counts_mode_mixing_calls(monkeypatch):
    md = metadata(TanteMetadata, (H, W))
    x = rand(11, 2, T, H, W, F)
    calls = []
    real = fs.spectral_mode_matmul_ref
    monkeypatch.setattr(fs, "spectral_mode_matmul_ref",
                        lambda *a: calls.append(a[2].shape) or real(*a))
    for model, per_call, first in (
        (FNO(dset_metadata=md, dtype=torch.bfloat16, device="cpu", **FNO_KW), 2, 0),
        (TFNO(dset_metadata=md, dtype=torch.bfloat16, device="cpu", **FNO_KW), 2, 0),
        # two corners a block; L2-L4 touch the 1x1 grid of D/32 and keep no mode
        (UNO(in_T=T, dset_metadata=md, width=6, dtype=torch.bfloat16, device="cpu"), 8, 0),
        # latent rollout: the window's encode (2), then per step decode (2) + encode (2)
        (TANTE(dset_metadata=md, dtype=torch.bfloat16, device="cpu", **TANTE_KW), 4, 2),
    ):
        pred = Predictor.from_numpy(model, seeded_jax_params(model, 0), device="cpu")
        kept = {n for m in model.modules() for n in getattr(m, "mode_space_params", ())}
        assert kept
        for name, p in model.named_parameters():
            want = torch.float32 if name.rsplit(".", 1)[-1] in kept else torch.bfloat16
            assert p.dtype == want, name
        calls.clear()
        y = pred.rollout(x, 3, out_dtype=torch.bfloat16)
        assert y.shape == (2, 3, H, W, F) and y.dtype == torch.bfloat16
        assert bool(torch.isfinite(y).all())
        assert len(calls) == first + 3 * per_call, type(model).__name__


def test_one_step_of_both_trainers_on_fno(tmp_path):
    """The JAX ``Trainer`` over the HDF5 files and the port's over the
    in-memory waves of the same seed, FNO (cw), same initial weights."""
    waves = dict(resolution=(16, 24), n_trajectories=2, n_steps=10, with_pressure=True, seed=0)
    kw = dict(in_T=T, modes1=6, modes2=6, hidden_channels=8, n_layers=2)
    make_well_dataset(str(tmp_path / "data"), dataset_name="synthetic_waves", **waves)
    jdm = TanteDataModule(base_path=str(tmp_path / "data"), dataset_name="synthetic_waves",
                          batch_size=2, n_steps_input=T, n_steps_output=2, eval_steps_output=3,
                          data_workers=2, seed=0)
    tdm = WaveDataModule(batch_size=2, n_steps_input=T, n_steps_output=2, eval_steps_output=3,
                         data_workers=2, seed=0, device="cpu", waves=waves)
    common = dict(max_epoch=2, n_steps_output=2, n_steps_rollout=3, seed=0)
    jt = JaxTrainer(str(tmp_path / "jax"), "channels_last_default",
                    JaxFNO(dset_metadata=jdm.train_dataset.metadata, **kw), jdm,
                    JaxAdamW(lr=1e-3, weight_decay=1e-5), jmetrics.MSE(), jmetrics.VRMSE(),
                    **common)
    tm = FNO(dset_metadata=tdm.train_dataset.metadata, device="cpu", **kw)
    start = flatten(jt.params)
    assert set(state_dict_from_jax(start)) == set(tm.state_dict())
    load_jax_params(tm, start)
    tr = Trainer(str(tmp_path / "torch"), "channels_last_default", tm, tdm,
                 AdamW(lr=1e-3, weight_decay=1e-5), tmetrics.MSE(), tmetrics.VRMSE(),
                 device="cpu", **common)
    val_j = jt.validation_loop(jdm.val_dataloader())
    assert tr.validation_loop(tdm.val_dataloader()) == pytest.approx(val_j, rel=1e-4)
    jb, tb = next(iter(jdm.train_dataloader())), next(iter(tdm.train_dataloader()))
    (jx,), jy = jt.formatter.process_input(jb)
    (tx,), ty = tr.formatter.process_input(tb)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jt.params, jt.opt_state, jloss = jt._train_step(
        jt.params, jt.opt_state, jx, jy, jt._next_dropout_key())
    tloss = tr.train_step(tx, ty)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-4)
    # One AdamW step at lr 1e-3 moves every entry by ~1e-3: held to a
    # twentieth of the step.
    want, got = flatten(jt.params), jax_params_from_state_dict(tm.state_dict())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=0.05 * 1e-3, rtol=0, err_msg=k)
        assert np.abs(got[k] - start[k]).max() > 1e-4, k
