"""Port parity: overlapping patch convs (``overlap_ratio > 0``) and the packed
enc/dec API (``packed=True``) against the JAX package, f32 on the CPU.

Each test builds the JAX module and the port's from one seeded parameter
tree (``convert.seeded_jax_params``) and feeds both the same numpy input.
The pieces: ``adaptive_avg_pool2d``; ``RealConv2d`` / ``RealTransConv2d``
with stride below the patch, with and without ``enforce_patch_grid``, and
against the reference's own torch outputs (``tests/fixtures/parity.npz``);
the CNN and FNO encoders / decoders; the whole TANTE (fixed and adaptive)
and its rollouts; a first ``Trainer`` step; the ``cli.train`` override;
``TANTE.packed_io_ok`` and ``encode`` / ``head`` with ``packed=True``.

Geometries: the flagship's pyramid at overlap 0.5 (``patch_scale=8``,
stride 1 at every stage: 0.25 rounds to stride 2 there), the CNN at
``patch_scale=16`` and overlap 0.25 (stage 0: patch 4, stride 3, pad 1)
and the FNO pyramid at ``patch_scale=8`` and 0.25 (the same first stage),
embed 32, 2 heads, 32x64 frames.  Limits stand beside their assertions."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F, flatten, metadata, transplant
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.enc_dec_cnn import PATCH_MAP as JAX_PATCH_MAP
from tante_tpu.models.enc_dec_cnn import DecCNN as JaxDecCNN
from tante_tpu.models.enc_dec_cnn import EncCNN as JaxEncCNN
from tante_tpu.models.enc_dec_fno import DecFNO as JaxDecFNO
from tante_tpu.models.enc_dec_fno import EncFNO as JaxEncFNO
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.ops.convs import RealConv2d as JaxRealConv2d
from tante_tpu.ops.convs import RealTransConv2d as JaxRealTransConv2d
from tante_tpu.ops.convs import pack_patches as jax_pack_patches
from tante_tpu.ops.pooling import adaptive_avg_pool2d as jax_pool
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train import rollout as jroll
from tante_tpu_torch.cli import train as cli_train
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.enc_dec_cnn import PATCH_MAP, DecCNN, EncCNN
from tante_tpu_torch.models.enc_dec_fno import DecFNO, EncFNO
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops.convs import RealConv2d, RealTransConv2d, pack_patches, unpack_patches
from tante_tpu_torch.ops.pooling import adaptive_avg_pool2d
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.trainer import Trainer

RES = (32, 64)
# f32 through a conv / pool / resize pyramid and a few blocks, summed in
# another order (the geometry probes matched at <= 7.2e-7).
ATOL = RTOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "parity.npz")

# name -> (encoder / decoder kind, patch_scale, overlap_ratio)
GEOMETRIES = {"cnn_p8_o50": ("cnn", 8, 0.5), "cnn_p16_o25": ("cnn", 16, 0.25),
              "fno_p8_o25": ("fno", 8, 0.25)}
MODES = (8, 8)
# r_t = clip(2.6, 0, K - 1) + 1.001 = 3.601: 3 frames a call at K = 4.
RT_BIAS, K = 2.6, 4


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# JAX's pool compiled whole: op by op it compiles each primitive at each size.
jax_pool_jit = jax.jit(jax_pool, static_argnums=1)


# ---- the pool -------------------------------------------------------------


@pytest.mark.parametrize("hw,out_hw", [((127, 383), (64, 192)), ((43, 128), (32, 96)),
                                       ((7, 43), (3, 32)), ((128, 7), (96, 3)),
                                       ((383, 127), (192, 64))])
def test_adaptive_avg_pool_matches_jax(hw, out_hw):
    """Torch's bins (the flagship's 127 x 383 -> 64 x 192 at overlap 0.5,
    the FNO stage's 43 x 128 -> 32 x 96 at 0.25, and small ones).  The port
    sums each bin; JAX takes differences of cumulative sums, whose rounding
    grows with the running total (1.75e-6 off float64 at 383 wide).  So the
    port is held to float64 at 1e-6, and to JAX at 1e-6 beyond JAX's own
    distance from float64."""
    x = rand(0, 2, *hw, 3)
    got = adaptive_avg_pool2d(torch.from_numpy(x), out_hw).numpy()
    exact = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(x).double().permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax_pool_jit(jnp.asarray(x), out_hw))
    assert got.shape == want.shape == (2, *out_hw, 3)
    close(got, exact, atol=1e-6, rtol=0)
    close(got, want, atol=1e-6 + np.abs(want - exact).max(), rtol=0)


def test_adaptive_avg_pool_returns_its_input_at_the_same_size():
    x = torch.from_numpy(rand(1, 2, 3, 16, 24, 5))
    assert adaptive_avg_pool2d(x, (16, 24)) is x
    y = adaptive_avg_pool2d(x, (8, 24))  # one axis pooled, lead axes kept
    assert y.shape == (2, 3, 8, 24, 5)
    close(y, jax_pool_jit(jnp.asarray(x.numpy()), (8, 24)), atol=1e-6, rtol=0)


def test_adaptive_avg_pool_bf16_rounds_the_f32_average_once():
    """In bf16 the port averages in f32 and rounds once: its output is the
    f32 pool of the same bf16 input rounded to bf16, within one rounding
    (half a bf16 unit) of the f32 value."""
    x = torch.from_numpy(rand(2, 1, 127, 383, 4) + 3.0).bfloat16()
    got = adaptive_avg_pool2d(x, (64, 192))
    f32 = adaptive_avg_pool2d(x.float(), (64, 192))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.bfloat16())
    half_ulp = 2.0 ** (torch.frexp(f32)[1].float() - 9)  # 8 mantissa bits: ulp / 2
    assert bool(((got.float() - f32).abs() <= half_ulp).all())


# ---- the patch convs ------------------------------------------------------


@pytest.mark.parametrize("enforce", [True, False])
@pytest.mark.parametrize("overlap", [0.25, 0.5])
@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("transposed", [False, True])
def test_overlapping_patch_convs_match_flax(transposed, p, overlap, enforce):
    """Stride max(1, round(p (1 - overlap))): patch 2 at 0.25 keeps stride 2
    (the matmul path), every other case convolves.  ``enforce_patch_grid``
    pools (conv) / resizes (transposed conv) to the patch grid; without it
    the conv also takes a frame the patch does not divide."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(overlap_ratio=overlap, enforce_patch_grid=enforce)
    if transposed:
        x = rand(1, 2, 4, 6, 5)
        jm, tm = JaxRealTransConv2d(7, p, **kw), RealTransConv2d(5, 7, p, gen=gen, **kw)
        full = (2, 4 * p, 6 * p, 7)
    else:
        hw = (4 * p, 6 * p) if enforce else (4 * p + 1, 6 * p - 1)
        x = rand(1, 2, *hw, 5)
        jm, tm = JaxRealConv2d(7, p, **kw), RealConv2d(5, 7, p, gen=gen, **kw)
        full = (2, 4, 6, 7)
    params, tm = transplant(jm, tm, x)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    assert got.shape == full or not enforce
    close(got, want)


def test_conv_grid_needs_a_divisible_frame():
    tm = RealConv2d(5, 7, 4, 0.5, gen=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divisible"):
        tm(torch.zeros(1, 17, 24, 5))
    for mod, kw in ((tm, {"packed_in": True}),
                    (RealTransConv2d(5, 7, 2, 0.5, gen=torch.Generator()), {"packed_out": True})):
        with pytest.raises(ValueError, match="stride"):  # the packed modes need stride == patch
            mod(torch.zeros(1, 4, 4, 5), **kw)


@pytest.mark.parametrize("tag", ["conv_o0", "conv_o25", "tconv_o0", "tconv_o25"])
def test_patch_convs_match_the_references_torch_outputs(tag):
    """The reference's own torch ``RealConv2d`` / ``RealTransConv2d`` outputs
    (patch 4, overlap 0 and 0.25) with its weights mapped as
    ``tests/test_numerical_parity.py:55-95`` maps them: OIHW -> HWIO for the
    conv, the ConvTranspose2d weight (in, out, kh, kw) -> (kh, kw, in, out)
    flipped spatially for the transposed conv."""
    fx = np.load(FIXTURES)
    w, b = fx[f"{tag}_w"], fx[f"{tag}_b"]
    overlap = 0.25 if tag.endswith("o25") else 0.0
    if tag.startswith("tconv"):
        x = np.transpose(fx[f"{tag}_x"], (0, 2, 3, 1))
        kernel = np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])
        tm = RealTransConv2d(w.shape[0], w.shape[1], 4, overlap)
        load_jax_params(tm, {"ConvTranspose_0/kernel": kernel, "ConvTranspose_0/bias": b})
    else:
        x = np.transpose(fx["conv_x"], (0, 2, 3, 1))
        tm = RealConv2d(w.shape[1], w.shape[0], 4, overlap)
        load_jax_params(tm, {"Conv_0/kernel": np.transpose(w, (2, 3, 1, 0)), "Conv_0/bias": b})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close(got, np.transpose(fx[f"{tag}_y"], (0, 2, 3, 1)), atol=2e-5, rtol=0)


# ---- encoders and decoders ------------------------------------------------


@pytest.mark.parametrize("part", ["encoder", "decoder"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_overlapping_enc_dec_match_jax(geometry, part):
    kind, ps, overlap = GEOMETRIES[geometry]
    kw = dict(embed_dim=32, patch_scale=ps, overlap_ratio=overlap)
    if kind == "fno":
        kw["modes"] = MODES
    jcls, tcls = {("cnn", "encoder"): (JaxEncCNN, EncCNN), ("cnn", "decoder"): (JaxDecCNN, DecCNN),
                  ("fno", "encoder"): (JaxEncFNO, EncFNO),
                  ("fno", "decoder"): (JaxDecFNO, DecFNO)}[kind, part]
    latent = (RES[0] // ps, RES[1] // ps)
    x = rand(3, 2, 2, *(RES if part == "encoder" else latent), F if part == "encoder" else 32)
    jm = jcls(dset_metadata=metadata(JaxMetadata, RES), **kw)
    params, tm = transplant(jm, tcls(dset_metadata=metadata(TanteMetadata, RES),
                                     gen=torch.Generator().manual_seed(0), **kw), x)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == ((2, 2, *latent, 32) if part == "encoder"
                                       else (2, 2, *RES, F))
    close(got, want)


# ---- the whole TANTE ------------------------------------------------------


def tante_kw(geometry, deg):
    kind, ps, overlap = GEOMETRIES[geometry]
    return dict(in_T=2, taylor_order=1, attn_axes="THW", embed_dim=32, patch_scale=ps,
                n_head=2, mlp_ratio=1.0, output_length=1, enc_dec_type=kind,
                overlap_ratio=overlap, modes1=MODES[0], modes2=MODES[1], deg=deg)


def tante_pair(geometry, deg, seed=1, **extra):
    """(jax model, its params, port model) from one seeded tree; adaptive
    models get the interprator head that reports r_t = RT_BIAS + 1.001."""
    kw = {**tante_kw(geometry, deg), **extra}
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, RES), **kw)
    tm = TANTE(dset_metadata=metadata(TanteMetadata, RES), device="cpu", **kw)
    params, tm = transplant(jm, tm, np.zeros((1, 2, *RES, F), np.float32), seed=seed)
    if not deg:
        head = params["params"]["interprators_0"]["TorchDense_2"]["Dense_0"]
        head["kernel"] = jnp.zeros_like(head["kernel"])
        head["bias"] = jnp.full_like(head["bias"], RT_BIAS)
        load_jax_params(tm, flatten(params))
    return jm, params, tm


@pytest.mark.parametrize("deg", [True, False])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_overlapping_tante_and_its_rollouts_match_jax(geometry, deg):
    """The model call, then the serving rollouts: ``Predictor.rollout``
    against ``rollout_tante_latent`` (fixed), ``Predictor.rollout_adaptive``
    against ``rollout_adaptive_eval_tante`` (adaptive: n_calls equal).  Under
    overlap neither Morton gate opens, in either package."""
    jm, params, tm = tante_pair(geometry, deg)
    assert not tm.morton_io_ok() and not tm.packed_io_ok()
    assert not jm.morton_io_ok() and not jm.packed_io_ok()
    x = rand(4, 2, 2, *RES, F)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), float(K))
    pred = Predictor(tm, device="cpu")
    # The rollouts' first frames are the model call's (one JAX compile).
    if deg:
        want = jax.jit(lambda p, x: jroll.rollout_tante_latent(jm, p, x, 2))(params, jnp.asarray(x))
        close(got, want[:, :1])
        close(pred.rollout(x, 2), want)
        return
    want, want_rt, want_calls = jax.jit(lambda p, x: jroll.rollout_adaptive_eval_tante(
        jm, p, x, 5, max_frames_per_call=K))(params, jnp.asarray(x))
    close(got[0][:, :3], want[:, :3])
    close(got[1], np.full(2, want_rt[0]))
    y, rt, calls = pred.rollout_adaptive(x, 5, max_frames_per_call=K)
    assert calls == int(want_calls) == 2
    close(rt, np.asarray(want_rt)[:calls])
    close(y, want)


def test_first_trainer_step_at_overlap_matches_jax(tmp_path):
    """The training objective at overlap 0.5 (two rollout steps, MSE) and
    every gradient against ``jax.value_and_grad`` from one parameter tree;
    then one ``Trainer`` step moves the weights."""
    jm, params, tm = tante_pair("cnn_p8_o50", True, seed=2)
    tm.train()
    rng = np.random.default_rng(5)
    x, y = (rng.normal(size=(2, n, *RES, F)).astype(np.float32) for n in (2, 2))

    def jloss(p):
        pred = jroll.rollout_fixed(lambda w: jm.apply({"params": p}, w), jnp.asarray(x), 2, 1)
        return jnp.mean(jmetrics.MSE()(pred, jnp.asarray(y), None))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params["params"])
    waves = dict(resolution=RES, n_trajectories=2, n_steps=8, with_pressure=True, seed=0)
    dm = WaveDataModule(batch_size=2, n_steps_input=2, n_steps_output=2, device="cpu", waves=waves)
    trainer = Trainer(str(tmp_path), "channels_last_default", tm, dm, AdamW(lr=1e-3),
                      tmetrics.MSE(), tmetrics.VRMSE(), max_epoch=1, n_steps_output=2,
                      device="cpu")
    loss = trainer._loss(torch.from_numpy(x), torch.from_numpy(y), 2, trainer.train_loss_fn,
                         deterministic=False)
    trainer.optimizer.zero_grad()
    loss.backward()
    # f32 through two model calls, summed in another order.
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    jg = flatten({"params": want_grads})
    for name, q in tm.named_parameters():
        k = name.replace(".", "/")
        close(q.grad.numpy(), jg[k], atol=1e-5 * np.abs(jg[k]).max() + 1e-9, rtol=1e-4)
    before = tm.encoder.RealConv2d_0.Conv_0.kernel.detach().clone()
    assert np.isfinite(float(trainer.train_step(torch.from_numpy(x), torch.from_numpy(y))))
    assert not torch.equal(before, tm.encoder.RealConv2d_0.Conv_0.kernel)


def test_overlap_override_reaches_the_model_through_the_train_cli(well_root_tiny, tmp_path):
    ov = [f"data.base_path={well_root_tiny}", "data.dataset_name=synthetic_waves",
          "data.batch_size=2", "data.n_steps_output=1", "data.eval_steps_output=2",
          "data.data_workers=0", "trainer.max_epoch=1", "trainer.n_steps_output=1",
          "trainer.n_steps_rollout=2", f"root_path={tmp_path}", "experiment=O",
          "model.embed_dim=16", "model.n_head=2", "model.attn_axes=TH",
          "model.overlap_ratio=0.5"]
    trainer = cli_train.main(["--config-name=tante", "--device", "cpu", *ov])
    model = trainer.model
    assert model.overlap_ratio == 0.5
    assert [getattr(model.encoder, f"RealConv2d_{i}").stride for i in range(3)] == [1, 1, 1]
    assert model.decoders_0.RealTransConv2d_2.stride == 1
    assert np.isfinite(trainer.validation_loop(trainer.datamodule.val_dataloader()))


# ---- the packed API -------------------------------------------------------


@pytest.mark.parametrize("overlap", [0.0, 0.25, 0.5])
def test_packed_io_ok_matches_jax(overlap):
    """At every ``PATCH_MAP`` entry; where it holds, so does ``morton_io_ok``
    (no rollout reaches the packed branch in either package)."""
    assert PATCH_MAP == JAX_PATCH_MAP
    res = (128, 128)
    for ps in PATCH_MAP:
        kw = dict(in_T=2, attn_axes="T", embed_dim=16, n_head=2, patch_scale=ps,
                  overlap_ratio=overlap)
        jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, res), **kw)
        tm = TANTE(dset_metadata=metadata(TanteMetadata, res), device="cpu", **kw)
        assert tm.packed_io_ok() == jm.packed_io_ok() == (overlap == 0.0 and PATCH_MAP[ps][0] == 2)
        assert tm.morton_io_ok() == jm.morton_io_ok()
        assert tm.morton_io_ok() or not tm.packed_io_ok()
    fno = TANTE(dset_metadata=metadata(TanteMetadata, res), device="cpu", enc_dec_type="fno",
                modes1=8, modes2=8, **{**kw, "patch_scale": 8})
    assert not fno.packed_io_ok()


@pytest.mark.parametrize("ps,overlap", [(8, 0.0), (8, 0.25), (4, 0.0), (2, 0.0)])
def test_packed_encode_and_head_match_the_plain_path_and_jax(ps, overlap):
    """``tests/test_models_tante.py:147-205`` in the port: ``encode`` on
    ``pack_patches(x, p0)`` equals ``encode(x)``, ``head`` with packed frames
    equals ``pack_patches`` of the plain head, and both equal JAX's packed
    calls.  (8, 0): the all-dense pyramid; (4, 0) and (2, 0): with pointwise
    stages; (8, 0.25): stride 2 == patch everywhere, but not ``packed_patch_ok``,
    so only stage 0 takes the packed input."""
    jm, params, tm = tante_pair("cnn_p8_o50", True, seed=3, patch_scale=ps,
                                overlap_ratio=overlap)
    p0 = PATCH_MAP[ps][0]
    x = rand(6, 2, 2, *RES, F)
    xp = jax_pack_patches(jnp.asarray(x), p0)
    with torch.no_grad():
        lat = tm.encode(torch.from_numpy(x))
        lat_p = tm.encode(pack_patches(torch.from_numpy(x), p0), packed=True)
        u = torch.from_numpy(x[:, -1:])
        frames = tm.head(lat, u)
        frames_p = tm.head(lat, pack_patches(u, p0), packed=True)
    close(pack_patches(torch.from_numpy(x), p0), xp, atol=0, rtol=0)
    close(lat_p, lat)
    close(unpack_patches(frames_p, p0), frames)

    @jax.jit  # both packed calls in one compile
    def jax_packed(p, x, z, u):
        return (jm.apply(p, x, method="encode", packed=True),
                jm.apply(p, z, u, method="head", packed=True))

    want_lat, want_frames = jax_packed(params, xp, jnp.asarray(lat.numpy()),
                                       jax_pack_patches(jnp.asarray(x[:, -1:]), p0))
    close(lat_p, want_lat)
    close(frames_p, want_frames)
