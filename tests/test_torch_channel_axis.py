"""Port parity: the channel-lift attention axis ``C`` (``AttnBackbone`` and
``TANTE`` with ``expanded_channel``) against the JAX package, f32 on the CPU.
One JAX ``init`` per model is loaded into the port through ``convert.py``;
both see the same seeded numpy input.

A C block turns each token's C values into a sequence of C scalars, lifts
each to ``expanded_channel`` with its own ``channel_lift_{k}`` Mlp, attends
across the channels and keeps the last feature
(``tante_tpu/models/attn_backbone.py:266-279``).

Tolerances: 1e-4 abs / 1e-4 rel in f32, as the model tests (f32 through a
dozen matmul layers summed in another order); bf16 in relative L2 of the
backbone's change, 2e-2 (both packages round q/k/v, attention weights and
residuals to bf16, at places that differ: PyTorch's bf16 GELU and softmax
compute in f32 and round once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F, flatten, metadata, transplant
from tante_tpu import config as jconfig
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.attn_backbone import AttnBackbone as JaxBackbone
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train import rollout as jroll
from tante_tpu_torch import config
from tante_tpu_torch.convert import load_jax_params, state_dict_from_jax
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.attn_backbone import AttnBackbone
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train import rollout as troll
from tante_tpu_torch.train.optimizers import AdamW, global_norm
from tante_tpu_torch.train.trainer import Trainer

ATOL = RTOL = 1e-4
BF16_REL_L2 = 2e-2
SHAPE = (4, 4, 8, 64)  # (T, H, W, C): the C block runs over 64 channels
RES, B = (32, 64), 2
# The slab's TANTE: every axis of the JAX alphabet, patch 8 -> a 4 x 8 latent
# grid (L 32, Y 16, X 32, A 128, C 64 channels lifted to 16).
TANTE_KW = dict(in_T=4, taylor_order=1, attn_axes="THWLYXAC", expanded_channel=16, embed_dim=64,
                patch_scale=8, n_head=4, mlp_ratio=1.0, output_length=1)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def backbones(axes, ec, dtype=torch.float32, jdtype=jnp.float32, seed=0):
    jb = JaxBackbone(tensor_shape=SHAPE, attn_axes=axes, expanded_channel=ec, n_head=4,
                     mlp_ratio=1.0, dtype=jdtype)
    x = np.random.default_rng(seed).normal(size=(1, *SHAPE)).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tb = AttnBackbone(SHAPE, axes, 4, 1.0, dtype=dtype, expanded_channel=ec)
    load_jax_params(tb, flatten(params))
    return jb, params, tb.eval(), x


@pytest.mark.parametrize("ec", [16, 32])
@pytest.mark.parametrize("axes", ["C", "TC", "THWC", "LXAC", "CTC"])
def test_backbone_with_channel_axis_matches_jax(axes, ec):
    jb, params, tb, x = backbones(axes, ec)
    want = jb.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    assert got.shape == want.shape == (1, *SHAPE)
    close(got, want)


def test_channel_lift_keys_and_widths_are_jaxs():
    """Two C blocks in one backbone: channel_lift_0 and channel_lift_1, each
    1 -> ec/4 -> ec, beside blocks of width ec; the T block keeps C."""
    jb, params, tb, _ = backbones("CTC", 32)
    flat = flatten(params)
    assert set(state_dict_from_jax(flat)) == set(tb.state_dict())
    assert flat["channel_lift_0/fc1/Dense_0/kernel"].shape == (1, 8)
    assert flat["channel_lift_1/fc2/Dense_0/kernel"].shape == (8, 32)
    assert "channel_lift_2/fc1/Dense_0/kernel" not in flat
    assert tb.block_0.wq.shape == tb.block_2.wq.shape == (32, 32)
    assert tb.block_1.wq.shape == (64, 64)
    assert tb.lift == {0: 0, 2: 1}
    assert tb.channel_lift_0.approximate == "none"  # exact GELU, as JAX's lift


def test_fusion_gates_refuse_runs_with_a_channel_or_long_axis():
    """The chain / group kernels take T/H/W runs only: a C (or L) letter
    keeps the backbone on the per-block path, where the C branch runs."""
    dims = SHAPE[:3]
    for axes in ("THWC", "C", "TC", "THWL", "LT"):
        assert not tblock.group_fusable(axes, dims, 64, 4)
        assert not tblock.chain_fusable(axes, dims, 64, 4)
    assert tblock.group_fusable("THW", dims, 64, 4)
    jb, params, tb, x = backbones("THWC", 16)
    tb.fused_chain, tb.fused_group = 3, True
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    close(got, jb.apply(params, jnp.asarray(x)))


def test_bf16_flow_matches_jax_bf16():
    """The backbone in bf16 (the lift and the blocks compute in bf16) against
    the JAX backbone in bf16, from one f32 param tree."""
    jb, params, tb, x = backbones("TC", 16, torch.bfloat16, jnp.bfloat16)
    want = np.asarray(jb.apply(params, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    delta_t, delta_j = got.float().numpy() - x, want - x
    assert np.linalg.norm(delta_t - delta_j) / np.linalg.norm(delta_j) <= BF16_REL_L2


def tante_models(deg=True, seed=3):
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, RES), deg=deg, **TANTE_KW)
    x = jnp.zeros((1, 4, *RES, F), jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), x, *(() if deg else (2.5,)))
    tm = TANTE(dset_metadata=metadata(TanteMetadata, RES), deg=deg, device="cpu", **TANTE_KW)
    load_jax_params(tm, flatten(params))
    return jm, params, tm.eval()


def frames(seed, n=4):
    return np.random.default_rng(seed).normal(size=(B, n, *RES, F)).astype(np.float32)


@pytest.mark.parametrize("deg", [True, False])
def test_tante_with_every_axis_matches_jax(deg):
    jm, params, tm = tante_models(deg)
    assert tm.blocks_0.block_7.embed_dim == 16 and tm.blocks_0.block_6.embed_dim == 64
    x = frames(4)
    args = () if deg else (2.5,)
    want = jm.apply(params, jnp.asarray(x), *args)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *args)
    if deg:
        assert got.shape == want.shape == (B, 1, *RES, F)
        close(got, want)
    else:
        close(got[0], want[0])
        close(got[1], want[1])


def test_latent_rollout_with_every_axis_matches_jax():
    jm, params, tm = tante_models()
    x = frames(5)
    want = jroll.rollout_tante_latent(jm, params, jnp.asarray(x), 3)
    with torch.no_grad():
        got = troll.rollout_tante_latent(tm, torch.from_numpy(x), 3)
    assert got.shape == want.shape == (B, 3, *RES, F)
    close(got, want)


def test_trainer_step_on_tc_matches_jax(tmp_path):
    """One Trainer step on a "TC" TANTE: the loss and the gradient norm
    (before the clip) against ``jax.value_and_grad`` of the same rollout
    loss, at 1e-4 relative (f32, two model calls)."""
    kw = dict(TANTE_KW, attn_axes="TC")
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, RES), dropout=0.0, **kw)
    params = jm.init(jax.random.PRNGKey(8), jnp.zeros((1, 4, *RES, F), jnp.float32))
    tm = TANTE(dset_metadata=metadata(TanteMetadata, RES), dropout=0.0, device="cpu", **kw)
    load_jax_params(tm, flatten(params))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, 4, *RES, F)).astype(np.float32)
    y = rng.normal(size=(B, 2, *RES, F)).astype(np.float32)

    def loss(p):
        pred = jroll.rollout_fixed(lambda w: jm.apply({"params": p}, w), jnp.asarray(x), 2, 1)
        return jnp.mean(jmetrics.MSE()(pred, jnp.asarray(y), None))

    jl, jg = jax.value_and_grad(loss)(params["params"])
    jnorm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g)))
                              for g in jax.tree_util.tree_leaves(jg))))
    dm = WaveDataModule(batch_size=B, n_steps_input=4, n_steps_output=2, device="cpu",
                        waves=dict(resolution=RES, n_trajectories=2, n_steps=12, seed=0))
    trainer = Trainer(str(tmp_path), "channels_last_default", tm, dm, AdamW(lr=1e-3),
                      tmetrics.MSE(), tmetrics.VRMSE(), max_epoch=1, n_steps_output=2,
                      device="cpu")
    tl = trainer._loss(torch.from_numpy(x), torch.from_numpy(y), 2, trainer.train_loss_fn,
                       deterministic=False)
    trainer.optimizer.zero_grad()
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-4)
    assert float(global_norm(tm.parameters())) == pytest.approx(jnorm, rel=1e-4)
    lift = tm.blocks_0.channel_lift_0.fc1.Dense_0.kernel.grad
    assert lift is not None and float(lift.abs().max()) > 0  # the lift is trained
    loss_step = trainer.train_step(torch.from_numpy(x), torch.from_numpy(y))
    assert float(loss_step) == pytest.approx(float(jl), rel=1e-4)
    assert float(trainer.last_grad_norm) == pytest.approx(jnorm, rel=1e-4)


def test_config_override_of_expanded_channel_reaches_tante():
    """``model.expanded_channel`` (not in the shipped configs: the JAX
    default 128 applies) set by an override reaches every backbone through
    the registry, as in JAX; one forward equal to JAX's on the same seeded
    weights."""
    over = ["model.embed_dim=32", "model.n_head=4", "model.attn_axes=TC",
            "model.expanded_channel=16"]
    cfg, jcfg = config.load_config("tante", overrides=over), jconfig.load_config("tante",
                                                                                 overrides=over)
    assert cfg.model.expanded_channel == jcfg.model.expanded_channel == 16
    tm = config.instantiate(cfg.model, dset_metadata=metadata(TanteMetadata, RES), device="cpu")
    jm = jconfig.instantiate(jcfg.model, dset_metadata=metadata(JaxMetadata, RES))
    assert tm.blocks_0.block_1.embed_dim == jm.expanded_channel == 16
    assert tm.blocks_0.channel_lift_0.fc2.Dense_0.kernel.shape == (4, 16)
    x = frames(6)[:1]
    params, tm = transplant(jm, tm, x, seed=3)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    close(got, want)
    default = config.instantiate(config.load_config("tante", overrides=over[:3]).model,
                                 dset_metadata=metadata(TanteMetadata, RES), device="cpu")
    assert default.blocks_0.block_1.embed_dim == 128
