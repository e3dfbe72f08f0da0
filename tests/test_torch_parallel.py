"""The port's parallel layer against the JAX package's, on the CPU.

The port's side runs in spawned processes joined in one gloo group
(``_torch_parity.spawn_ranks``, rank bodies in ``_torch_ranks.py``); the JAX
side runs here on the conftest's virtual CPU devices.  Inputs come from
numpy seeds and go to both.  Two process groups serve the whole file (four
ranks, then two), each running all of its cases once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import _torch_ranks as R
import test_torch_adaptive_train as AT
from _torch_parity import block_params, flatten, spawn_ranks, to_jax, to_torch
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.fno import FNO as JaxFNO
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.ops import pallas_block as jblock
from tante_tpu.parallel import batch_sharding, make_mesh, shard_params as jax_shard_params
from tante_tpu.parallel.halo import sharded_spectral_conv2d_centered as jax_sharded_conv
from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.parallel import make_mesh as torch_make_mesh
from tante_tpu_torch.utils.checkpoint import CheckpointManager

cpu = jax.devices("cpu")

# tests/test_parallel.py:523-578: the tp block on a (dp 2, tp 2) mesh; also at
# BLONG, past the short halves' 64 (the long half on the card).
BC, BHEADS, BHIDDEN, BL, BROWS = 32, 4, 64, 8, 4
BLONG = 100
# tests/test_parallel.py:581-610: heads = 3 does not split over tp = 2.
UC, UHEADS, UHIDDEN, UL, UROWS = 24, 3, 48, 4, 6
SPEC_MODES = 8
FNO_KW = dict(in_T=2, modes1=6, modes2=6, hidden_channels=8, n_layers=2)


def block_inputs(c, hidden, rows, l, seed):
    p = block_params(c, hidden, seed)
    x = np.random.default_rng(seed + 1).normal(size=(rows, l, c)).astype(np.float32)
    return x, p


def tp_model_inputs():
    jm = JaxTANTE(dset_metadata=R.tante_metadata(cls=JaxMetadata), **R.TP_TANTE)
    x = np.random.default_rng(0).normal(size=(8, 4, *R.TP_RES, R.TP_FIELDS)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    return jm, params, x


def tp_long_model_inputs():
    jm = JaxTANTE(dset_metadata=R.tante_metadata(res=R.LONG_TP_RES, cls=JaxMetadata),
                  **R.LONG_TP_TANTE)
    x = np.random.default_rng(2).normal(size=(2, 4, *R.LONG_TP_RES, R.TP_FIELDS)).astype(
        np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    return jm, params, x


def spectral_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 24, 6)).astype(np.float32)
    w = (rng.normal(size=(6, 5, SPEC_MODES, SPEC_MODES // 2 + 1, 2)) * 0.1).astype(np.float32)
    return x, w


def fno_inputs():
    x = np.random.default_rng(1).normal(size=(2, 2, 16, 32, 3)).astype(np.float32)
    md = R.tante_metadata(res=(16, 32), fields=3)
    flat = seeded_jax_params(FNO(dset_metadata=md, layout="wc", device="cpu", **FNO_KW), 0)
    return x, md, flat


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """(dp 2, tp 2) block and model cases (also at sequences past the short
    halves' 64), sp = 4 spectral cases."""
    jobs = []
    for causal in (False, True):
        for name, l in (("block", BL), ("block_long", BLONG)):
            x, p = block_inputs(BC, BHIDDEN, BROWS, l, 0)
            jobs.append((f"{name}_causal{causal}", ("dp", "tp"), (2, 2), "block_tp",
                         dict(x=x, params=tuple(p), l=l, heads=BHEADS, causal=causal)))
    _, params, x = tp_model_inputs()
    jobs.append(("tp_model", ("dp", "tp"), (2, 2), "tp_model_forward",
                 dict(flat=flatten(params), x=x)))
    _, params, x = tp_long_model_inputs()
    jobs.append(("tp_long_model", ("dp", "tp"), (2, 2), "tp_model_forward",
                 dict(flat=flatten(params), x=x, long_axes=True)))
    xs, w = spectral_inputs()
    jobs.append(("spectral_sp4", ("sp",), (4,), "spectral_sp", dict(x=xs, w=w, modes=SPEC_MODES)))
    xf, _, flat = fno_inputs()
    jobs.append(("fno_sp4", ("sp",), (4,), "fno_sp_forward", dict(flat=flat, x=xf, kw=FNO_KW)))
    return spawn_ranks(4, tmp_path_factory.mktemp("world4"), jobs, timeout=120)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The uneven tp block, sp = 2 cases, the Trainer under dp / tp / sp,
    dropout under tp, and the shard / gather round trip."""
    x, p = block_inputs(UC, UHIDDEN, UROWS, UL, 3)
    jobs = [("uneven", ("tp",), (2,), "block_tp",
             dict(x=x, params=tuple(p), l=UL, heads=UHEADS, causal=False))]
    xs, w = spectral_inputs()
    jobs.append(("spectral_sp2", ("sp",), (2,), "spectral_sp", dict(x=xs, w=w, modes=SPEC_MODES)))
    xf, _, flat = fno_inputs()
    jobs.append(("fno_sp2", ("sp",), (2,), "fno_sp_forward", dict(flat=flat, x=xf, kw=FNO_KW)))
    for name, axes, shape, kind in (("train_dp2", ("dp",), (2,), "tante"),
                                    ("train_tp2", ("dp", "tp"), (1, 2), "tante"),
                                    ("train_sp2", ("dp", "sp"), (1, 2), "fno")):
        jobs.append((name, axes, shape, "train_run", dict(workdir=name, model_kind=kind)))
    jobs.append(("train_tp2_dropout", ("dp", "tp"), (1, 2), "train_run",
                 dict(workdir="drop", model_kind="tante", steps=1, dropout=0.1)))
    _, params, xt = tp_model_inputs()
    jobs.append(("tp_dropout", ("dp", "tp"), (1, 2), "tp_dropout_forward",
                 dict(flat=flatten(params), x=xt[:2], seed=5)))
    jobs.append(("round_trip", ("tp",), (2,), "shard_round_trip", {}))
    jobs.append(("r_train_dp2", ("dp",), (2,), "r_train_run",
                 dict(workdir="r_train", **r_train_inputs())))
    return spawn_ranks(2, tmp_path_factory.mktemp("world2"), jobs, timeout=120)


def by_coords(ranks, name):
    return {tuple(r[name]["coords"].values()): r[name] for r in ranks}


def concat_dp(ranks, name, key="y"):
    """Rows of every dp block (tp index 0), in dp order."""
    res = by_coords(ranks, name)
    return np.concatenate([res[(d, 0)][key] for d in range(2)], axis=0)


# ---- (a) the plain halves against the JAX package's -------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_half_refs_match_jax(causal):
    c, hidden, l, tp = 32, 64, 8, 2
    x, p = block_inputs(c, hidden, 5, l, 7)
    shard = {f: (a[..., : a.shape[-1] // tp] if R.SPLIT_DIM.get(f) == 1
                 else a[: a.shape[0] // tp] if f in R.SPLIT_DIM else a)
             for f, a in zip(jblock.BlockParams._fields, p)}
    heads = 4 // tp
    ja = jblock.AttnHalfParams(*(jnp.asarray(shard[f]) for f in jblock.AttnHalfParams._fields))
    jm = jblock.MlpHalfParams(*(jnp.asarray(shard[f]) for f in jblock.MlpHalfParams._fields))
    ta = tblock.AttnHalfParams(*(torch.from_numpy(np.array(shard[f]))
                                 for f in tblock.AttnHalfParams._fields))
    tm = tblock.MlpHalfParams(*(torch.from_numpy(np.array(shard[f]))
                                for f in tblock.MlpHalfParams._fields))
    want = np.asarray(jblock._xla_attn_half(jnp.asarray(x), ja, l, heads, causal))
    got = tblock.attn_half_ref(torch.from_numpy(x), ta, l, heads, causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    want = np.asarray(jblock._xla_mlp_half(jnp.asarray(x), jm))
    got = tblock.mlp_half_ref(torch.from_numpy(x), tm).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_half_refs_recombine_into_block():
    """Summed over the shards, plus bias and residual, the halves are the
    unsplit block (f32)."""
    c, hidden, l, tp, heads = 32, 64, 8, 2, 4
    x, p = block_inputs(c, hidden, 5, l, 8)
    full, xt = to_torch(p), torch.from_numpy(x)

    def shard(r):
        out = {}
        for f, t in zip(tblock.BlockParams._fields, full):
            if f in R.SPLIT_DIM:
                n = t.shape[R.SPLIT_DIM[f]] // tp
                t = t.narrow(R.SPLIT_DIM[f], r * n, n)
            out[f] = t
        return out

    shards = [shard(r) for r in range(tp)]
    attn = sum(tblock.attn_half_ref(xt, tblock.AttnHalfParams(
        *(s[f] for f in tblock.AttnHalfParams._fields)), l, heads // tp, True) for s in shards)
    xm = xt + attn + full.bo
    mlp = sum(tblock.mlp_half_ref(xm, tblock.MlpHalfParams(
        *(s[f] for f in tblock.MlpHalfParams._fields))) for s in shards)
    want = tblock.block_ref(xt, full, l, heads, True)
    np.testing.assert_allclose((xm + mlp + full.b2).numpy(), want.numpy(), atol=1e-5)
    assert tblock.tp_fusable(c, heads, hidden, tp)


# ---- (b) the tp block on (dp 2, tp 2) -------------------------------------------


def check_block_tp(world4, name, l, causal):
    """The ranks' tp block, its input and parameter gradients, against JAX's
    ``fused_block_apply_tp`` on (dp 2, tp 2)."""
    x, p = block_inputs(BC, BHIDDEN, BROWS, l, 0)
    mesh = make_mesh(4, ("dp", "tp"), (2, 2), devices=cpu[:4])
    jp = to_jax(p)

    def loss(a, q):
        return jnp.sum(jblock.fused_block_apply_tp(a, q, l, BHEADS, causal, mesh) ** 2)

    want = jax.jit(lambda a, q: jblock.fused_block_apply_tp(a, q, l, BHEADS, causal, mesh))(
        jnp.asarray(x), jp)
    gx_want, gp_want = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jp)
    np.testing.assert_allclose(concat_dp(world4, name), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(concat_dp(world4, name, "gx"), np.asarray(gx_want),
                               rtol=1e-3, atol=2e-4)
    res = by_coords(world4, name)
    for i, f in enumerate(jblock.BlockParams._fields):
        # A shard's gradient sums over the dp blocks; shards join along their split.
        per_tp = [sum(res[(d, t)]["gp"][i] for d in range(2)) for t in range(2)]
        got = (np.concatenate(per_tp, axis=R.SPLIT_DIM[f]) if f in R.SPLIT_DIM else per_tp[0])
        if f not in R.SPLIT_DIM:
            np.testing.assert_array_equal(per_tp[0], per_tp[1])  # replicas agree
        np.testing.assert_allclose(got, np.asarray(gp_want[i]), rtol=1e-3, atol=2e-4,
                                   err_msg=f)


@pytest.mark.parametrize("causal", [False, True])
def test_block_tp_matches_jax(world4, causal):
    check_block_tp(world4, f"block_causal{causal}", BL, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_block_tp_long_sequences_match_jax(world4, causal):
    """L = 100: on the card the attention half's long kernels; here the plain
    half, whose attention runs over chunks of sequences."""
    check_block_tp(world4, f"block_long_causal{causal}", BLONG, causal)


# ---- (c) heads = 3 does not split over tp = 2 --------------------------------------


def test_block_tp_uneven_geometry_runs_unsplit(world2):
    x, p = block_inputs(UC, UHIDDEN, UROWS, UL, 3)
    mesh = make_mesh(2, ("tp",), (2,), devices=cpu[:2])
    want = jax.jit(lambda a, q: jblock.fused_block_apply_tp(a, q, UL, UHEADS, False, mesh))(
        jnp.asarray(x), to_jax(p))
    for r in world2:  # every tp rank computes the whole block
        np.testing.assert_allclose(r["uneven"]["y"], np.asarray(want), atol=2e-5)
    assert not tblock.tp_fusable(UC, UHEADS, UHIDDEN, 2)
    assert world2[0]["round_trip"]["odd_split"] == []  # shard_params left it whole


# ---- (d) a small TANTE with tp_mesh ---------------------------------------------


def test_tp_model_forward_matches_jax(world4):
    """The port on (dp 2, tp 2) against the JAX tp_mesh forward on (dp 4, tp 2)
    (tests/test_parallel.py:613-672)."""
    _, params, x = tp_model_inputs()
    mesh = make_mesh(8, ("dp", "tp"), (4, 2), devices=cpu[:8])
    tp_model = JaxTANTE(dset_metadata=R.tante_metadata(cls=JaxMetadata), tp_mesh=mesh,
                        **R.TP_TANTE)
    with mesh:
        p_sh = jax_shard_params(params, mesh, enable_tp=True)
        x_sh = jax.device_put(jnp.asarray(x), batch_sharding(mesh))
        want = jax.jit(lambda q, v: tp_model.apply(q, v))(p_sh, x_sh)
    np.testing.assert_allclose(concat_dp(world4, "tp_model"), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    split = world4[0]["tp_model"]["split"]
    assert len(split) == 3 * 10  # ten tensors of each of the three blocks


def test_tp_long_axes_model_forward_matches_jax(world4):
    """A TANTE with long axes (``THWLC``: the L block over 80 latent tokens,
    the channel block over 128 channels) on (dp 2, tp 2) against the JAX
    tp_mesh forward on the same mesh: the model's path at L > 64 under tp
    (``models/common.py`` sends every split block to
    ``fused_block_apply_tp``), no branch of its own."""
    _, params, x = tp_long_model_inputs()
    mesh = make_mesh(4, ("dp", "tp"), (2, 2), devices=cpu[:4])
    tp_model = JaxTANTE(dset_metadata=R.tante_metadata(res=R.LONG_TP_RES, cls=JaxMetadata),
                        tp_mesh=mesh, **R.LONG_TP_TANTE)
    with mesh:
        p_sh = jax_shard_params(params, mesh, enable_tp=True)
        x_sh = jax.device_put(jnp.asarray(x), batch_sharding(mesh))
        want = jax.jit(lambda q, v: tp_model.apply(q, v))(p_sh, x_sh)
    np.testing.assert_allclose(concat_dp(world4, "tp_long_model"), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    split = world4[0]["tp_long_model"]["split"]
    assert len(split) == 5 * 10  # every block split, the channel block's too


# ---- (e) H-sharded spectral convolution and FNO --------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_spectral_conv_matches_jax(world2, world4, n):
    ranks = world2 if n == 2 else world4
    x, w = spectral_inputs()
    mesh = make_mesh(n, ("sp",), (n,), devices=cpu[:n])
    want = jax.jit(lambda a, b: jax_sharded_conv(mesh, a, b, SPEC_MODES, SPEC_MODES))(
        jnp.asarray(x), jnp.asarray(w))
    got = np.concatenate([r[f"spectral_sp{n}"]["y"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_fno_sp_forward_matches_jax(world2, world4, n):
    ranks = world2 if n == 2 else world4
    x, md, flat = fno_inputs()
    mesh = make_mesh(n, ("sp",), (n,), devices=cpu[:n])
    jm = JaxFNO(dset_metadata=R.tante_metadata(res=(16, 32), fields=3, cls=JaxMetadata),
                sp_mesh=mesh, **FNO_KW)
    params = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    want = jax.jit(lambda q, v: jm.apply(q, v))(params, jnp.asarray(x))
    got = np.concatenate([r[f"fno_sp{n}"]["y"] for r in ranks], axis=2)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)


# ---- (f) Trainer under dp / tp / sp against the single-device Trainer ------------


@pytest.fixture(scope="module")
def single_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("single")
    return {kind: R.train_run(None, root / kind, kind) for kind in ("tante", "fno")}


@pytest.mark.parametrize("name,kind", [("train_dp2", "tante"), ("train_tp2", "tante"),
                                       ("train_sp2", "fno")])
def test_trainer_on_mesh_matches_single_device(world2, single_runs, name, kind):
    want = single_runs[kind]
    for r in world2:  # every rank reports the global batch's loss
        np.testing.assert_allclose(r[name]["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(r[name]["norms"], want["norms"], rtol=1e-4)
    if name == "train_tp2":
        assert world2[0][name]["split"]  # the blocks really ran split
    assert all(r[name]["resume_equal"] for r in world2)  # resume re-splits the checkpoint


def r_train_inputs():
    """The variable-frame R_Trainer case of ``test_torch_adaptive_train``: the
    two samples emit different counts and the band penalty is active, so a
    rank that took the r_t mean over its own sample would differ."""
    jm, params = AT.jax_model_and_params()
    x, y = AT.step_batch(0)
    rkw = AT.RKW["vf_growth"]
    return dict(flat=flatten(AT.rt_head(params, x, rkw["train_out_T"])), x=x, y=y,
                model_kw=AT.KW, rkw=rkw)


def test_r_trainer_on_dp2_matches_single_device(world2, tmp_path):
    """R_Trainer at dp 2 (one sample a rank): every step's loss and r_t
    statistics over the global batch, and the weights after two steps, as
    on one device."""
    inputs = r_train_inputs()
    want = R.r_train_run(None, tmp_path, **inputs)
    assert want["stats"][0][1] > 2.5  # the r_t mean is the global batch's (2.5 and 3.5)
    for r in world2:
        got = r["r_train_dp2"]
        # f32 over half batches, summed over ranks: 1e-5 (loss, rt, rt_var, calls).
        np.testing.assert_allclose(got["stats"], want["stats"], rtol=1e-5, atol=1e-7)
        for k, v in want["params"].items():
            # Two AdamW steps of lr 1e-3: a twentieth of a step's size.
            np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=5e-5, err_msg=k)


def test_r_trainer_validation_on_dp2_matches_single_device(world2, tmp_path):
    """R_Trainer's validation step at dp 2: the two samples emit different
    counts, and every rank rolls out by the global batch's first sample (dp
    rank 0's), as JAX's GSPMD rollout does, and logs the global mean r_t."""
    want = R.r_train_run(None, tmp_path, **r_train_inputs())["val"]
    assert np.floor(want["first_rt"][0]) != np.floor(want["first_rt"][1])
    for r in world2:
        got = r["r_train_dp2"]["val"]
        assert got["n_calls"] == want["n_calls"]
        # f32 over half batches, summed over ranks: 1e-5 (as the train steps).
        np.testing.assert_allclose(got["rt_log"], want["rt_log"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-7)


# ---- (g) shard / gather, checkpoints, dropout under tp -------------------------


def test_shard_gather_round_trip(world2):
    res = world2[0]["round_trip"]
    assert res["keys"] and res["equal"]
    assert res["wrong_size_refused"]
    # dp_tp_mesh's default tp of 2 on two ranks, and tp = 1; replicated keeps all
    assert [tuple(s) for s in res["dp_tp_mesh"]] == [(1, 2), (2, 1)]
    assert res["replicated"] == [0, 1, 2, 3]


def test_tp_checkpoint_loads_on_one_device(world2):
    """Rank 0 saved gathered full tensors: they load into a single-device
    model, equal to what the tp ranks held; every rank's gathered copy agrees."""
    res = world2[0]["train_tp2"]
    model = TANTE(dset_metadata=R.tante_metadata(), device="cpu", **R.TP_TANTE)
    restored = CheckpointManager(str(res["ckpt"]).rsplit("/", 1)[0]).restore(
        res["ckpt"], {"params": model.state_dict()})
    model.load_state_dict(restored["params"])
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), res["params"][k], err_msg=k)
        np.testing.assert_array_equal(world2[1]["train_tp2"]["params"][k], res["params"][k])
    moments = restored["opt_state"]["state"]
    assert all(s["exp_avg"].shape == p.shape
               for s, p in zip(moments.values(), model.parameters()))


def test_tp_dropout_step_keeps_replicas_equal(world2):
    a, b = (r["train_tp2_dropout"] for r in world2)
    for k, v in a["local"].items():
        if k not in a["split"]:
            np.testing.assert_array_equal(v, b["local"][k], err_msg=k)


def test_tp_dropout_forward_matches_unsplit(world2):
    """Same generator state: the split dropout path draws the unsplit
    block's masks, so it computes the single-device dropout forward."""
    _, params, x = tp_model_inputs()
    model = TANTE(dset_metadata=R.tante_metadata(), dropout=0.1, device="cpu", **R.TP_TANTE)
    load_jax_params(model, flatten(params))
    want = model.train()(torch.from_numpy(x[:2]), deterministic=False,
                         generator=torch.Generator().manual_seed(5)).detach().numpy()
    for r in world2:
        np.testing.assert_allclose(r["tp_dropout"]["y"], want, atol=2e-5, rtol=1e-5)


def test_loader_takes_this_ranks_slice_of_the_global_batch():
    """Every rank draws the same global batch and keeps its dp block of it and,
    for H-sharded models, its sp block of H rows; a batch that does not split
    over dp raises."""
    from tante_tpu_torch.data.datamodule import WaveDataModule
    from tante_tpu_torch.parallel.mesh import BatchSlice

    dm = WaveDataModule(batch_size=4, n_steps_input=2, n_steps_output=1, data_workers=1,
                        device="cpu", waves=R.TRAIN_WAVES)
    full = [b["input"] for b in dm.train_dataloader()]
    dm.sharding = BatchSlice(dp=2, dp_index=1, sp=2, sp_index=1)
    local = [b["input"] for b in dm.train_dataloader()]
    assert len(local) == len(full)
    for a, b in zip(full, local):
        torch.testing.assert_close(b, a[2:4, :, 8:16], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not split"):
        BatchSlice(dp=3).local_batch(np.arange(4))


class _TwoTP:
    """A mesh with tp = 2 as far as ``param_shardings`` looks."""

    def size(self, *axes):
        return 2 if "tp" in axes else 1


def test_param_shardings_on_a_state_dict_match_jax():
    """The key rules on a flat tree: the JAX package's specs for a
    MultiheadAttention, a TransformerBlock and the small TANTE."""
    from tante_tpu.models.common import TransformerBlock
    from tante_tpu.ops.attention import MultiheadAttention
    from tante_tpu.parallel import param_shardings as jax_param_shardings
    from tante_tpu_torch.parallel import param_shardings

    mesh = make_mesh(8, ("dp", "tp"), (4, 2), devices=cpu[:8])
    trees = [MultiheadAttention(embed_dim=32, num_heads=4).init(
                 jax.random.PRNGKey(0), jnp.ones((2, 6, 32))),
             TransformerBlock(embed_dim=32, n_head=4, dropout=0.0).init(
                 jax.random.PRNGKey(0), jnp.ones((2, 6, 32))),
             tp_model_inputs()[1]]
    for tree in trees:
        specs = {"/".join(str(getattr(k, "key", k)) for k in path): sh.spec for path, sh in
                 jax.tree_util.tree_flatten_with_path(jax_param_shardings(tree, mesh))[0]}
        state = {k.removeprefix("params/").replace("/", "."): torch.zeros(v.shape)
                 for k, v in traverse_util.flatten_dict(tree, sep="/").items()}
        got = param_shardings(state, _TwoTP())
        for key, spec in specs.items():
            want = list(spec).index("tp") if "tp" in tuple(spec) else None
            assert got[key.removeprefix("params/").replace("/", ".")] == want, key
        assert any(v is not None for v in got.values())


def test_make_mesh_refuses_without_group_and_wrong_size():
    with pytest.raises(RuntimeError, match="process group"):
        torch_make_mesh(2, ("dp", "tp"), (1, 2), device="cpu")
