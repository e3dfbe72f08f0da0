"""Port parity: the rest of the model zoo (AFNO, DPOT, UNetConvNext,
AttentionUNet) and the ops under them (``ops/fourier.py``, the depthwise and
general convs of ``ops/convs.py``, flax's BatchNorm / GroupNorm in
``ops/norms.py``) against the JAX package, f32 on the CPU.

One seeded flax-keyed tree per module (``convert.seeded_jax_params``) is
loaded into the port and handed to the JAX module, after checking it against
the tree the JAX init gives (``_torch_parity.transplant``); both see the same
seeded numpy input.  Tolerance 1e-5 absolute + 1e-5 relative, 1e-4 where an
FFT lies on the path (AFNO, DPOT).  Parameter counts equal the JAX init's, at
these sizes and, shape-only (``jax.eval_shape`` and the port's meta device),
at the shipped configs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_parity import metadata, transplant
from tante_tpu import config as jconfig
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models import afno as jafno
from tante_tpu.models import dpot as jdpot
from tante_tpu.models import unet_att as junet_att
from tante_tpu.models import unet_convnext as jconvnext
from tante_tpu.ops import convs as jconvs
from tante_tpu.ops import fourier as jfourier
from tante_tpu_torch import config
from tante_tpu_torch.convert import (
    jax_variables_from_module,
    load_jax_params,
    load_jax_variables,
)
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models import AFNO, DPOT, AttentionUNet, UNetConvNext
from tante_tpu_torch.models import afno, dpot, unet_convnext
from tante_tpu_torch.ops import convs, fourier
from tante_tpu_torch.ops.norms import BatchNorm

TOL = dict(atol=1e-5, rtol=1e-5)
FFT_TOL = dict(atol=1e-4, rtol=1e-4)
T = 4


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def fwd(tmodel, x, *args, **kw):
    with torch.no_grad():
        return tmodel(torch.from_numpy(x), *args, **kw)


def n_params(tree):
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(tree))


# ---- ops/fourier.py ----------------------------------------------------------


def test_softshrink_and_block_diag_complex_matmul_match_jax():
    x = rand(0, 3, 5, 4, 6)
    close(fourier.softshrink(torch.from_numpy(x), 0.3), jfourier.softshrink(jnp.asarray(x), 0.3))
    xr, xi, wr, wi = rand(1, 2, 7, 4, 6), rand(2, 2, 7, 4, 6), rand(3, 4, 6, 5), rand(4, 4, 6, 5)
    got = fourier.block_diag_complex_matmul(*(torch.from_numpy(a) for a in (xr, xi, wr, wi)))
    want = jfourier.block_diag_complex_matmul(*(jnp.asarray(a) for a in (xr, xi, wr, wi)))
    for g, w in zip(got, want):
        assert g.shape == (2, 7, 4, 5)
        close(g, w)


# ---- AFNO --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (2, 16, 48, 32), (2, 4, 6, 8, 32)],
                         ids=["2d_square", "2d_16x48", "3d"])
def test_afno_filter_matches_jax(shape):
    x = rand(5, *shape)
    params, tm = transplant(jafno.AFNOFilter(32, 4), afno.AFNOFilter(32, 4), x, seed=1)
    close(fwd(tm, x), jafno.AFNOFilter(32, 4).apply(params, jnp.asarray(x)), FFT_TOL)


def md3(cls, res):
    return cls(dataset_name="t", n_spatial_dims=3, spatial_resolution=tuple(res),
               field_names={0: ["f"] * 4, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
               n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[8], n_fields=4)


@pytest.mark.parametrize("dims", [2, 3])
def test_afno_matches_jax(dims):
    kw = dict(hidden_dim=32, n_blocks=2, cmlp_diagonal_blocks=4)
    if dims == 2:
        res, kw = (32, 48), dict(kw, patch_size=8)
        jmd, tmd = metadata(JaxMetadata, res), metadata(TanteMetadata, res)
    else:
        res, kw = (4, 8, 12), dict(kw, patch_size=2)
        jmd, tmd = md3(JaxMetadata, res), md3(TanteMetadata, res)
    x = rand(6, 2, T, *res, 4)
    jm = jafno.AFNO(in_T=T, dset_metadata=jmd, **kw)
    params, tm = transplant(jm, AFNO(in_T=T, dset_metadata=tmd, device="cpu", **kw), x, seed=2)
    got = fwd(tm, x)
    assert got.shape == (2, 1, *res, 4)
    close(got, jm.apply(params, jnp.asarray(x)), FFT_TOL)


# ---- DPOT --------------------------------------------------------------------


DPOT_KW = dict(patch_size=8, depth=2, embed_dim=32, n_blocks=4, modes=3, out_layer_dim=8,
               n_cls=5, mlp_ratio=2.0)


@pytest.mark.parametrize("time_agg,out_t", [("exp_mlp", 2), ("mlp", 1)])
def test_dpot_matches_jax(time_agg, out_t):
    res = (32, 48)
    kw = dict(DPOT_KW, time_agg=time_agg, out_timesteps=out_t)
    x = rand(7, 2, T, *res, 4)
    jm = jdpot.DPOT(in_T=T, dset_metadata=metadata(JaxMetadata, res), **kw)
    params, tm = transplant(jm, DPOT(in_T=T, dset_metadata=metadata(TanteMetadata, res),
                                     device="cpu", **kw), x, seed=3)
    assert {"Dense_0", "Dense_1", "cls_out"} <= set(params["params"])  # the unused cls head
    got = fwd(tm, x)
    assert got.shape == (2, out_t, *res, 4)
    close(got, jm.apply(params, jnp.asarray(x)), FFT_TOL)
    with pytest.raises(ValueError, match="doesn't match"):
        fwd(tm, rand(0, 1, T, 32, 40, 4))


def test_dpot_block_mixer_on_a_truncated_corner_matches_jax():
    """A 6x10 grid at modes 4: the corner keeps 4 of 6 H and 4 of 6 W
    frequencies, and GroupNorm(8) groups 4 channels."""
    x = rand(8, 2, 6, 10, 32)
    jb = jdpot.DPOTBlock(width=32, n_blocks=4, modes=4, mlp_ratio=1.0)
    params, tm = transplant(jb, dpot.DPOTBlock(32, 4, 4, 1.0, gen=torch.Generator()), x, seed=4)
    close(fwd(tm, x), jb.apply(params, jnp.asarray(x)), FFT_TOL)


# ---- UNetConvNext and the convs ------------------------------------------------


def test_channel_l2_norm_matches_jax():
    x = rand(9, 2, 5, 6, 7)
    x[0, 0, 0] = 0.0  # the eps floor
    params, tm = transplant(jconvnext.ChannelL2Norm(), unet_convnext.ChannelL2Norm(7), x, seed=5)
    close(fwd(tm, x), jconvnext.ChannelL2Norm().apply(params, jnp.asarray(x)))


def test_convnext_block_matches_jax():
    x = rand(10, 2, 9, 13, 6)
    jb = jconvnext.ConvNextBlock(6)
    params, tm = transplant(jb, unet_convnext.ConvNextBlock(6, gen=torch.Generator()), x, seed=6)
    close(fwd(tm, x), jb.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("mode,depth,skip", [("down", 1, False), ("up", 1, False),
                                             ("up", 2, True), ("neck", 2, False)])
def test_stage_matches_jax(mode, depth, skip):
    """``down``: the 2x2 stride-2 conv padded (1, 0) on H and W; ``up``: the
    2x2 stride-2 transposed conv; ``depth`` 2: the nn.scan stacked layout."""
    c_in = 10 if skip else 6
    x = rand(11, 2, 8, 12, c_in)
    js = jconvnext.Stage(dim_in=6, dim_out=4, depth=depth, mode=mode, skip_project=skip)
    ts = unet_convnext.Stage(6, 4, depth, mode, skip_project=skip, c_in=c_in,
                             gen=torch.Generator())
    params, ts = transplant(js, ts, x, seed=7)
    if depth > 1:
        assert params["params"]["blocks"]["ConvNextBlock_0"]["dwconv"]["kernel"].shape == (
            depth, 7, 7, 1, 6)
    got = fwd(ts, x)
    want = js.apply(params, jnp.asarray(x))
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("blocks", [1, 2])
def test_unet_convnext_matches_jax(blocks):
    res = (32, 48)
    kw = dict(stages=2, blocks_per_stage=blocks, init_features=4)
    x = rand(12, 2, T, *res, 4)
    jm = jconvnext.UNetConvNext(in_T=T, dset_metadata=metadata(JaxMetadata, res), **kw)
    params, tm = transplant(jm, UNetConvNext(in_T=T, dset_metadata=metadata(TanteMetadata, res),
                                             device="cpu", **kw), x, seed=8)
    got = fwd(tm, x)
    assert got.shape == (2, 1, *res, 4)
    close(got, jm.apply(params, jnp.asarray(x)))


def test_unet_convnext_gradient_checkpointing_same_init_outputs_and_grads():
    """The remat model is the plain model: the same initial values from one
    seed, the same outputs, the same gradients (not only the same tree)."""
    md = metadata(TanteMetadata, (16, 32))
    kw = dict(in_T=T, dset_metadata=md, stages=2, blocks_per_stage=2, init_features=4,
              device="cpu", seed=3)
    plain, re = UNetConvNext(**kw), UNetConvNext(gradient_checkpointing=True, **kw)
    for (k, a), (k2, b) in zip(plain.state_dict().items(), re.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    x = torch.from_numpy(rand(13, 2, T, 16, 32, 4))
    outs = []
    for m in (plain, re):
        y = m(x)
        (y ** 2).sum().backward()
        outs.append((y.detach(), {k: p.grad for k, p in m.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for k, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], g, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("h,w,c,k", [(16, 24, 15, 7), (9, 13, 7, 5), (8, 8, 3, 3)])
def test_depthwise_conv_matches_the_grouped_conv_and_jax(h, w, c, k):
    x, kern, bias = rand(14, 2, h, w, c), rand(15, k, k, 1, c), rand(16, c)
    got = convs.depthwise_conv2d_lanes(*(torch.from_numpy(a) for a in (x, kern, bias)))
    close(got, jconvs.depthwise_conv2d_lanes(*(jnp.asarray(a) for a in (x, kern, bias))))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (1, 1), ((k // 2, (k - 1) // 2),) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c) + bias
    close(got, ref)
    jm = jconvs.DepthwiseConv2d(features=c, kernel_size=(k, k))
    params, tm = transplant(jm, convs.DepthwiseConv2d(c, (k, k), gen=torch.Generator()), x)
    close(fwd(tm, x), jm.apply(params, jnp.asarray(x)))
    with pytest.raises(ValueError, match="odd"):
        convs.depthwise_conv2d_lanes(torch.zeros(1, 4, 4, c), torch.zeros(2, 2, 1, c))
    with pytest.raises(ValueError, match="channels"):
        tm(torch.zeros(1, 4, 4, c + 1))


# ---- AttentionUNet and BatchNorm ------------------------------------------------


def unet_att_pair(depth=3, out_t=2, res=(32, 48), seed=9):
    """(JAX model, JAX variables with nontrivial batch_stats, port model)."""
    x = rand(17, 2, T, *res, 4)
    jm = junet_att.AttentionUNet(in_T=T, dset_metadata=metadata(JaxMetadata, res), depth=depth,
                                 out_T=out_t)
    tm = AttentionUNet(in_T=T, dset_metadata=metadata(TanteMetadata, res), depth=depth,
                       out_T=out_t, device="cpu")
    params, tm = transplant(jm, tm, x, seed=seed)
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(seed + 1)
    stats = {"/".join(p.key for p in path): (rng.normal(size=leaf.shape) * 0.1 + (
        1.0 if path[-1].key == "var" else 0.0)).astype(np.float32)
             for path, leaf in jax.tree_util.tree_flatten_with_path(init["batch_stats"])[0]}
    load_jax_variables(tm, {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        params["params"], sep="/").items()}, stats)
    variables = {"params": params["params"],
                 "batch_stats": traverse_util.unflatten_dict(
                     {k: jnp.asarray(v) for k, v in stats.items()}, sep="/")}
    return jm, variables, tm, x


def test_attention_unet_eval_mode_matches_jax():
    jm, variables, tm, x = unet_att_pair()
    got = fwd(tm, x)
    assert got.shape == (2, 2, 32, 48, 4)
    close(got, jm.apply(variables, jnp.asarray(x)))


def test_attention_unet_train_mode_and_batch_stats_match_jax():
    jm, variables, tm, x = unet_att_pair(depth=4, out_t=1)
    want, updates = jm.apply(variables, jnp.asarray(x), deterministic=False,
                             mutable=["batch_stats"])
    got = fwd(tm, x, deterministic=False)
    close(got, want, dict(atol=1e-4, rtol=1e-4))
    new = jax_variables_from_module(tm)["batch_stats"]
    want_stats = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        updates["batch_stats"], sep="/").items()}
    assert set(new) == set(want_stats) and len(new) == 2 * (4 * 2 + 3 * 6)
    for k, v in want_stats.items():
        close(new[k], v, dict(atol=1e-5, rtol=1e-5))
        assert not np.allclose(new[k], np.asarray(traverse_util.flatten_dict(
            variables["batch_stats"], sep="/")[k])), k  # the statistics moved


def test_batchnorm_is_flax_not_torch():
    """momentum 0.99 and the BIASED batch variance in the running statistics
    (torch.nn.BatchNorm2d: 0.1 and unbiased), epsilon 1e-5."""
    x = torch.from_numpy(rand(18, 4, 3, 5, 6))
    bn = BatchNorm(6)
    y = bn(x, train=True)
    flat = x.reshape(-1, 6)
    torch.testing.assert_close(bn.mean, 0.01 * flat.mean(0))
    torch.testing.assert_close(bn.var, 0.99 + 0.01 * flat.var(0, unbiased=False))
    torch.testing.assert_close(y, (x - flat.mean(0)) / torch.sqrt(flat.var(0, unbiased=False)
                                                                 + 1e-5), atol=1e-5, rtol=1e-5)
    before = bn.mean.clone()
    bn(x)  # running statistics: nothing moves
    assert torch.equal(bn.mean, before)


def test_attention_unet_rejects_rows_that_do_not_halve_under_sp():
    class OneRankMesh:
        def size(self, *axes):
            return 2

    tm = AttentionUNet(in_T=T, dset_metadata=metadata(TanteMetadata, (24, 32)), depth=4,
                       out_T=1, device="cpu")
    tm.sp_mesh = OneRankMesh()  # 12 local rows: 2 * 2**3 = 16 does not divide H = 24
    with pytest.raises(ValueError, match=r"sp \* 2\*\*\(depth - 1\) = 16 must divide H = 24"):
        fwd(tm, rand(19, 1, T, 12, 32, 4))


def test_load_jax_variables_round_trip_and_refusals():
    _, variables, tm, _ = unet_att_pair(depth=2, out_t=1, res=(16, 32))
    back = jax_variables_from_module(tm)
    want_stats = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["batch_stats"], sep="/").items()}
    assert set(back["batch_stats"]) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_array_equal(back["batch_stats"][k], v)
    assert not set(back["params"]) & set(back["batch_stats"])
    with pytest.raises(KeyError, match="batch_stats"):
        load_jax_variables(tm, back["params"], {"Conv1/BatchNorm_0/mean": np.zeros(64)})
    # load_jax_params leaves the statistics alone
    load_jax_params(tm, back["params"])
    for k, v in jax_variables_from_module(tm)["batch_stats"].items():
        np.testing.assert_array_equal(v, want_stats[k])


# ---- parameter counts -------------------------------------------------------


TINY = {
    "AFNO": (jafno.AFNO, AFNO, dict(hidden_dim=32, n_blocks=2, patch_size=8)),
    "DPOT": (jdpot.DPOT, DPOT, DPOT_KW),
    "UNetConvNext": (jconvnext.UNetConvNext, UNetConvNext,
                     dict(stages=2, blocks_per_stage=2, init_features=4)),
    "AttentionUNet": (junet_att.AttentionUNet, AttentionUNet, dict(depth=3, out_T=2)),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_parameter_count_matches_jax_at_tiny_size(name):
    jcls, tcls, kw = TINY[name]
    res = (32, 64)
    x = jnp.zeros((1, T, *res, 4))
    init = jax.eval_shape(lambda: jcls(in_T=T, dset_metadata=metadata(JaxMetadata, res),
                                       **kw).init(jax.random.PRNGKey(0), x))
    tm = tcls(in_T=T, dset_metadata=metadata(TanteMetadata, res), device="cpu", **kw)
    assert sum(p.numel() for p in tm.parameters()) == n_params(init["params"])
    n_stats = n_params(init.get("batch_stats", {}))
    assert sum(b.numel() for b in tm.buffers()) == n_stats


SHIPPED = ("afno", "dpot", "unet_convnext", "unet_att")


@pytest.mark.parametrize("name", SHIPPED)
def test_parameter_count_matches_jax_at_the_shipped_config(name):
    """configs/<name>.yaml's model node at the AViT lane's 256x256 grid of 8
    fields, shape-only on both sides."""
    res = (256, 256)

    def md(cls):
        return cls(dataset_name="t", n_spatial_dims=2, spatial_resolution=res,
                   field_names={0: ["f"] * 8, 1: [], 2: []},
                   boundary_condition_types=["PERIODIC"], n_files=1,
                   n_trajectories_per_file=[1], n_steps_per_trajectory=[8], n_fields=8)

    jmd, tmd = md(JaxMetadata), md(TanteMetadata)
    jm = jconfig.instantiate(jconfig.load_config(name).model, dset_metadata=jmd)
    cfg = config.load_config(name)
    with torch.device("meta"):
        tm = config.instantiate(cfg.model, dset_metadata=tmd, device="meta")
    x = jax.ShapeDtypeStruct((1, cfg.model.in_T, *res, 8), jnp.float32)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    got = sum(p.numel() for p in tm.parameters())
    assert got == n_params(init["params"])
    assert all(p.device.type == "meta" for p in tm.parameters())
    if name == "unet_att":
        assert 30e6 < got < 40e6  # about 35 M, as the JAX package's table says
