"""The port's spatial-sharding primitives and AttentionUNet under sp / dp,
on spawned CPU ranks of one gloo group (``_torch_parity.spawn_ranks``, rank
bodies in ``_torch_ranks.py``), against the JAX package's under
``shard_map`` on the conftest's virtual CPU devices and against one rank
(the counterpart of ``tests/test_parallel.py``'s halo and AttentionUNet sp
tests).

- ``halo_exchange`` with periodic and zero edges, halo 1 and 2, and its
  gradient (each rank's share sent back to the neighbour that lent the rows);
- ``sharded_conv2d`` against the unsharded 'same' conv, with its gradient;
- ``sharded_rfft2`` against ``rfft2``; ``sharded_irfft2`` of it back to the
  input, and the round trip's gradient (the identity's);
- AttentionUNet on (dp 1, sp 2) and (dp 1, sp 4): eval and train-mode
  forwards and the BatchNorm statistics against the unsharded model;
- ``Trainer`` on AttentionUNet at (dp 1, sp 2) and (dp 2, sp 1) against one
  rank: every step's loss and gradient norm, the statistics (global, and
  equal on every rank), the validation loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_ranks as R
from _torch_parity import spawn_ranks
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.unet_att import AttentionUNet as JaxAttentionUNet
from tante_tpu.parallel import make_mesh
from tante_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from tante_tpu.parallel.halo import sharded_conv2d as jax_sharded_conv2d
from tante_tpu.parallel.halo import sharded_irfft2 as jax_sharded_irfft2
from tante_tpu.parallel.halo import sharded_rfft2 as jax_sharded_rfft2
from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
from tante_tpu_torch.models.unet_att import AttentionUNet

cpu = jax.devices("cpu")
HALOS = [(1, True), (1, False), (2, True), (2, False)]
X_HALO = np.random.default_rng(0).normal(size=(2, 16, 6, 3)).astype(np.float32)
X_OPS = np.random.default_rng(1).normal(size=(2, 16, 10, 4)).astype(np.float32)
KERNEL = (np.random.default_rng(2).normal(size=(3, 3, 4, 3)) * 0.2).astype(np.float32)
R_OPS = np.random.default_rng(3).normal(size=X_OPS.shape).astype(np.float32)
X_UNET = np.random.default_rng(4).normal(size=(2, 4, 32, 16, 3)).astype(np.float32)


def halo_weights(n, halo):
    h = X_HALO.shape[1] // n
    return np.random.default_rng(10 + halo).normal(
        size=(n, 2, h + 2 * halo, *X_HALO.shape[2:])).astype(np.float32)


def unet_flat(res=(32, 16), fields=3):
    model = AttentionUNet(dset_metadata=R.tante_metadata(res=res, fields=fields), device="cpu",
                          **R.UNET)
    return seeded_jax_params(model, 5)


def sp_jobs(n):
    jobs = [(f"halo{halo}_{periodic}", ("sp",), (n,), "halo_case",
             dict(x=X_HALO, r=halo_weights(n, halo), halo=halo, periodic=periodic))
            for halo, periodic in HALOS]
    jobs.append(("ops", ("sp",), (n,), "sharded_ops", dict(x=X_OPS, kernel=KERNEL, r=R_OPS)))
    jobs.append(("unet_sp", ("dp", "sp"), (1, n), "unet_sp_forward",
                 dict(flat=unet_flat(), x=X_UNET)))
    return jobs


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_ranks(4, tmp_path_factory.mktemp("halo4"), sp_jobs(4), timeout=120)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jobs = sp_jobs(2)
    flat = unet_flat(R.TRAIN_WAVES["resolution"], 3)
    for name, shape in (("train_sp2", (1, 2)), ("train_dp2", (2, 1))):
        jobs.append((name, ("dp", "sp"), shape, "unet_train_run",
                     dict(workdir=name, flat=flat)))
    return spawn_ranks(2, tmp_path_factory.mktemp("halo2"), jobs, timeout=120)


def ranks_of(world2, world4, n):
    return world2 if n == 2 else world4


# ---- halo_exchange ---------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("halo,periodic", HALOS)
def test_halo_exchange_matches_jax_with_its_gradient(world2, world4, n, halo, periodic):
    ranks = ranks_of(world2, world4, n)
    mesh = make_mesh(n, ("sp",), (n,), devices=cpu[:n])
    spec = P(None, "sp", None, None)
    want = shard_map(lambda v: jax_halo_exchange(v, halo, "sp", periodic=periodic), mesh=mesh,
                     in_specs=spec, out_specs=spec)(jnp.asarray(X_HALO))
    got = np.concatenate([r[f"halo{halo}_{periodic}"]["y"] for r in ranks], axis=1)
    np.testing.assert_array_equal(got, np.asarray(want))
    # The gradient: each padded row's weight goes back to the row it copies.
    x = torch.from_numpy(X_HALO).requires_grad_(True)
    h = X_HALO.shape[1] // n
    pad = ((x[:, -halo:], x[:, :halo]) if periodic else
           (torch.zeros_like(x[:, :halo]), torch.zeros_like(x[:, :halo])))
    full = torch.cat([pad[0], x, pad[1]], dim=1)
    r = torch.from_numpy(halo_weights(n, halo))
    sum((full[:, i * h:i * h + h + 2 * halo] * r[i]).sum() for i in range(n)).backward()
    gx = np.concatenate([rk[f"halo{halo}_{periodic}"]["gx"] for rk in ranks], axis=1)
    np.testing.assert_allclose(gx, x.grad.numpy(), atol=1e-6, rtol=1e-6)


# ---- sharded conv and FFT -----------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_conv2d_matches_jax_and_the_unsharded_conv(world2, world4, n):
    ranks = ranks_of(world2, world4, n)
    mesh = make_mesh(n, ("sp",), (n,), devices=cpu[:n])
    want = jax_sharded_conv2d(mesh, jnp.asarray(KERNEL), jnp.asarray(X_OPS), periodic=False)
    plain = jax.lax.conv_general_dilated(jnp.asarray(X_OPS), jnp.asarray(KERNEL), (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = np.concatenate([r["ops"]["conv"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(plain), atol=1e-5)
    _, vjp = jax.vjp(lambda v: jax.lax.conv_general_dilated(
        v, jnp.asarray(KERNEL), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(X_OPS))
    (gx,) = vjp(jnp.asarray(R_OPS[..., :KERNEL.shape[-1]]))
    got_gx = np.concatenate([r["ops"]["conv_gx"] for r in ranks], axis=1)
    np.testing.assert_allclose(got_gx, np.asarray(gx), atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_rfft2_round_trip_matches_jax(world2, world4, n):
    """W = 10: Wf = 6 does not split over n = 4 (zero columns pad it)."""
    ranks = ranks_of(world2, world4, n)
    mesh = make_mesh(n, ("sp",), (n,), devices=cpu[:n])
    want = jax_sharded_rfft2(mesh, jnp.asarray(X_OPS))
    got = np.concatenate([r["ops"]["spec"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got, np.fft.rfft2(X_OPS, axes=(1, 2), norm="ortho"), atol=1e-5)
    back = np.concatenate([r["ops"]["back"] for r in ranks], axis=1)
    want_back = jax_sharded_irfft2(mesh, want, X_OPS.shape[2])
    np.testing.assert_allclose(back, np.asarray(want_back), atol=1e-5)
    np.testing.assert_allclose(back, X_OPS, atol=1e-5)
    gx = np.concatenate([r["ops"]["round_trip_gx"] for r in ranks], axis=1)
    np.testing.assert_allclose(gx, R_OPS, atol=1e-5)


# ---- AttentionUNet -------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_attention_unet_sp_forward_matches_one_rank_and_jax(world2, world4, n):
    ranks = ranks_of(world2, world4, n)
    flat = unet_flat()
    model = AttentionUNet(dset_metadata=R.tante_metadata(res=(32, 16), fields=3), device="cpu",
                          **R.UNET)
    load_jax_params(model, flat)
    with torch.no_grad():
        y_eval = model(torch.from_numpy(X_UNET)).numpy()
        y_train = model(torch.from_numpy(X_UNET), deterministic=False).numpy()
    stats = {k: b.numpy() for k, b in model.named_buffers()}
    for key, want in (("y_eval", y_eval), ("y_train", y_train)):
        got = np.concatenate([r["unet_sp"][key] for r in ranks], axis=2)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=key)
    for r in ranks:  # the statistics are the whole batch's, on every rank
        for k, v in stats.items():
            np.testing.assert_allclose(r["unet_sp"]["stats"][k], v, atol=1e-6, rtol=1e-5)
    jm = JaxAttentionUNet(dset_metadata=R.tante_metadata(res=(32, 16), fields=3,
                                                         cls=JaxMetadata), **R.UNET)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(X_UNET))
    variables = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"),
        "batch_stats": variables["batch_stats"]}
    np.testing.assert_allclose(y_eval, np.asarray(jm.apply(variables, jnp.asarray(X_UNET))),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def unet_single(tmp_path_factory):
    flat = unet_flat(R.TRAIN_WAVES["resolution"], 3)
    return R.unet_train_run(None, tmp_path_factory.mktemp("unet_single"), flat)


@pytest.mark.parametrize("name", ["train_sp2", "train_dp2"])
def test_attention_unet_trainer_on_mesh_matches_one_rank(world2, unet_single, name):
    want = unet_single
    runs = [r[name] for r in world2]
    assert runs[0]["rows"] == (8 if name == "train_sp2" else 16)  # this rank's H rows
    for run in runs:
        np.testing.assert_allclose(run["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(run["norms"], want["norms"], rtol=1e-3)
        assert run["val"] == pytest.approx(want["val"], rel=1e-4)
        # Global statistics, the same on every rank.  The first step's depend
        # on the common initial weights only; the second's also on the first
        # AdamW step, which takes lr * sign(g) even where f32 rounding decides
        # the sign (tests/test_torch_zoo_train.py:kink_bound_step), so a few
        # channels move by a few 1e-5 there.
        for step, atol in ((0, 1e-5), (1, 1e-4)):
            for k, v in want["stats"][step].items():
                np.testing.assert_allclose(run["stats"][step][k], v, atol=atol, rtol=1e-4,
                                           err_msg=f"step {step}: {k}")
                np.testing.assert_array_equal(run["stats"][step][k], runs[0]["stats"][step][k])
        for k, v in run["params"].items():  # the replicas stay equal
            np.testing.assert_array_equal(v, runs[0]["params"][k])
