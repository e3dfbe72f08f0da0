"""Port parity: the training path (``tante_tpu_torch.train`` metrics,
schedule, optimizer, ``Trainer``; the blocks' dropout; checkpoints) against
the JAX package, f32 on the CPU, same numpy-seeded inputs and state.

Tolerances, each with its reason, stand beside the assertion that uses it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import F, flatten, metadata
from tante_tpu.data import TanteDataModule
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.data.synthetic import make_well_dataset
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train.optimizers import AdamW as JaxAdamW
from tante_tpu.train.rollout import rollout_fixed as jax_rollout_fixed
from tante_tpu.train.schedules import LinearWarmupCosineAnnealingLR as JaxSchedule
from tante_tpu.train.trainer import Trainer as JaxTrainer
from tante_tpu_torch.convert import (
    jax_params_from_state_dict, load_jax_params, load_optax_adam_state,
)
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.common import FusedTransformerBlock, dropout
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.optimizers import AdamW, global_norm
from tante_tpu_torch.train.schedules import LinearWarmupCosineAnnealingLR
from tante_tpu_torch.train.trainer import Trainer
from tante_tpu_torch.utils.checkpoint import CheckpointManager
from tante_tpu_torch.utils.logging import MetricLogger, StepTimer
from tante_tpu_torch.utils.seeding import set_seed

T_IN, RES = 4, (32, 64)
MODEL_KW = dict(in_T=T_IN, taylor_order=1, attn_axes="THW", embed_dim=64, patch_scale=8,
                n_head=4, mlp_ratio=1.0, output_length=1)
WAVES = dict(resolution=RES, n_trajectories=2, n_steps=12, with_pressure=True, seed=0)
SCHED = dict(warmup_epochs=1, max_epochs=3, lr=1e-3, warmup_start_lr=1e-4, eta_min=1e-4)

# ---- metrics --------------------------------------------------------------

METRICS = ["MSE", "NMSE", "L2RE", "NNMSE", "RMSE", "NRMSE", "VMSE", "VRMSE"]


def fields(kind):
    rng = np.random.default_rng(0)
    shape = (2, 3, 8, 12, 4)
    if kind == "random":
        return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    # Constant target: zero variance, so the eps in the normalised metrics decides.
    return rng.normal(size=shape).astype(np.float32), np.full(shape, 0.5, np.float32)


@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name, kind):
    x, y = fields(kind)
    want = np.asarray(getattr(jmetrics, name)()(jnp.asarray(x), jnp.asarray(y)))
    got = getattr(tmetrics, name)()(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    # f32 means over 96 sites in another order; the constant target divides
    # by eps = 1e-7, which scales the value, not the relative error.
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("rt_mean", [1.2, 2.0, 5.5])
def test_mse_band_penalty_matches_jax(rt_mean):
    x, y = fields("random")
    rt = np.full((2,), rt_mean, np.float32) + np.array([0.1, -0.1], np.float32)
    for kw in (dict(eps=0.5, n=2.0), dict(eps=2.5, n=3.0, band_hi=6.0)):
        want = float(jmetrics.MSE()(jnp.asarray(x), jnp.asarray(y), jnp.asarray(rt), **kw))
        got = float(tmetrics.MSE()(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(rt), **kw))
        assert got == pytest.approx(want, rel=1e-5)
    with pytest.raises(NotImplementedError):
        tmetrics.VRMSE()(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(rt))
    with pytest.raises(ValueError):
        tmetrics.NMSE.eval(torch.from_numpy(x), torch.from_numpy(y), norm_mode="max")


def test_3d_fields_and_complexity_metrics_match_jax():
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(2, 3, 4, 5, 6, 2)).astype(np.float32) for _ in range(2))
    want = np.asarray(jmetrics.VRMSE()(jnp.asarray(x), jnp.asarray(y)))
    got = tmetrics.VRMSE()(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    data = rng.normal(size=(2, 16, 4, 4, 3)).astype(np.float32)
    want = jmetrics.complexity_metrics(jnp.asarray(data))
    got = tmetrics.complexity_metrics(torch.from_numpy(data))
    np.testing.assert_allclose(got["spectral_entropy"], want["spectral_entropy"], rtol=1e-4)
    np.testing.assert_allclose(got["highfreq_ratio"], want["highfreq_ratio"], rtol=1e-4)


# ---- schedule -------------------------------------------------------------


@pytest.mark.parametrize("kw", [SCHED, dict(warmup_epochs=2, max_epochs=3, lr=5e-5),
                                dict(warmup_epochs=0, max_epochs=3, lr=1e-3, eta_min=1e-5)])
def test_schedule_matches_jax_at_every_step_of_three_epochs(kw):
    spe = 7
    want = JaxSchedule(**kw).as_step_schedule(spe)
    got = LinearWarmupCosineAnnealingLR(**kw).as_step_schedule(spe)
    for step in range(3 * spe + 1):
        # The JAX schedule computes in f32, the port in Python floats.
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), step
    assert len({got(s) for s in range(spe)}) == 1  # a staircase: constant within an epoch


# ---- dropout --------------------------------------------------------------


def test_dropout_masks_repeat_with_the_seed_and_keep_the_rate():
    x = torch.ones(200, 500)
    a = dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = dropout(x, 0.1, torch.Generator().manual_seed(3))
    c = dropout(x, 0.1, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    n = x.numel()
    dropped = int((a == 0).sum())
    assert abs(dropped - 0.1 * n) <= 3 * np.sqrt(n * 0.1 * 0.9)  # 3 sigma of a binomial
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))  # kept, rescaled


def test_block_dropout_paths():
    gen = torch.Generator().manual_seed(0)
    blk = FusedTransformerBlock(64, 4, 1.0, dropout=0.1, gen=gen)
    blk0 = FusedTransformerBlock(64, 4, 1.0, dropout=0.0, gen=gen)
    blk0.load_state_dict(blk.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 6, 64)).astype(np.float32))
    det = blk(x, causal=True)
    # deterministic=True equals dropout=0 (both take the kernel wrapper's path).
    assert torch.equal(det, blk0(x, causal=True, deterministic=False))
    a = blk(x, causal=True, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = blk(x, causal=True, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, det)
    # The dropout path is block_ref's math: with rate -> 0 it meets it.
    blk.dropout = 1e-12
    near = blk(x, causal=True, deterministic=False, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(near, det, atol=1e-5, rtol=1e-5)
    blk.dropout = 0.1
    with pytest.raises(ValueError):
        blk(x, deterministic=False)  # active dropout needs the caller's generator


# ---- optimizer steps, side by side ----------------------------------------


def small_models(dropout=0.0, seed=5):
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, RES), dropout=dropout, **MODEL_KW)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, T_IN, *RES, F), jnp.float32))
    tm = TANTE(dset_metadata=metadata(TanteMetadata, RES), dropout=dropout, device="cpu",
               **MODEL_KW)
    load_jax_params(tm, flatten(params))
    return jm, params, tm


def batch(seed, n_out=2, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, T_IN, *RES, F)).astype(np.float32),
            rng.normal(size=(b, n_out, *RES, F)).astype(np.float32))


def unflatten(flat):
    from flax import traverse_util

    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def jax_loss_fn(jm, n_steps):
    def loss(p, x, y):
        pred = jax_rollout_fixed(lambda w: jm.apply({"params": p}, w, deterministic=False,
                                                    rngs={"dropout": jax.random.PRNGKey(0)}),
                                 x, n_steps, 1)
        return jnp.mean(jmetrics.MSE()(pred, y, None))
    return loss


@pytest.mark.parametrize("n_steps_opt", [1, 3])
def test_optimizer_steps_match_optax_from_one_state(n_steps_opt, tmp_path):
    """Both packages start from the same parameters, batch and AdamW state
    (count 5, random moments) and take the same steps with dropout 0."""
    lr, wd = 1e-3, 1e-2
    jm, params, tm = small_models()
    p = params["params"]
    flat0 = flatten(params)
    rng = np.random.default_rng(9)
    mu = {k: (1e-2 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat0.items()}
    nu = {k: (1e-4 * rng.uniform(0.5, 1.5, size=v.shape)).astype(np.float32)
          for k, v in flat0.items()}
    count = 5

    tx = JaxAdamW(lr=lr, weight_decay=wd).make(grad_clip="norm")
    opt_state = jax.tree_util.tree_map(
        lambda n: n._replace(count=jnp.asarray(count, jnp.int32), mu=unflatten(mu),
                             nu=unflatten(nu)) if isinstance(n, optax.ScaleByAdamState) else n,
        tx.init(p), is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
    loss_fn = jax.jit(jax.value_and_grad(jax_loss_fn(jm, 2)))

    dm = WaveDataModule(batch_size=2, n_steps_input=T_IN, n_steps_output=2, device="cpu", waves=WAVES)
    trainer = Trainer(str(tmp_path), "channels_last_default", tm, dm,
                      AdamW(lr=lr, weight_decay=wd), tmetrics.MSE(), tmetrics.VRMSE(),
                      max_epoch=1, n_steps_output=2, device="cpu")
    load_optax_adam_state(trainer.optimizer, tm, count, mu, nu)

    for step in range(n_steps_opt):
        x, y = batch(20 + step)
        before = jax_params_from_state_dict(tm.state_dict())
        jl, jg = loss_fn(p, jnp.asarray(x), jnp.asarray(y))
        updates, opt_state = tx.update(jg, opt_state, p)
        p_new = optax.apply_updates(p, updates)

        # The port's step, with its gradients read before the clip.
        tl = trainer._loss(torch.from_numpy(x), torch.from_numpy(y), 2, trainer.train_loss_fn,
                           deterministic=False)
        trainer.optimizer.zero_grad()
        tl.backward()
        raw = {k.replace(".", "/"): q.grad.clone() for k, q in tm.named_parameters()}
        norm = float(global_norm(tm.parameters()))
        loss = trainer.train_step(torch.from_numpy(x), torch.from_numpy(y))
        after = jax_params_from_state_dict(tm.state_dict())

        # Loss and every gradient at 1e-4 relative: a rollout of two model
        # calls in f32, summed in another order.
        assert float(loss) == pytest.approx(float(jl), rel=1e-4)
        jgf = flatten({"params": jg})
        for k, g in raw.items():
            np.testing.assert_allclose(g.numpy(), jgf[k], rtol=1e-4,
                                       atol=1e-4 * np.abs(jgf[k]).max() + 1e-9, err_msg=k)
        jnorm = float(optax.global_norm(jg))
        assert norm == pytest.approx(jnorm, rel=1e-4)
        assert float(trainer.last_grad_norm) == pytest.approx(jnorm, rel=1e-4)
        # The clip scale both apply: clip / max(norm, clip).
        assert 1.0 / max(norm, 1.0) == pytest.approx(1.0 / max(jnorm, 1.0), rel=1e-4)
        # Parameter updates.  Adam divides the first moment by sqrt(v), so
        # where the gradient is near zero the rounding of g is amplified to
        # the size of the step itself; those entries are left out.
        jold, jnew = flatten({"params": p}), flatten({"params": p_new})
        held = total = 0
        for k in before:
            dp_t, dp_j = after[k] - before[k], jnew[k] - jold[k]
            mask = np.abs(jgf[k]) > 1e-6
            assert np.all(np.abs(dp_t - dp_j)[mask] <= 0.05 * lr), k
            held, total = held + int(mask.sum()), total + mask.size
            assert np.abs(dp_t).max() > 0.1 * lr, k  # the step did move this tensor
        assert held > 0.5 * total  # the rule above covers most entries
        p = p_new


# ---- the two trainers, three steps side by side -----------------------------


def test_three_steps_of_both_trainers_side_by_side(tmp_path):
    """The JAX ``Trainer`` over the HDF5 files and the port's ``Trainer`` over
    the in-memory waves of the same seed: same initial weights, same batches
    (the loaders agree), dropout 0, warmup-cosine schedule."""
    make_well_dataset(str(tmp_path / "data"), dataset_name="synthetic_waves", **WAVES)
    jdm = TanteDataModule(base_path=str(tmp_path / "data"), dataset_name="synthetic_waves",
                          batch_size=2, n_steps_input=T_IN, n_steps_output=2,
                          eval_steps_output=3, data_workers=2, seed=0)
    tdm = WaveDataModule(batch_size=2, n_steps_input=T_IN, n_steps_output=2, eval_steps_output=3,
                         data_workers=2, seed=0, device="cpu", waves=WAVES)
    md = jdm.train_dataset.metadata
    jm = JaxTANTE(dset_metadata=md, dropout=0.0, **MODEL_KW)
    common = dict(max_epoch=3, n_steps_output=2, n_steps_rollout=3, seed=0)
    jt = JaxTrainer(str(tmp_path / "jax"), "channels_last_default", jm, jdm,
                    JaxAdamW(lr=1e-3, weight_decay=1e-5), jmetrics.MSE(), jmetrics.VRMSE(),
                    lr_scheduler=JaxSchedule(**SCHED), **common)
    tm = TANTE(dset_metadata=tdm.train_dataset.metadata, dropout=0.0, device="cpu", **MODEL_KW)
    start = flatten(jt.params)
    load_jax_params(tm, start)
    tt = Trainer(str(tmp_path / "torch"), "channels_last_default", tm, tdm,
                 AdamW(lr=1e-3, weight_decay=1e-5), tmetrics.MSE(), tmetrics.VRMSE(),
                 lr_scheduler=LinearWarmupCosineAnnealingLR(**SCHED), device="cpu", **common)
    assert tt.steps_per_epoch == jt.steps_per_epoch

    val_j = jt.validation_loop(jdm.val_dataloader())
    val_t = tt.validation_loop(tdm.val_dataloader())
    assert val_t == pytest.approx(val_j, rel=1e-4)

    jl, tl = jdm.train_dataloader(), tdm.train_dataloader()
    for n, (jb, tb) in enumerate(zip(jl, tl)):
        if n == 3:
            break
        (jx,), jy = jt.formatter.process_input(jb)
        (tx_,), ty = tt.formatter.process_input(tb)
        np.testing.assert_array_equal(tx_.numpy(), np.asarray(jx))
        jt.params, jt.opt_state, jloss = jt._train_step(
            jt.params, jt.opt_state, jx, jy, jt._next_dropout_key())
        tloss = tt.train_step(tx_, ty)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-4), n
    # After three AdamW steps at lr 1e-4 (the warmup epoch): the parameters
    # moved by ~3e-4 each; they agree to a twentieth of one step.
    want = flatten(jt.params)
    got = jax_params_from_state_dict(tm.state_dict())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=0.05 * 1e-4 * 3, rtol=0, err_msg=k)
        if not k.endswith("/bk"):  # bk's gradient is zero (softmax ignores a key bias)
            assert np.abs(got[k] - start[k]).max() > 1e-4, k  # and they did move
    assert os.path.exists(tmp_path / "torch" / "saved_loss.txt")


# ---- trainer mechanics ----------------------------------------------------


def make_trainer(tmp_path, dm, model=None, **kw):
    md = dm.train_dataset.metadata
    model = model or TANTE(dset_metadata=md, device="cpu", **MODEL_KW)
    args = dict(max_epoch=2, lr_scheduler=LinearWarmupCosineAnnealingLR(**SCHED),
                n_steps_output=2, n_steps_rollout=3, device="cpu")
    args.update(kw)
    return Trainer(str(tmp_path), "channels_last_default", model, dm, AdamW(lr=1e-3),
                   tmetrics.MSE(), tmetrics.VRMSE(), **args)


@pytest.fixture()
def dm():
    return WaveDataModule(batch_size=2, n_steps_input=T_IN, n_steps_output=2, eval_steps_output=3,
                          data_workers=2, seed=0, device="cpu", waves=WAVES)


def test_trainer_trains_saves_and_resumes(tmp_path, dm):
    trainer = make_trainer(tmp_path, dm)
    trainer.train()  # 2 epochs
    for name in ("recent", "best"):
        assert os.path.isfile(tmp_path / name / "state.pt")
    losses = [float(v) for v in open(tmp_path / "saved_loss.txt").read().split()]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert trainer.best_val_loss == min(losses)
    logs = [__import__("json").loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert {"time_per_train_iter", "train_loss", "steps_per_sec_per_chip",
            "frames_per_sec_per_chip", "lr"} <= set(logs[0]) and "valid" in logs[1]
    assert trainer.global_step == 2 * trainer.steps_per_epoch

    resumed = make_trainer(tmp_path, dm, checkpoint_path=str(tmp_path / "recent"), max_epoch=3)
    assert resumed.starting_epoch == 3
    assert resumed.global_step == 2 * resumed.steps_per_epoch  # the schedule fast-forwards
    assert resumed.starting_val_loss == losses[0]  # "recent" is written before validation
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    st, rs = trainer.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert st.keys() == rs.keys() and len(st) > 0
    for i in st:
        assert float(st[i]["step"]) == float(rs[i]["step"]) == trainer.global_step
        assert torch.equal(st[i]["exp_avg_sq"], rs[i]["exp_avg_sq"])
    # Same state, same batch, same step.
    x, y = (torch.from_numpy(a) for a in batch(1))
    assert float(trainer.train_step(x, y)) == float(resumed.train_step(x, y))


def test_checkpoint_of_another_geometry_is_refused(tmp_path, dm):
    make_trainer(tmp_path, dm).save_model(1, 0.5, "recent")
    other = TANTE(dset_metadata=dm.train_dataset.metadata, device="cpu",
                  **{**MODEL_KW, "embed_dim": 128})
    with pytest.raises(ValueError, match="shape mismatches"):
        make_trainer(tmp_path, dm, other, checkpoint_path=str(tmp_path / "recent"))
    longer = TANTE(dset_metadata=dm.train_dataset.metadata, device="cpu",
                   **{**MODEL_KW, "attn_axes": "THWT"})
    with pytest.raises(ValueError, match="Missing in checkpoint"):
        make_trainer(tmp_path, dm, longer, checkpoint_path=str(tmp_path / "recent"))
    ckpt = CheckpointManager(str(tmp_path))
    sd = make_trainer(tmp_path / "b", dm).model.state_dict()
    only = ckpt.restore_params(str(tmp_path / "recent"), sd)
    assert only.keys() == sd.keys()
    meta = ckpt.restore(str(tmp_path / "recent"), {"params": sd})
    assert (meta["epoch"], meta["validation_loss"], meta["best_validation_loss"]) == (1, 0.5, None)


def test_amp_keeps_f32_master_weights_and_trains(tmp_path, dm):
    trainer = make_trainer(tmp_path, dm, enable_amp=True)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert trainer.model.blocks_0.block_0.dtype == torch.bfloat16
    x, y = (torch.from_numpy(a) for a in batch(2))
    first = float(trainer.train_step(x, y))
    for _ in range(5):
        last = float(trainer.train_step(x, y))
    assert np.isfinite(first) and last < first
    assert all(p.grad.dtype == torch.float32 for p in trainer.model.parameters())
    x3, y3 = (torch.from_numpy(a) for a in batch(2, n_out=3))
    assert np.isfinite(float(trainer.eval_step(x3, y3)))  # the 3-step validation rollout


def test_trainer_with_dropout_draws_from_its_own_generator(tmp_path, dm):
    md = dm.train_dataset.metadata
    x, y = (torch.from_numpy(a) for a in batch(3))

    def first_loss(seed, dropout):
        model = TANTE(dset_metadata=md, dropout=dropout, device="cpu", **MODEL_KW)
        return float(make_trainer(tmp_path / f"{seed}{dropout}", dm, model, seed=seed)
                     .train_step(x, y))

    assert first_loss(0, 0.1) == first_loss(0, 0.1)
    assert first_loss(0, 0.1) != first_loss(1, 0.1)
    assert first_loss(0, 0.0) == first_loss(1, 0.0)


def test_trainer_refuses_what_is_not_ported(tmp_path, dm):
    # Parallelism is ported (tests/test_torch_parallel.py): data_parallel
    # without a process group of more than one rank trains on one device, as
    # the JAX Trainer does on one device.
    assert make_trainer(tmp_path, dm, data_parallel=True).mesh is None
    # Models with BatchNorm statistics train since the zoo was ported
    # (tests/test_torch_zoo_train.py); mixed precision other than bfloat16
    # does not exist in either package.
    with pytest.raises(ValueError, match="bfloat16"):
        make_trainer(tmp_path, dm, enable_amp=True, amp_type="float16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the card is the default device
            make_trainer(tmp_path, dm, device=None)


def test_utils(tmp_path):
    g1, g2 = set_seed(7), set_seed(7)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    log = MetricLogger(str(tmp_path))
    log.log({"a": torch.tensor(1.5), "b": np.float32(2.0), "c": [torch.tensor(1)]}, step=3)
    rec = __import__("json").loads(open(tmp_path / "metrics.jsonl").read())
    assert (rec["a"], rec["b"], rec["c"], rec["_step"]) == (1.5, 2.0, [1], 3)
    timer = StepTimer()
    timer.tick(4)
    assert timer.steps_per_sec_per_chip > 0
