"""Port parity: training, evaluation and the CLI on the rest of the zoo
(AFNO, DPOT, UNetConvNext, AttentionUNet), f32 on the CPU, and the port's
``utils/profiling.py``.

One train step of the port's ``Trainer`` beside the JAX ``Trainer`` from the
same weights on the same batch (the JAX one over the HDF5 files, the port's
over the in-memory waves of the same seed): the loss within 1e-5 relative,
every parameter after one AdamW step at lr 1e-3 within a twentieth of the
step, AttentionUNet's ``batch_stats`` within 1e-5.  ``rollout_fixed_stateful``
against JAX's, the ``Evaler`` report against the JAX ``Evaler``, and
``cli.train`` / ``cli.eval`` / ``Predictor.from_experiment`` on each shipped
config at tiny overrides."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_parity import flatten, metadata
from tante_tpu.data import TanteDataModule as JaxDataModule
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.data.synthetic import make_well_dataset
from tante_tpu.models import AFNO as JaxAFNO
from tante_tpu.models import DPOT as JaxDPOT
from tante_tpu.models import AttentionUNet as JaxAttentionUNet
from tante_tpu.models import UNetConvNext as JaxUNetConvNext
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train.evaler import Evaler as JaxEvaler
from tante_tpu.train.optimizers import AdamW as JaxAdamW
from tante_tpu.train.rollout import rollout_fixed_stateful as jax_rollout_fixed_stateful
from tante_tpu.train.trainer import Trainer as JaxTrainer
from tante_tpu_torch.cli import eval as cli_eval
from tante_tpu_torch.cli import train as cli_train
from tante_tpu_torch.config import instantiate, load_config
from tante_tpu_torch.convert import jax_variables_from_module, load_jax_variables
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models import AFNO, DPOT, AttentionUNet, UNetConvNext
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.evaler import Evaler
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.rollout import rollout_fixed_stateful
from tante_tpu_torch.train.trainer import Trainer
from tante_tpu_torch.utils import profiling

T = 4
WAVES = dict(resolution=(16, 24), n_trajectories=2, n_steps=10, with_pressure=True, seed=0)
MODELS = {
    "AFNO": (JaxAFNO, AFNO, dict(hidden_dim=32, n_blocks=2, patch_size=8)),
    "DPOT": (JaxDPOT, DPOT, dict(patch_size=8, depth=1, embed_dim=32, n_blocks=4, modes=2,
                                 out_layer_dim=8, n_cls=5)),
    "UNetConvNext": (JaxUNetConvNext, UNetConvNext,
                     dict(stages=2, blocks_per_stage=2, init_features=4)),
    "AttentionUNet": (JaxAttentionUNet, AttentionUNet, dict(depth=3, out_T=1)),
}
NAMES = ["MSE", "L2RE", "NNMSE", "VRMSE"]
# AdamW's decoupled decay, lr * wd * p, large enough to show in f32 on the
# parameters the loss does not reach (DPOT's cls head).
WD = 0.1


@pytest.fixture(scope="module")
def well(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_well")
    make_well_dataset(str(root), dataset_name="synthetic_waves", **WAVES)
    return str(root)


def data_modules(well):
    common = dict(batch_size=2, n_steps_input=T, n_steps_output=2, eval_steps_output=3,
                  data_workers=2, seed=0)
    return (JaxDataModule(base_path=well, dataset_name="synthetic_waves", **common),
            WaveDataModule(device="cpu", waves=WAVES, **common))


def flat_stats(variables):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables.get("batch_stats", {}), sep="/").items()}


def adam_first_moments(opt_state):
    """optax's ScaleByAdamState.mu, flax-keyed: (1 - b1) * the clipped gradient."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(leaf, "mu"):
            return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
                leaf.mu, sep="/").items()}
    raise AssertionError("no Adam state in the optax state")


def kink_bound_step(jt, tr, tm, start, want, got):
    """AttentionUNet's first AdamW step, held where f32 can decide it.

    A first Adam step is lr * sign(g) wherever |g| >> eps.  In this model a
    ReLU whose input lies within f32 rounding of 0 (a few of the ~1e5
    pre-activations of a step do) takes another branch in each package, and
    train-mode BatchNorm's backward spreads that one element's gradient over
    every position of its channel: every upstream gradient moves by up to a
    few percent (``tante_tpu_torch/tools/zoo_conditioning.py`` measures it
    against float64).  So: every
    tensor's gradient (the optimizers' first moments / (1 - b1)) within 5%
    relative L2 of JAX's; the step within a twentieth of lr wherever |g|
    exceeds twice the tensor's largest gradient error (the signs agree
    there), which must be at least half of all elements; and everywhere
    within Adam's step bound (lr, plus the decay) in both packages."""
    mu_j = adam_first_moments(jt.opt_state)
    params = dict(tm.named_parameters())
    held = total = 0
    for k, w in want.items():
        gj = mu_j[k] / 0.1
        gt = tr.optimizer.state[params[k.replace("/", ".")]]["exp_avg"].numpy() / 0.1
        for a in (got[k], w):  # Adam's bound, lr, plus the decay lr * wd * |p|
            assert (np.abs(a - start[k]) <= 1e-3 * (1.001 + WD * np.abs(start[k]))).all(), k
        scale = np.linalg.norm(gj)
        if scale <= 1e-6:
            # The bias of a conv that train-mode BatchNorm follows: its true
            # gradient is 0 (the batch mean removes it), both return noise.
            assert k.rsplit("/", 2)[-2] != "Conv" and np.linalg.norm(gt) <= 1e-6, k
            continue
        assert np.linalg.norm(gt - gj) <= 5e-2 * scale, k
        # Where |g| exceeds twice the largest gradient error the signs agree.
        sure = np.abs(gj) > 2 * np.abs(gt - gj).max()
        held += int(sure.sum())
        total += sure.size
        np.testing.assert_allclose(got[k][sure], w[sure], atol=0.05 * 1e-3, rtol=0, err_msg=k)
    assert held >= 0.5 * total, (held, total)  # most of the step is held elementwise


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_of_both_trainers(name, well, tmp_path):
    jcls, tcls, kw = MODELS[name]
    jdm, tdm = data_modules(well)
    common = dict(max_epoch=2, n_steps_output=2, n_steps_rollout=3, seed=0)
    jt = JaxTrainer(str(tmp_path / "jax"), "channels_last_default",
                    jcls(in_T=T, dset_metadata=jdm.train_dataset.metadata, **kw), jdm,
                    JaxAdamW(lr=1e-3, weight_decay=WD), jmetrics.MSE(), jmetrics.VRMSE(),
                    **common)
    tm = tcls(in_T=T, dset_metadata=tdm.train_dataset.metadata, device="cpu", **kw)
    start = flatten(jt.params)
    load_jax_variables(tm, start, flat_stats(jt.params) or None)
    tr = Trainer(str(tmp_path / "torch"), "channels_last_default", tm, tdm,
                 AdamW(lr=1e-3, weight_decay=WD), tmetrics.MSE(), tmetrics.VRMSE(),
                 device="cpu", **common)
    # Validation first: AttentionUNet on its running statistics (not moved by it).
    val_j = jt.validation_loop(jdm.val_dataloader())
    assert tr.validation_loop(tdm.val_dataloader()) == pytest.approx(val_j, rel=1e-5)
    jb, tb = next(iter(jdm.train_dataloader())), next(iter(tdm.train_dataloader()))
    (jx,), jy = jt.formatter.process_input(jb)
    (tx,), ty = tr.formatter.process_input(tb)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jt.params, jt.opt_state, jloss = jt._train_step(
        jt.params, jt.opt_state, jx, jy, jt._next_dropout_key())
    tloss = tr.train_step(tx, ty)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    want, got = flatten(jt.params), jax_variables_from_module(tm)
    if name == "AttentionUNet":
        kink_bound_step(jt, tr, tm, start, want, got["params"])
    else:
        for k in want:  # one AdamW step at 1e-3, held to a twentieth of it
            np.testing.assert_allclose(got["params"][k], want[k], atol=0.05 * 1e-3, rtol=0,
                                       err_msg=k)
    if name == "DPOT":
        # The unused cls head: no gradient in either package, and AdamW's
        # decay alone moves it (optax updates every leaf; the port gives such
        # parameters a zero gradient).
        for k in want:
            if k.split("/")[0] in ("Dense_0", "Dense_1", "cls_out"):
                np.testing.assert_allclose(got["params"][k] - start[k], want[k] - start[k],
                                           rtol=1e-2, atol=1e-12, err_msg=k)
                if k.endswith("kernel"):  # the biases start at 0 and stay there
                    assert np.abs(got["params"][k] - start[k]).max() > 0, k
    stats = flat_stats(jt.params)
    assert set(got["batch_stats"]) == set(stats)
    for k, v in stats.items():  # two model calls moved them twice
        np.testing.assert_allclose(got["batch_stats"][k], v, atol=1e-5, rtol=1e-5, err_msg=k)
        assert np.abs(v - flat_stats(jax.tree.map(np.zeros_like, jt.params))[k]).max() > 0


def test_rollout_fixed_stateful_matches_jax():
    """Three calls in train mode: the frames and the statistics after them."""
    jcls, tcls, kw = MODELS["AttentionUNet"]
    x = np.random.default_rng(0).normal(size=(2, T, 16, 24, 4)).astype(np.float32)
    jm = jcls(in_T=T, dset_metadata=metadata(JaxMetadata, (16, 24)), **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tcls(in_T=T, dset_metadata=metadata(TanteMetadata, (16, 24)), device="cpu", **kw)
    load_jax_variables(tm, flatten(variables), flat_stats(variables))

    def apply_fn(w, st):
        out, new = jm.apply({"params": variables["params"], **st}, w, deterministic=False,
                            mutable=["batch_stats"])
        return out, dict(new)

    want, want_state = jax_rollout_fixed_stateful(
        apply_fn, jnp.asarray(x), 3, 1, {"batch_stats": variables["batch_stats"]})
    with torch.no_grad():
        got, state = rollout_fixed_stateful(lambda w: tm(w, deterministic=False),
                                            torch.from_numpy(x), 3, 1, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    want_flat = flat_stats(want_state)
    assert {k.replace(".", "/") for k in state} == set(want_flat)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), want_flat[k.replace(".", "/")], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_evaler_report_matches_jax(name, well, tmp_path):
    jcls, tcls, kw = MODELS[name]
    jdm, tdm = data_modules(well)
    jev = JaxEvaler(str(tmp_path / "jax"), "channels_last_default",
                    jcls(in_T=T, dset_metadata=jdm.train_dataset.metadata, **kw), jdm,
                    *(getattr(jmetrics, n)() for n in NAMES), n_steps_rollout=3)
    tm = tcls(in_T=T, dset_metadata=tdm.train_dataset.metadata, device="cpu", **kw)
    load_jax_variables(tm, flatten(jev.params), flat_stats(jev.params) or None)
    tev = Evaler(str(tmp_path / "torch"), "channels_last_default", tm, tdm,
                 *(getattr(tmetrics, n)() for n in NAMES), n_steps_rollout=3, device="cpu")
    want, got = jev.Eval(), tev.Eval()
    eps = float(np.finfo(np.float32).eps)
    for k in NAMES:
        mean, var = want["metrics"][k], want["variance"][k]
        assert got["metrics"][k] == pytest.approx(mean, rel=1e-4), k
        # tests/test_torch_evaler.py's slack: the variance of nearly equal
        # batch means amplifies their f32 rounding (a few eps of the mean),
        # down to a variance of 0 (a fresh DPOT scores both batches alike).
        slack = 2 * var**0.5 * 4 * eps * mean + (4 * eps * mean) ** 2
        assert got["variance"][k] == pytest.approx(var, rel=1e-4, abs=slack), k


# ---- the CLI on each shipped config --------------------------------------------

SHRINK = {
    "afno": ["model.hidden_dim=32", "model.n_blocks=2"],
    "dpot": ["model.embed_dim=32", "model.depth=1", "model.patch_size=8", "model.modes=2"],
    "unet_convnext": ["model.init_features=4", "model.blocks_per_stage=2", "model.stages=2"],
    "unet_att": ["model.depth=2"],
}


def cli_overrides(name, well, root, epochs=1):
    return [f"data.base_path={well}", "data.dataset_name=synthetic_waves", "data.batch_size=2",
            "data.n_steps_output=2", "data.eval_steps_output=4", "data.data_workers=2",
            f"trainer.max_epoch={epochs}", "trainer.n_steps_output=2",
            "trainer.n_steps_rollout=4", "evaler.n_steps_rollout=4", f"root_path={root}",
            f"experiment={name}", *SHRINK[name]]


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_cli_train_eval_and_from_experiment(name, well_root_tiny, tmp_path, capsys):
    ov = cli_overrides(name, well_root_tiny, str(tmp_path))
    trainer = cli_train.main([f"--config-name={name}", "--device", "cpu", *ov])
    folder = tmp_path / "experiments" / name
    for path in ("metrics.jsonl", "recent/state.pt", "best/state.pt", "saved_loss.txt"):
        assert (folder / path).exists(), path
    assert type(trainer.model).__name__ == {"afno": "AFNO", "dpot": "DPOT",
                                            "unet_convnext": "UNetConvNext",
                                            "unet_att": "AttentionUNet"}[name]
    losses = [json.loads(line)["train_loss"] for line in (folder / "metrics.jsonl").read_text()
              .splitlines() if "train_loss" in line]
    assert len(losses) == 1 and np.isfinite(losses[0])
    # Resume: one more epoch from recent/, buffers included.
    second = cli_train.main([f"--config-name={name}", "--device", "cpu",
                             *cli_overrides(name, well_root_tiny, str(tmp_path), epochs=2)])
    assert second.starting_epoch == 2
    report = cli_eval.main([f"--config-name={name}", "--choose=best", "--device", "cpu", *ov])
    assert str(report["metrics"]) in capsys.readouterr().out
    cfg = load_config(name, overrides=ov)
    cfg.data.eval_steps_output = cfg.evaler.n_steps_rollout
    dm = instantiate(cfg.data, seed=cfg.seed, device="cpu")
    model = instantiate(cfg.model, dset_metadata=dm.train_dataset.metadata, seed=cfg.seed,
                        device="cpu")
    evaler = instantiate(cfg.evaler, checkpoint_folder=str(folder), model=model, datamodule=dm,
                         batch_size=cfg.data.batch_size, device="cpu",
                         checkpoint_path=str(folder / "best"))
    want = evaler.Eval(mode="common")
    assert report["metrics"] == want["metrics"] and report["variance"] == want["variance"]
    pred = Predictor.from_experiment(name, experiment=name, root_path=str(tmp_path),
                                     choose="best", overrides=ov, device="cpu")
    state = torch.load(folder / "best" / "state.pt", weights_only=True)["params"]
    own = pred.model.state_dict()
    assert set(own) == set(state)
    for k, v in state.items():  # AttentionUNet: the BatchNorm statistics too
        assert torch.equal(own[k], v), k
    if name == "unet_att":
        assert any(k.endswith(".var") for k in state)
        assert not torch.equal(state["Conv1.BatchNorm_0.var"], torch.ones(64))
    y = pred.rollout(dm.test_dataset[0]["input"][None], 3)
    assert y.shape == (1, 3, 16, 32, 3) and bool(torch.isfinite(y).all())


# ---- utils/profiling.py -----------------------------------------------------


def test_profiling_trace_annotate_and_hard_sync(tmp_path):
    model = AttentionUNet(in_T=T, depth=2, out_T=1, device="cpu")
    x = torch.zeros(1, T, 8, 8, 4)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("zoo_forward"), torch.no_grad():
            y = model(x)
    profiling.hard_sync({"y": [y, (y,)], "n": 3})
    names = {e.name for e in prof.events()}
    assert "zoo_forward" in names
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    trace = json.loads((tmp_path / files[0]).read_text())
    assert any(e.get("name") == "zoo_forward" for e in trace["traceEvents"])
