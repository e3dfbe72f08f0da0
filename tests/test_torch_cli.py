"""The port's user surface on the CPU: ``tante_tpu_torch.cli.train`` /
``cli.eval`` with ``--device cpu`` over a Well HDF5 tree (JAX's
``make_well_dataset``, the ``well_root_tiny`` fixture) at
``tests/test_configs_instantiate.py``'s tiny widths, resume, the eval report
against the port's ``Evaler``, and ``Predictor.from_experiment`` against the
JAX ``Predictor`` on the same weights (``tests/test_torch_rollout.py``'s
1e-4).  Without ``--device cpu`` / ``device="cpu"`` every entry point asks
for the card.  The shipped TANTE configs run as written, in f32 (they set
no ``enable_amp``): the port's train CLI's checkpoint serves as the JAX
``Predictor`` does with the same weights, and the eval CLI reports what the
JAX package's evaler reports on them."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tante_tpu import config as jconfig
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.serve import Predictor as JaxPredictor
from tante_tpu_torch.cli import eval as cli_eval
from tante_tpu_torch.cli import train as cli_train
from tante_tpu_torch.config import instantiate, load_config
from tante_tpu_torch.convert import jax_params_from_state_dict, load_jax_params, seeded_jax_params
from tante_tpu_torch.data import TanteDataModule
from tante_tpu_torch.models import TANTE
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.train.evaler import Evaler
from tante_tpu_torch.utils.checkpoint import CheckpointManager

ATOL = RTOL = 1e-4  # tests/test_torch_rollout.py: f32, another summation order

SHRINK = {
    "tante": ["model.embed_dim=32", "model.n_head=4", "model.attn_axes=TH"],
    "tante_adaptive": ["model.embed_dim=32", "model.n_head=4", "model.attn_axes=TH"],
    "fno": ["model.hidden_channels=8", "model.modes1=4", "model.modes2=4"],
}


def overrides(name, well, root, experiment="E", epochs=1):
    return [f"data.base_path={well}", "data.dataset_name=synthetic_waves", "data.batch_size=2",
            "data.n_steps_output=2", "data.eval_steps_output=4", "data.data_workers=2",
            f"trainer.max_epoch={epochs}", "trainer.n_steps_output=2",
            "trainer.n_steps_rollout=4", "evaler.n_steps_rollout=4", f"root_path={root}",
            f"experiment={experiment}", *SHRINK[name]]


def records(folder):
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(well_root_tiny, tmp_path_factory):
    """name -> (experiment folder, overrides): one epoch of each config
    through the CLI, then a rerun to max_epoch 2."""
    root = str(tmp_path_factory.mktemp("cli"))
    out = {}
    for name in SHRINK:
        ov = overrides(name, well_root_tiny, root, experiment=name)
        first = cli_train.main([f"--config-name={name}", "--device", "cpu", *ov])
        folder = os.path.join(root, "experiments", name)
        out[name] = {"folder": folder, "overrides": ov, "first": first,
                     "records_1": records(folder),
                     "config_1": load_config(os.path.join(folder, "extended_config.yaml"))}
        out[name]["second"] = cli_train.main(
            [f"--config-name={name}", "--device", "cpu", *overrides(
                name, well_root_tiny, root, experiment=name, epochs=2)])
        out[name]["records_2"] = records(folder)
    return out


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_training_run_writes_the_experiment(trained, name):
    run = trained[name]
    folder, trainer = run["folder"], run["first"]
    for path in ("metrics.jsonl", "recent/state.pt", "best/state.pt", "extended_config.yaml",
                 "saved_loss.txt"):
        assert os.path.exists(os.path.join(folder, path)), path
    assert type(trainer).__name__ == ("R_Trainer" if name == "tante_adaptive" else "Trainer")
    assert trainer.device.type == "cpu"
    assert isinstance(trainer.datamodule, TanteDataModule)
    epochs = [r["_step"] for r in run["records_1"] if "train_loss" in r]
    assert epochs == [1] and all(np.isfinite(r["train_loss"]) for r in run["records_1"]
                                 if "train_loss" in r)
    saved = run["config_1"]
    assert saved.trainer.max_epoch == 1 and saved.experiment == name
    assert saved.trainer.checkpoint_path == ""  # a fresh run: nothing to resume
    if name == "tante_adaptive":
        assert os.path.exists(os.path.join(folder, "saved_rt.txt"))


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_rerun_resumes_and_trains_one_more_epoch(trained, name):
    run = trained[name]
    new = run["records_2"][len(run["records_1"]):]
    assert [r["_step"] for r in new if "train_loss" in r] == [2]
    second = run["second"]
    assert second.starting_epoch == 2 and second.max_epoch == 2
    saved = load_config(os.path.join(run["folder"], "extended_config.yaml"))
    assert saved.trainer.checkpoint_path == os.path.join(run["folder"], "recent")
    state = torch.load(os.path.join(run["folder"], "recent", "state.pt"), weights_only=True)
    assert state["meta"]["epoch"] == 2
    # the resumed trainer started from the first run's weights and optimizer state
    assert second.global_step == 2 * second.steps_per_epoch


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_eval_report_equals_the_ports_evaler(trained, well_root_tiny, name, capsys):
    run = trained[name]
    report = cli_eval.main([f"--config-name={name}", "--choose=best", "--device", "cpu",
                            *run["overrides"]])
    assert str(report["metrics"]) in capsys.readouterr().out
    cfg = load_config(name, overrides=run["overrides"])
    cfg.data.eval_steps_output = cfg.evaler.n_steps_rollout
    dm = instantiate(cfg.data, seed=cfg.seed, device="cpu")
    assert dm.test_dataset.n_steps_output == 4
    model = instantiate(cfg.model, dset_metadata=dm.train_dataset.metadata, seed=cfg.seed,
                        device="cpu")
    evaler = instantiate(cfg.evaler, checkpoint_folder=run["folder"], model=model,
                         datamodule=dm, batch_size=cfg.data.batch_size, device="cpu",
                         checkpoint_path=os.path.join(run["folder"], "best"))
    assert isinstance(evaler, Evaler)
    want = evaler.Eval(mode="common")
    assert set(report["metrics"]) == {"MSE", "L2RE", "NNMSE", "VRMSE"}
    assert report["metrics"] == want["metrics"] and report["variance"] == want["variance"]
    assert all(np.isfinite(v) for v in report["metrics"].values())
    if name == "tante_adaptive":
        assert report["model_calls_per_rollout"] == want["model_calls_per_rollout"]


def seeded_experiment(name, well, root, seed=4):
    """A checkpoint the port's CheckpointManager saved from JAX-seeded
    weights; -> (JAX model, JAX params, overrides)."""
    ov = overrides(name, well, root, experiment=f"{name}_seeded")
    cfg = load_config(name, overrides=ov)
    dm = instantiate(cfg.data, seed=cfg.seed, device="cpu")
    md = dm.train_dataset.metadata
    tm = instantiate(cfg.model, dset_metadata=md, device="cpu")
    flat = seeded_jax_params(tm, seed)
    load_jax_params(tm, flat)
    CheckpointManager(os.path.join(root, "experiments", f"{name}_seeded")).save(
        "best", tm.state_dict(), {}, 1, 0.5, 0.5)
    jm = jconfig.instantiate(jconfig.load_config(name, overrides=ov).model,
                             dset_metadata=JaxMetadata(**vars(md)))
    params = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    return jm, params, ov


def history(seed=0):
    return np.random.default_rng(seed).normal(size=(2, 4, 16, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["tante", "fno"])
def test_from_experiment_rollout_matches_jax(well_root_tiny, tmp_path, name):
    jm, params, ov = seeded_experiment(name, well_root_tiny, str(tmp_path))
    p = Predictor.from_experiment(name, experiment=f"{name}_seeded", root_path=str(tmp_path),
                                  choose="best", overrides=ov, device="cpu")
    assert p.device.type == "cpu" and next(p.model.parameters()).device.type == "cpu"
    assert type(p.model).__name__ == type(jm).__name__
    x = history()
    got = p.rollout(x, 6)
    want = JaxPredictor(jm, params).rollout(x, 6)
    assert got.shape == (2, 6, 16, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_from_experiment_adaptive_rollout_matches_jax(well_root_tiny, tmp_path):
    jm, params, ov = seeded_experiment("tante_adaptive", well_root_tiny, str(tmp_path))
    p = Predictor.from_experiment("tante_adaptive", experiment="tante_adaptive_seeded",
                                  root_path=str(tmp_path), overrides=ov, device="cpu")
    x = history(1)
    got, got_rt, got_calls = p.rollout_adaptive(x, 6)
    want, want_rt, want_calls = JaxPredictor(jm, params).rollout_adaptive(x, 6)
    assert got_calls == want_calls
    np.testing.assert_allclose(got_rt, want_rt, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_from_experiment_serves_in_the_evalers_compute_dtype(trained):
    run = trained["tante"]
    root = os.path.dirname(os.path.dirname(run["folder"]))
    p = Predictor.from_experiment("tante", experiment="tante", root_path=root,
                                  overrides=[*run["overrides"], "evaler.enable_amp=true"],
                                  device="cpu")
    assert p.model.dtype == torch.bfloat16
    by_hand = instantiate(load_config("tante", overrides=run["overrides"]).model,
                          dset_metadata=p.metadata, device="cpu")
    state = torch.load(os.path.join(run["folder"], "best", "state.pt"), weights_only=True)
    by_hand.load_state_dict(state["params"])
    from tante_tpu_torch.train.trainer import set_compute_dtype

    ref = Predictor(set_compute_dtype(by_hand, torch.bfloat16), device="cpu")
    x = history(2)
    assert torch.equal(p.rollout(x, 3), ref.rollout(x, 3))


@pytest.mark.parametrize("choose", ["best", "recent"])
def test_from_experiment_without_a_checkpoint_raises(well_root_tiny, tmp_path, choose):
    with pytest.raises(FileNotFoundError, match=choose):
        Predictor.from_experiment("fno", experiment="NONE", root_path=str(tmp_path),
                                  choose=choose,
                                  overrides=overrides("fno", well_root_tiny, str(tmp_path)),
                                  device="cpu")


def test_entry_points_ask_for_the_card_by_default(well_root_tiny, tmp_path, trained):
    """``Predictor(model)`` never serves on the CPU unless asked to, whatever
    device the model was built on; the CLIs and ``from_experiment`` neither."""
    model = TANTE(in_T=4, dset_metadata=trained["tante"]["first"].dset_metadata, embed_dim=32,
                  n_head=4, attn_axes="TH", patch_scale=8, device="cpu")
    if torch.cuda.is_available():
        assert Predictor(model).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_numpy(model, seeded_jax_params(model, 0))
    assert next(model.parameters()).device.type == "cpu"
    ov = overrides("fno", well_root_tiny, str(tmp_path))
    for main in (cli_train.main, cli_eval.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--config-name=fno", *ov])
    run = trained["fno"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_experiment("fno", experiment="fno",
                                  root_path=os.path.dirname(os.path.dirname(run["folder"])),
                                  overrides=run["overrides"])


def jax_weights(folder):
    """The best checkpoint the port's train CLI wrote, as a flax param tree."""
    state = torch.load(os.path.join(folder, "best", "state.pt"), weights_only=True)
    flat = jax_params_from_state_dict(state["params"])
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def jax_model(name, ov, md):
    return jconfig.instantiate(jconfig.load_config(name, overrides=ov).model,
                               dset_metadata=JaxMetadata(**vars(md)))


@pytest.mark.parametrize("name", ["tante", "tante_adaptive"])
@pytest.mark.parametrize("entry", ["train", "eval", "from_experiment"])
def test_shipped_tante_configs_run_in_f32_at_every_entry(trained, name, entry):
    """The shipped configs (only data, size and run overrides) set no
    enable_amp: every entry point builds and runs the model in f32."""
    run = trained[name]
    assert not any("enable_amp" in o for o in run["overrides"])
    cfg = load_config(name, overrides=run["overrides"])
    assert not cfg.trainer.get("enable_amp", False) and not cfg.evaler.get("enable_amp", False)
    root = os.path.dirname(os.path.dirname(run["folder"]))
    if entry == "train":
        model = run["first"].model
    elif entry == "eval":
        report = cli_eval.main([f"--config-name={name}", "--choose=best", "--device", "cpu",
                                *run["overrides"]])
        assert all(np.isfinite(v) for v in report["metrics"].values())
        model = None
    else:
        model = Predictor.from_experiment(name, experiment=name, root_path=root,
                                          overrides=run["overrides"], device="cpu").model
    if model is not None:
        assert model.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("name", ["tante", "tante_adaptive"])
def test_shipped_config_train_cli_weights_serve_as_the_jax_predictor(trained, well_root_tiny,
                                                                    name):
    """The train CLI's best checkpoint (shipped config, f32) through
    ``from_experiment`` against the JAX ``Predictor`` on the same weights."""
    run = trained[name]
    root = os.path.dirname(os.path.dirname(run["folder"]))
    p = Predictor.from_experiment(name, experiment=name, root_path=root,
                                  overrides=run["overrides"], device="cpu")
    jp = JaxPredictor(jax_model(name, run["overrides"], p.metadata), jax_weights(run["folder"]))
    x = history(3)
    if name == "tante":
        np.testing.assert_allclose(p.rollout(x, 5).numpy(), np.asarray(jp.rollout(x, 5)),
                                   atol=ATOL, rtol=RTOL)
        return
    got, got_rt, got_calls = p.rollout_adaptive(x, 5)
    want, want_rt, want_calls = jp.rollout_adaptive(x, 5)
    assert got_calls == want_calls
    np.testing.assert_allclose(got_rt, want_rt, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["tante", "tante_adaptive"])
def test_shipped_config_eval_cli_reports_what_the_jax_evaler_reports(trained, name):
    """The eval CLI on the train CLI's best checkpoint (shipped config, f32)
    against the JAX package's evaler, built from the same config as its eval
    CLI builds it, on the same weights and HDF5 files."""
    run = trained[name]
    ov = run["overrides"]
    report = cli_eval.main([f"--config-name={name}", "--choose=best", "--device", "cpu", *ov])
    jcfg = jconfig.load_config(name, overrides=ov)
    jcfg.data.eval_steps_output = jcfg.evaler.n_steps_rollout
    jdm = jconfig.instantiate(jcfg.data, seed=jcfg.seed)
    jev = jconfig.instantiate(jcfg.evaler, checkpoint_folder=str(run["folder"]) + "_jax",
                              model=jax_model(name, ov, jdm.train_dataset.metadata),
                              datamodule=jdm, batch_size=jcfg.data.batch_size)
    jev.params = jax_weights(run["folder"])
    want = jev.Eval(mode="common")
    for k, v in want["metrics"].items():
        assert report["metrics"][k] == pytest.approx(float(v), rel=1e-4), k
    if name == "tante_adaptive":
        assert report["model_calls_per_rollout"] == pytest.approx(
            float(want["model_calls_per_rollout"]))
