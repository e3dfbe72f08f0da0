"""Port parity: ``tante_tpu_torch.train.evaler.Evaler`` against the JAX
``Evaler``, f32 on the CPU: the JAX one over the HDF5 files, the port's over
the in-memory waves of the same seed (the loaders agree, see
``test_torch_data.py``), with the same weights.  All four metrics and their
across-batch variances at 1e-4 relative."""

import json

import numpy as np
import pytest
import torch

from _torch_parity import flatten
from tante_tpu.data import TanteDataModule
from tante_tpu.data.synthetic import make_well_dataset
from tante_tpu.models.fno import FNO as JaxFNO
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train.evaler import Evaler as JaxEvaler
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.evaler import Evaler
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.rollout import rollout_fixed
from tante_tpu_torch.train.trainer import Trainer

T_IN, N_ROLL = 4, 3
WAVES = dict(resolution=(16, 24), n_trajectories=2, n_steps=10, with_pressure=True, seed=0)
NAMES = ["MSE", "L2RE", "NNMSE", "VRMSE"]
MODELS = {
    "fno": (JaxFNO, FNO, dict(in_T=T_IN, modes1=6, modes2=6, hidden_channels=8, n_layers=2)),
    # fixed-step TANTE: both Evalers take the latent-cached rollout
    "tante": (JaxTANTE, TANTE, dict(in_T=T_IN, taylor_order=1, attn_axes="THW", embed_dim=32,
                                    patch_scale=8, n_head=4, mlp_ratio=1.0, output_length=1)),
}


def losses(mod):
    return [getattr(mod, n)() for n in NAMES]


@pytest.fixture()
def tdm():
    return WaveDataModule(batch_size=2, n_steps_input=T_IN, n_steps_output=2,
                          eval_steps_output=N_ROLL, data_workers=2, seed=0, device="cpu",
                          waves=WAVES)


def port_evaler(tmp_path, tdm, model, **kw):
    return Evaler(str(tmp_path / "torch"), "channels_last_default", model, tdm,
                  *losses(tmetrics), n_steps_rollout=N_ROLL, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_report_matches_the_jax_evaler(name, tmp_path, tdm):
    jcls, tcls, kw = MODELS[name]
    make_well_dataset(str(tmp_path / "data"), dataset_name="synthetic_waves", **WAVES)
    jdm = TanteDataModule(base_path=str(tmp_path / "data"), dataset_name="synthetic_waves",
                          batch_size=2, n_steps_input=T_IN, n_steps_output=2,
                          eval_steps_output=N_ROLL, data_workers=2, seed=0)
    jev = JaxEvaler(str(tmp_path / "jax"), "channels_last_default",
                    jcls(dset_metadata=jdm.train_dataset.metadata, **kw), jdm, *losses(jmetrics),
                    n_steps_rollout=N_ROLL)
    tm = tcls(dset_metadata=tdm.train_dataset.metadata, device="cpu", **kw)
    load_jax_params(tm, flatten(jev.params))
    tev = port_evaler(tmp_path, tdm, tm)
    want, got = jev.Eval(), tev.Eval()
    assert len(tdm.test_dataloader()) >= 2  # so that the variances are real
    eps = float(np.finfo(np.float32).eps)
    for part in ("metrics", "variance"):
        assert list(got[part]) == NAMES
    for k in NAMES:
        mean, var = want["metrics"][k], want["variance"][k]
        assert got["metrics"][k] == pytest.approx(mean, rel=1e-4), k
        # A fresh FNO scores every batch alike (L2RE ~ 1 +- 5e-5), and the
        # variance of nearly equal numbers amplifies the f32 rounding of each
        # batch's mean (a few eps of it) by 2 / std: that much absolute slack,
        # which is below 1e-4 of the variance wherever the batches do differ.
        slack = 2 * var**0.5 * 4 * eps * mean
        assert got["variance"][k] == pytest.approx(var, rel=1e-4, abs=slack), k
        assert got["variance"][k] > 0
    if name == "tante":  # near persistence: the batches differ by their wave speeds
        assert all(got["variance"][k] ** 0.5 > 1e-2 * got["metrics"][k] for k in NAMES)
    assert got["mean_rollout_time_s"] > 0
    record = json.loads((tmp_path / "torch" / "metrics.jsonl").read_text().splitlines()[-1])
    assert record["metrics"] == got["metrics"] and record["variance"] == got["variance"]


def test_report_is_the_metric_functions_on_the_rollout(tmp_path, tdm):
    """Each reported mean is that metric's own function on the same rollout,
    averaged over the test batches."""
    tm = MODELS["fno"][1](dset_metadata=tdm.train_dataset.metadata, device="cpu",
                          **MODELS["fno"][2])
    report = port_evaler(tmp_path, tdm, tm).Eval()
    per_batch = {k: [] for k in NAMES}
    with torch.no_grad():
        for batch in tdm.test_dataloader():
            y = rollout_fixed(tm, batch["input"], N_ROLL, 1)
            for k, fn in zip(NAMES, losses(tmetrics)):
                per_batch[k].append(float(fn(y, batch["output"]).mean()))
    for k in NAMES:
        assert report["metrics"][k] == pytest.approx(np.mean(per_batch[k]), rel=1e-6)
        assert report["variance"][k] == pytest.approx(np.var(per_batch[k], ddof=1), rel=1e-5)


def test_evaler_loads_what_the_trainer_saved(tmp_path, tdm):
    md = tdm.train_dataset.metadata
    kw = MODELS["fno"][2]
    tr = Trainer(str(tmp_path / "run"), "channels_last_default", FNO(dset_metadata=md, device="cpu",
                 seed=1, **kw), tdm, AdamW(lr=1e-3), tmetrics.MSE(), tmetrics.VRMSE(),
                 max_epoch=1, n_steps_output=2, n_steps_rollout=N_ROLL, device="cpu")
    tr.train()
    trained = port_evaler(tmp_path, tdm, tr.model).Eval()
    fresh = FNO(dset_metadata=md, device="cpu", seed=2, **kw)
    loaded = port_evaler(tmp_path, tdm, fresh, checkpoint_path=str(tmp_path / "run" / "best"))
    assert loaded.Eval()["metrics"] == trained["metrics"]
    with pytest.raises(ValueError, match="does not match"):  # another geometry
        port_evaler(tmp_path, tdm, FNO(dset_metadata=md, device="cpu",
                                       **{**kw, "hidden_channels": 16}),
                    checkpoint_path=str(tmp_path / "run" / "best"))


def test_amp_evaluates_in_bf16_over_f32_weights(tmp_path, tdm):
    tm = FNO(dset_metadata=tdm.train_dataset.metadata, device="cpu", **MODELS["fno"][2])
    full = port_evaler(tmp_path, tdm, tm).Eval()
    ev = port_evaler(tmp_path, tdm, tm, enable_amp=True)
    assert tm.dtype == torch.bfloat16 and tm.FNOBlock_0.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    amp = ev.Eval()
    for k in NAMES:  # bf16 keeps 8 mantissa bits; three rollout steps
        assert amp["metrics"][k] == pytest.approx(full["metrics"][k], rel=5e-2)


def test_evaler_refuses_what_is_not_ported(tmp_path, tdm, monkeypatch):
    tm = FNO(dset_metadata=tdm.train_dataset.metadata, device="cpu", **MODELS["fno"][2])
    with pytest.raises(ValueError):
        port_evaler(tmp_path, tdm, tm, enable_amp=True, amp_type="float16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # the card unless asked for the CPU
        Evaler(str(tmp_path / "x"), "channels_last_default", tm, tdm, *losses(tmetrics))
