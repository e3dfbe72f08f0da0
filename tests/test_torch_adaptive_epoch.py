"""Port parity of the adaptive training path, continued: one epoch and one
validation of both ``R_Trainer``s over the same batches (JAX over the HDF5
files, the port over the in-memory waves of the same seed), the ``R_Evaler``
report against JAX's, and ``R_Trainer``'s options.  f32 on the CPU; the
model and cases are ``test_torch_adaptive_train``'s."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flatten
from tante_tpu.data import TanteDataModule
from tante_tpu.data.synthetic import make_well_dataset
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train.optimizers import AdamW as JaxAdamW
from tante_tpu.train.r_evaler import R_Evaler as JaxREvaler
from tante_tpu.train.r_trainer import R_Trainer as JaxRTrainer
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.train import R_Evaler, R_Trainer, five_number_summary
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.rollout import rollout_adaptive_eval_tante
from test_torch_adaptive_train import KW, LR, RES, RKW, WD

# ---- one epoch of both trainers, and the R_Evaler report ---------------------

WAVES = dict(resolution=RES, n_trajectories=2, n_steps=12, with_pressure=True, seed=0)


def datamodules(tmp_path, n_out, n_roll):
    make_well_dataset(str(tmp_path / "data"), dataset_name="synthetic_waves", **WAVES)
    jdm = TanteDataModule(base_path=str(tmp_path / "data"), dataset_name="synthetic_waves",
                          batch_size=2, n_steps_input=4, n_steps_output=n_out,
                          eval_steps_output=n_roll, data_workers=2, seed=0)
    tdm = WaveDataModule(batch_size=2, n_steps_input=4, n_steps_output=n_out,
                         eval_steps_output=n_roll, data_workers=2, seed=0, device="cpu",
                         waves=WAVES)
    return jdm, tdm


def const_rt_head(params, bias):
    """Every call reports r_t = clip(bias, 0, out_T - 1) + 1.001."""
    p = jax.tree_util.tree_map(lambda z: z, params)
    head = dict(p["params"]["interprators_0"]["TorchDense_2"]["Dense_0"])
    head["kernel"] = jnp.zeros_like(head["kernel"])
    head["bias"] = jnp.full_like(head["bias"], bias)
    p["params"]["interprators_0"]["TorchDense_2"]["Dense_0"] = head
    return p


@pytest.mark.parametrize("case", ["one_frame", "vf_growth"])
def test_one_epoch_of_both_trainers(case, tmp_path):
    """The JAX R_Trainer over the HDF5 files and the port's over the
    in-memory waves of the same seed: same weights, one epoch, one
    validation; the logs and both appended files.  The interprator's head
    holds r_t at clip(1.5, 0, out_T - 1) + 1.001: 1.501 at out_T 1.5 (one
    frame a call), 2.501 at 4 (the vf engine: 2 frames a slot, so 2 real
    calls of 4 slots) and at the validation's out_T 3 (2 frames a call)."""
    rkw = RKW[case]
    n_out, n_roll = 4, 3
    jdm, tdm = datamodules(tmp_path, n_out, n_roll)
    md = jdm.train_dataset.metadata
    jm = JaxTANTE(dset_metadata=md, **KW)
    common = dict(max_epoch=1, n_steps_output=n_out, n_steps_rollout=n_roll, seed=0, **rkw)
    jt = JaxRTrainer(str(tmp_path / "jax"), "channels_last_default", jm, jdm,
                     JaxAdamW(lr=LR, weight_decay=WD), jmetrics.MSE(), jmetrics.L2RE(), **common)
    jt.params = const_rt_head(jt.params, 1.5)
    jt.opt_state = jt.tx.init(jt.params["params"])
    tm = TANTE(dset_metadata=tdm.train_dataset.metadata, device="cpu", **KW)
    load_jax_params(tm, flatten(jt.params))
    tt = R_Trainer(str(tmp_path / "torch"), "channels_last_default", tm, tdm,
                   AdamW(lr=LR, weight_decay=WD), tmetrics.MSE(), tmetrics.L2RE(),
                   device="cpu", **common)
    assert tt.steps_per_epoch == jt.steps_per_epoch >= 2
    jl, jlogs = jt.train_one_epoch(1, jdm.train_dataloader())
    tl, tlogs = tt.train_one_epoch(1, tdm.train_dataloader())
    # An epoch of f32 steps, each a rollout of up to four model calls: 1e-4.
    assert tl == pytest.approx(jl, rel=1e-4)
    # rt_var of equal r_t is rounding, a few f32 eps of r_t ~ 1.5: abs 1e-6.
    for k in ("train_loss", "rt", "rt_var", "steps", "lr"):
        assert tlogs[k] == pytest.approx(jlogs[k], rel=1e-4, abs=1e-6), k
    calls = n_out if case == "one_frame" else n_out // 2
    assert tlogs["steps"] == calls * 2 / 4  # B = 2
    jv = jt.validation_loop(jdm.val_dataloader())
    tv = tt.validation_loop(tdm.val_dataloader())
    assert tv == pytest.approx(jv, rel=1e-4)
    for name in ("saved_loss.txt", "saved_rt.txt"):
        want = [float(v) for v in (tmp_path / "jax" / name).read_text().split()]
        got = [float(v) for v in (tmp_path / "torch" / name).read_text().split()]
        np.testing.assert_allclose(got, want, rtol=1e-4)
    # The epoch's AdamW steps moved the head's bias by ~1e-3 a step.
    assert float((tmp_path / "torch" / "saved_rt.txt").read_text()) == pytest.approx(2.501,
                                                                                   abs=2e-2)


def losses(mod):
    return [getattr(mod, n)() for n in ("MSE", "L2RE", "NNMSE", "VRMSE")]


@pytest.mark.parametrize("out_t_max", [0, 2])
def test_r_evaler_report_matches_jax(out_t_max, tmp_path):
    n_roll = 5
    jdm, tdm = datamodules(tmp_path, 2, n_roll)
    md = jdm.train_dataset.metadata
    jm = JaxTANTE(dset_metadata=md, **KW)
    jev = JaxREvaler(str(tmp_path / "jax"), "channels_last_default", jm, jdm, *losses(jmetrics),
                     n_steps_rollout=n_roll, out_T_max=out_t_max)
    # A zero kernel makes r_t exact arithmetic in both packages:
    # clip(2.5, 0, 4) + 1.001 = 3.501 at out_T 5 (3 frames a call, 2 calls);
    # clip(2.5, 0, 1) + 1.001 = 2.001 at the K = 2 cap (2 frames, 3 calls).
    jev.params = const_rt_head(jev.params, 2.5)
    tm = TANTE(dset_metadata=tdm.train_dataset.metadata, device="cpu", **KW)
    load_jax_params(tm, flatten(jev.params))
    tev = R_Evaler(str(tmp_path / "torch"), "channels_last_default", tm, tdm, *losses(tmetrics),
                   n_steps_rollout=n_roll, out_T_max=out_t_max, device="cpu")
    want, got = jev.Eval(), tev.Eval()
    assert set(got) == set(want) == {"metrics", "variance", "rt_mean", "model_calls_per_rollout",
                                     "mean_rollout_time_s", "error_summary", "rt_summary"}
    assert got["model_calls_per_rollout"] == want["model_calls_per_rollout"] == (
        2 if out_t_max == 0 else 3)
    for part in ("metrics", "variance", "error_summary", "rt_summary"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            # f32 rollouts of up to three model calls, another summation order.
            assert got[part][k] == pytest.approx(want[part][k], rel=1e-4, abs=1e-9), (part, k)
    assert got["rt_mean"] == pytest.approx(want["rt_mean"], rel=1e-4)
    assert got["mean_rollout_time_s"] > 0
    record = json.loads((tmp_path / "torch" / "metrics.jsonl").read_text().splitlines()[-1])
    assert record["model_calls_per_rollout"] == got["model_calls_per_rollout"]
    # The calls are the Morton engine's on the same batch.
    batch = next(iter(tdm.test_dataloader()))
    with torch.no_grad():
        _, _, n_calls = rollout_adaptive_eval_tante(
            tm, batch["input"], n_roll, out_t_max if out_t_max else n_roll)
    assert n_calls == got["model_calls_per_rollout"]


def test_five_number_summary():
    data = [3.0, 1.0, 4.0, 1.0, 5.0]
    assert five_number_summary(data) == {"min": 1.0, "q1": 1.0, "median": 3.0, "q3": 4.0,
                                         "max": 5.0}


# ---- options ------------------------------------------------------------------


def make_r_trainer(tmp_path, **kw):
    tdm = WaveDataModule(batch_size=2, n_steps_input=4, n_steps_output=4, device="cpu",
                         waves=WAVES)
    tm = TANTE(dset_metadata=tdm.train_dataset.metadata, device="cpu", **KW)
    return R_Trainer(str(tmp_path), "channels_last_default", tm, tdm, AdamW(), tmetrics.MSE(),
                     tmetrics.L2RE(), max_epoch=1, device="cpu", **kw)


def test_r_trainer_defaults_warning_and_refusals(tmp_path):
    tr = make_r_trainer(tmp_path)  # rt_eps 0.5: band 1.5, reachable at 1.5
    assert (tr.n_steps_output, tr.train_out_T, tr.rt_band_hi, tr.rt_supervision) == (4, 1.5,
                                                                                      4.0, 0.0)
    assert (tr.rt_sup_mode, tr.rt_sup_growth, tr.rt_sup_tau) == ("growth", 4.0, 0.5)
    assert not tr.vf and tr.k == 1 and not tr.gradient_checkpointing
    # The value clip: every gradient entry to +-1, no rescaling.
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([-3.0, 0.5, 2.0])
    tr._clip([p])
    assert p.grad.tolist() == [-1.0, 0.5, 1.0]
    vf = make_r_trainer(tmp_path, train_out_T=8.0, rt_band_hi=8.0, rt_eps=3.0)
    assert vf.vf and vf.k == 8 and vf.gradient_checkpointing
    assert not make_r_trainer(tmp_path, train_out_T=8.0, rt_band_hi=8.0,
                              gradient_checkpointing=False).gradient_checkpointing
    with pytest.warns(UserWarning, match="unreachable"):
        make_r_trainer(tmp_path, rt_eps=7.0)
    with pytest.raises(ValueError, match="rt_sup_mode"):
        make_r_trainer(tmp_path, rt_sup_mode="relative")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_r_trainer(tmp_path, train_out_T=4.0, rt_eps=3.0, rt_band_hi=4.0)  # reachable
