"""Port parity: CViT (``tante_tpu_torch/models/cvit.py``), its Trainer and
Evaler branches against the JAX package, f32 on the CPU at 1e-4: the model
with each query embedding (grid, fourier, mlp) in point and full-grid
output; one ``Trainer(cvit=True)`` step beside the JAX Trainer (the same
sampled sites, the same loss, the same update) and its validation through
the chunked full-grid rollout; ``cvit_full_grid_rollout`` with a query count
that is not a multiple of the chunk; the ``Evaler``'s report.

Query coordinates come from the pixel lattice (as the trainers draw them):
with the RBF's eps = 1e5 a random point close to the midpoint of two latent
sites would turn an f32 rounding difference into a visible change of the
embedding; the lattice keeps its distance from every midpoint."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flatten, metadata, transplant
from tante_tpu.data import TanteDataModule
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.data.synthetic import make_well_dataset
from tante_tpu.models.cvit import CViT as JaxCViT
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train.evaler import cvit_full_grid_rollout as jax_cvit_full_grid_rollout
from tante_tpu.train.optimizers import AdamW as JaxAdamW
from tante_tpu.train.trainer import Trainer as JaxTrainer
from tante_tpu.train.trainer import sample_query_coords as jax_sample_query_coords
from tante_tpu_torch.convert import jax_params_from_state_dict, load_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.cvit import CViT
from tante_tpu_torch.ops import fused_attention as fa
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.evaler import Evaler, cvit_full_grid_rollout, full_grid_coords
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.rollout import rollout_fixed
from tante_tpu_torch.train.trainer import Trainer, sample_query_coords

ATOL = RTOL = 1e-4
T, H, W = 4, 32, 48
KW = dict(in_T=T, out_steps=2, patch_size=(1, 16, 16), grid_size=(8, 8), latent_dim=16,
          emb_dim=32, depth=2, num_heads=4, dec_emb_dim=32, dec_num_heads=4, dec_depth=1,
          num_mlp_layers=1, mlp_ratio=1)
WAVES = dict(resolution=(H, W), n_trajectories=2, n_steps=10, with_pressure=True, seed=0)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=rtol)


def lattice_coords(seed, n):
    return full_grid_coords(H, W)[np.random.default_rng(seed).permutation(H * W)[:n]]


@pytest.mark.parametrize("embedding", ["grid", "fourier", "mlp"])
def test_cvit_matches_jax(embedding, monkeypatch):
    kw = {**KW, "embedding_type": embedding}
    jm = JaxCViT(dset_metadata=metadata(JaxMetadata, (H, W)), **kw)
    x = np.random.default_rng(1).normal(size=(2, T, H, W, 4)).astype(np.float32)
    coords = lattice_coords(2, 10)
    params, tm = transplant(jm, CViT(dset_metadata=metadata(TanteMetadata, (H, W)),
                                     device="cpu", **kw), x, coords, seed=3)
    calls = []
    real = fa.packed_attention_ref
    monkeypatch.setattr(fa, "packed_attention_ref", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        pts = tm(torch.from_numpy(x), torch.from_numpy(coords))
        grid = tm(torch.from_numpy(x))
    assert pts.shape == (2, 2, 10, 4) and grid.shape == (2, 2, H, W, 4)
    close(pts, jm.apply(params, jnp.asarray(x), jnp.asarray(coords)))
    close(grid, jm.apply(params, jnp.asarray(x)))
    # 6 tokens x 4 heads <= 128: both encoder self-attentions take the packed
    # branch in each of the two calls; the cross-attentions do not.
    assert len(calls) == 4


def test_query_sites_follow_the_jax_stream():
    a = sample_query_coords(np.random.default_rng(5), H, W, 100)
    b = jax_sample_query_coords(np.random.default_rng(5), H, W, 100)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(full_grid_coords(H, W),
                                  np.asarray(jnp.asarray(full_grid_coords(H, W))))


def test_one_step_of_both_trainers_on_cvit(tmp_path):
    make_well_dataset(str(tmp_path / "data"), dataset_name="synthetic_waves", **WAVES)
    jdm = TanteDataModule(base_path=str(tmp_path / "data"), dataset_name="synthetic_waves",
                          batch_size=2, n_steps_input=T, n_steps_output=2, eval_steps_output=3,
                          data_workers=2, seed=0)
    tdm = WaveDataModule(batch_size=2, n_steps_input=T, n_steps_output=2, eval_steps_output=3,
                         data_workers=2, seed=0, device="cpu", waves=WAVES)
    common = dict(max_epoch=2, n_steps_output=2, n_steps_rollout=3, seed=0, cvit=True,
                  num_query_points=100)
    jt = JaxTrainer(str(tmp_path / "jax"), "channels_last_default",
                    JaxCViT(dset_metadata=jdm.train_dataset.metadata, **KW), jdm,
                    JaxAdamW(lr=1e-3, weight_decay=1e-5), jmetrics.MSE(), jmetrics.VRMSE(),
                    **common)
    tm = CViT(dset_metadata=tdm.train_dataset.metadata, device="cpu", **KW)
    start = flatten(jt.params)
    load_jax_params(tm, start)
    tr = Trainer(str(tmp_path / "torch"), "channels_last_default", tm, tdm,
                 AdamW(lr=1e-3, weight_decay=1e-5), tmetrics.MSE(), tmetrics.VRMSE(),
                 device="cpu", **common)
    # Validation: the chunked full-grid rollout, 3 steps = 2 model calls.
    val_j = jt.validation_loop(jdm.val_dataloader())
    assert tr.validation_loop(tdm.val_dataloader()) == pytest.approx(val_j, rel=1e-4)
    jb, tb = next(iter(jdm.train_dataloader())), next(iter(tdm.train_dataloader()))
    (jx,), jy = jt.formatter.process_input(jb)
    (tx,), ty = tr.formatter.process_input(tb)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    # The JAX Trainer samples its sites in train_one_epoch: the same draw here.
    coords, h_idx, w_idx = jax_sample_query_coords(jt.rng, H, W, 100)
    jt.params, jt.opt_state, jloss = jt._train_step(
        jt.params, jt.opt_state, jx, jy[:, :, h_idx, w_idx, :], jnp.asarray(coords),
        jt._next_dropout_key())
    tloss = tr.train_step(tx, ty)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-4)
    want, got = flatten(jt.params), jax_params_from_state_dict(tm.state_dict())
    params = dict(tm.named_parameters())

    def grad(key):  # the port's clipped gradient: AdamW's first moment / (1 - b1)
        return tr.optimizer.state[params[key.replace("/", ".")]]["exp_avg"] / 0.1

    for k in want:  # one AdamW step at 1e-3, held to a twentieth of it
        if k == "grid" or k.endswith("k_proj/bias"):
            # At eps = 1e5 the RBF softmax saturates: the grid's true gradient
            # is 0.  A key bias adds the same logit to every key of a query,
            # which softmax ignores: its true gradient is 0 too.  Both
            # packages return rounding noise, which AdamW scales to steps of
            # up to lr: held to that bound.
            for a in (got[k], want[k]):
                assert np.abs(a - start[k]).max() <= 1.001e-3
            if k != "grid":
                q = k[:-len("k_proj/bias")] + "q_proj/bias"
                assert grad(k).norm() < 1e-5 * grad(q).norm(), k
            continue
        np.testing.assert_allclose(got[k], want[k], atol=0.05 * 1e-3, rtol=0, err_msg=k)


def test_full_grid_rollout_with_a_ragged_last_chunk_and_the_evaler(tmp_path):
    jm = JaxCViT(dset_metadata=metadata(JaxMetadata, (H, W)), **KW)
    x = np.random.default_rng(4).normal(size=(2, T, H, W, 4)).astype(np.float32)
    params, tm = transplant(jm, CViT(dset_metadata=metadata(TanteMetadata, (H, W)),
                                     device="cpu", **KW), x, lattice_coords(0, 4), seed=5)
    y_shape = (2, 3, H, W, 4)
    assert (H * W) % 500
    want = jax_cvit_full_grid_rollout(jm, params, jnp.asarray(x), y_shape, 3, 500)
    with torch.no_grad():
        got = cvit_full_grid_rollout(tm, torch.from_numpy(x), y_shape, 3, 500)
        plain = rollout_fixed(tm, torch.from_numpy(x), 3, 2)  # coords=None: the grid at once
    assert got.shape == y_shape
    close(got, want)
    close(got, plain, atol=1e-5, rtol=1e-5)
    # The Evaler's report: each metric the metric function on those rollouts.
    dm = WaveDataModule(batch_size=2, n_steps_input=T, n_steps_output=2, eval_steps_output=3,
                        data_workers=1, seed=0, device="cpu",
                        waves=WAVES)
    tm = CViT(dset_metadata=dm.train_dataset.metadata, device="cpu", **KW)
    names = ["MSE", "L2RE", "NNMSE", "VRMSE"]
    fns = [getattr(tmetrics, n)() for n in names]
    report = Evaler(str(tmp_path), "channels_last_default", tm, dm, *fns, n_steps_rollout=3,
                    cvit=True, num_query_points=500, device="cpu").Eval()
    own = {n: [] for n in names}
    with torch.no_grad():
        for batch in dm.test_dataloader():
            y = rollout_fixed(tm, batch["input"], 3, 2)
            for n, fn in zip(names, fns):
                own[n].append(float(fn(y, batch["output"]).mean()))
    for n in names:
        assert report["metrics"][n] == pytest.approx(np.mean(own[n]), rel=1e-5)
