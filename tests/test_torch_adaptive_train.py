"""Port parity: the adaptive training path (``tante_tpu_torch.train``:
``rollout_adaptive_train``, ``rollout_adaptive_train_vf``, ``R_Trainer``
steps) against the JAX package, f32 on the CPU, from the same numpy-seeded
inputs and state (``test_torch_adaptive_epoch.py``: epochs, ``R_Evaler``).

Tolerances, each with its reason, stand beside the assertion that uses it."""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import F, flatten, metadata
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.train import metrics as jmetrics
from tante_tpu.train import rollout as jroll
from tante_tpu.train.optimizers import AdamW as JaxAdamW
from tante_tpu.train.r_trainer import R_Trainer as JaxRTrainer
from tante_tpu_torch.convert import (
    jax_params_from_state_dict, load_jax_params, load_optax_adam_state,
)
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.train import R_Trainer, rollout_adaptive_train, rollout_adaptive_train_vf
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.optimizers import AdamW

# ---- the engines on a stand-in model ----------------------------------------

EB, ET, EH, EW, EC = 3, 3, 4, 5, 2
# Per-sample r_t centres: floor 2, 3 and 5 (clipped to k = 4).  At n_steps 6
# sample 1 finishes after two slots, sample 2 after two (its offset passes
# n_steps: the clamped write), sample 0 after three, and slots 3-5 are skipped.
RT_CENTRES = np.array([2.6, 3.4, 5.7], np.float32)
E_STEPS, E_K = 6, 4


def engine_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(EB, ET, EH, EW, EC)).astype(np.float32)
    wm = (0.5 * rng.normal(size=(EC, EC))).astype(np.float32)
    v = rng.normal(size=(EC,)).astype(np.float32)
    g = rng.normal(size=(EB, E_STEPS, EH, EW, EC)).astype(np.float32)
    h = rng.normal(size=(E_STEPS, EB)).astype(np.float32)
    return x, wm, v, g, h


def jax_model(wm, v, k):
    def apply(win):
        last = win[:, -1:]
        d = jnp.einsum("bthwc,cd->bthwd", last, wm)
        frames = jnp.concatenate([last + 0.1 * (j + 1) * d for j in range(k)], axis=1)
        rt = jnp.asarray(RT_CENTRES) + 0.02 * jnp.tanh(jnp.mean(last * v, axis=(1, 2, 3, 4)))
        return frames, rt
    return apply


def torch_model(wm, v, k, gen=None):
    def apply(win):
        last = win[:, -1:]
        d = torch.einsum("bthwc,cd->bthwd", last, wm)
        if gen is not None:  # a dropout mask from the caller's generator
            d = d * (torch.rand(d.shape, generator=gen) > 0.2) / 0.8
        frames = torch.cat([last + 0.1 * (j + 1) * d for j in range(k)], dim=1)
        rt = torch.from_numpy(RT_CENTRES) + 0.02 * torch.tanh((last * v).mean(dim=(1, 2, 3, 4)))
        return frames, rt
    return apply


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_one_frame_engine_matches_jax():
    x, wm, v, g, _ = engine_inputs(1)

    def jloss(wm_, v_):
        y, rts = jroll.rollout_adaptive_train(jax_model(wm_, v_, 1), jnp.asarray(x), E_STEPS)
        return jnp.sum(y * g) + jnp.sum(rts), (y, rts)

    (_, (jy, jrts)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(wm), jnp.asarray(v))
    twm, tv = t(wm, True), t(v, True)
    y, rts = rollout_adaptive_train(torch_model(twm, tv, 1), t(x), E_STEPS)
    (torch.sum(y * t(g)) + rts.sum()).backward()
    assert y.shape == (EB, E_STEPS, EH, EW, EC) and rts.shape == (E_STEPS, EB)
    # f32, the same operations in the same order: 1e-6.
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rts.detach().numpy(), np.asarray(jrts), rtol=1e-6, atol=1e-6)
    # Gradients through six chained calls, summed in another order: 1e-5.
    for got, want in zip((twm.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_variable_frame_engine_matches_jax(remat):
    x, wm, v, g, h = engine_inputs(2)

    def jloss(wm_, v_):
        y, rts, act, cums = jroll.rollout_adaptive_train_vf(
            jax_model(wm_, v_, E_K), jnp.asarray(x), E_STEPS, E_K, remat=remat)
        return jnp.sum(y * g) + jnp.sum(rts * act * h), (y, rts, act, cums)

    (_, (jy, jrts, jact, jcums)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(wm), jnp.asarray(v))
    twm, tv = t(wm, True), t(v, True)
    calls = []

    def counted(w):
        calls.append(1)
        return torch_model(twm, tv, E_K)(w)

    y, rts, act, cums = rollout_adaptive_train_vf(counted, t(x), E_STEPS, E_K, remat=remat)
    (torch.sum(y * t(g)) + torch.sum(rts * act * t(h))).backward()
    # The case the test is for: samples finish at different slots, a
    # finished sample's offset passes n_steps, and the last slots are skipped.
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(cums.numpy(), np.asarray(jcums))
    assert cums.dtype == torch.int32
    assert act.sum(0).tolist() == [3, 2, 2]
    assert cums[:, 2].tolist() == [0, 4, 8, 8, 8, 8]
    assert not act[3:].any() and torch.equal(rts[3:], torch.zeros(3, EB))
    # Model calls: slots with an active sample, and the recompute with remat.
    assert len(calls) == 3 * (2 if remat else 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rts.detach().numpy(), np.asarray(jrts), rtol=1e-6, atol=1e-6)
    for got, want in zip((twm.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_overwritten_frames_get_no_gradient():
    """A frame is trained iff it is used: the speculative tail of a block,
    overwritten by the next block, gets zero gradient."""
    x, wm, v, _, _ = engine_inputs(3)
    frames_seen = []

    def apply(w):
        frames, rt = torch_model(t(wm), t(v), E_K)(w)
        frames = frames.detach().requires_grad_(True)
        frames_seen.append(frames)
        return frames, rt

    y, _, _, _ = rollout_adaptive_train_vf(apply, t(x), E_STEPS, E_K)
    y.sum().backward()
    # Sample 1 (3 frames a call): its first block's 4th frame is overwritten.
    g0 = frames_seen[0].grad
    assert torch.all(g0[1, :3] == 1) and torch.all(g0[1, 3] == 0)
    # Sample 0 (2 a call) keeps frames 0-1 of each of its three blocks.
    assert torch.all(g0[0, :2] == 1) and torch.all(g0[0, 2:] == 0)


def test_remat_replays_the_dropout_generator():
    """remat on equals remat off, also when the model draws dropout masks
    from the caller's generator: the recompute replays it."""
    x, wm, v, g, h = engine_inputs(4)
    out = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(11)
        twm, tv = t(wm, True), t(v, True)
        y, rts, act, _ = rollout_adaptive_train_vf(
            torch_model(twm, tv, E_K, gen), t(x), E_STEPS, E_K, remat=remat, rng=gen)
        (torch.sum(y * t(g)) + torch.sum(rts * act * t(h))).backward()
        out[remat] = (y.detach(), twm.grad, tv.grad, gen.get_state())
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    # And the masks were real: another seed gives another rollout.
    y2, _, _, _ = rollout_adaptive_train_vf(
        torch_model(t(wm), t(v), E_K, torch.Generator().manual_seed(12)), t(x), E_STEPS, E_K)
    assert not torch.allclose(y2, out[False][0])


# ---- R_Trainer steps, side by side --------------------------------------------

RES = (16, 24)
KW = dict(in_T=4, taylor_order=1, attn_axes="THW", embed_dim=32, patch_scale=8, n_head=4,
          mlp_ratio=1.0, output_length=1, deg=False, dropout=0.0)
LR, WD = 1e-3, 1e-2
# The interprator's head after surgery (``rt_head``): r_t of the two samples
# of ``step_batch`` at these centres, per out_T budget.
RT_TARGETS = {1.5: (1.2, 1.4), 4.0: (2.5, 3.5)}


def jax_model_and_params(seed=5):
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, RES), **KW)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, *RES, F), jnp.float32), 2.5)
    return jm, params


def step_batch(seed=0, n_out=6, b=2):
    """Two samples of very different amplitude, so their r_t can differ."""
    rng = np.random.default_rng(seed)
    scale = np.array([0.3, 2.0], np.float32)[:b].reshape(b, 1, 1, 1, 1)
    x = rng.normal(size=(b, 4, *RES, F)).astype(np.float32) * scale
    y = x[:, -1:] + 0.1 * rng.normal(size=(b, n_out, *RES, F)).astype(np.float32)
    return x, y


def interprator_hidden(params, x, out_t):
    """What the interprator's last Dense sees in the first model call
    (B, L, C/4), read from the port's model by a forward hook."""
    tm = TANTE(dset_metadata=metadata(TanteMetadata, RES), device="cpu", **KW)
    load_jax_params(tm, flatten(params))
    seen = []
    tm.interprators_0.TorchDense_1.register_forward_hook(lambda m, a, out: seen.append(out))
    with torch.no_grad():
        tm.eval()(torch.from_numpy(x), out_t)
    return torch.relu(seen[0]).numpy()


def rt_head(params, x, out_t, encoder_gain=30.0):
    """Surgery for per-sample r_t: the encoder's last kernel scaled by
    ``encoder_gain`` (at init the latent is mostly position embedding, so
    every sample's r_t would be alike), then the interprator's last Dense set
    to a * u, bias c, so that the two samples' first r_t land at
    ``RT_TARGETS[out_t]``, solved from their mean hidden activations along
    u, the difference of those means."""
    flat = flatten(params)
    last = [k for k in flat if k.startswith("encoder/") and k.endswith("kernel")][-1]
    flat[last] = flat[last] * encoder_gain
    h = interprator_hidden({"params": unflatten(flat)}, x, out_t)
    u = h[1].mean(axis=0) - h[0].mean(axis=0)
    m = (h @ u).mean(axis=1)  # per sample
    lo, hi = RT_TARGETS[out_t]
    a = (hi - lo) / (m[1] - m[0])
    flat["interprators_0/TorchDense_2/Dense_0/kernel"] = (a * u)[:, None].astype(np.float32)
    flat["interprators_0/TorchDense_2/Dense_0/bias"] = np.full(
        (1,), lo - 1.001 - a * m[0], np.float32)
    return {"params": unflatten(flat)}


def unflatten(flat):
    from flax import traverse_util

    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


class CaptureGrads:
    """An optax transformation that records the gradients it is handed (the
    raw gradients: the clip comes after it) and passes them on."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, p):
        return self.tx.init(p)

    def update(self, g, state, params=None):
        jax.debug.callback(lambda gg: self.grads.append(gg), g)
        return self.tx.update(g, state, params)


def side_by_side(tmp_path, params_j, jm, rkw, batches):
    """The JAX and the port's R_Trainer from one parameter tree and one AdamW
    state (count 5, random moments) through ``batches``; per step both
    losses, r_t statistics, raw gradients and parameter updates."""
    md_j = metadata(JaxMetadata, RES)
    n_out = batches[0][1].shape[1]
    jdm = SimpleNamespace(train_dataset=SimpleNamespace(metadata=md_j, n_steps_input=4),
                          train_dataloader=lambda: [None])
    common = dict(max_epoch=1, n_steps_output=n_out, n_steps_rollout=3, seed=0, **rkw)
    jt = JaxRTrainer(str(tmp_path / "jax"), "channels_last_default", jm, jdm,
                     JaxAdamW(lr=LR, weight_decay=WD), jmetrics.MSE(), jmetrics.L2RE(), **common)
    jt.params = params_j
    flat0 = flatten(params_j)
    rng = np.random.default_rng(9)
    mu = {k: (1e-2 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat0.items()}
    nu = {k: (1e-4 * rng.uniform(0.5, 1.5, size=v.shape)).astype(np.float32)
          for k, v in flat0.items()}
    jt.tx = CaptureGrads(jt.tx)
    jt.opt_state = jax.tree_util.tree_map(
        lambda n: n._replace(count=jnp.asarray(5, jnp.int32), mu=unflatten(mu), nu=unflatten(nu))
        if isinstance(n, optax.ScaleByAdamState) else n,
        jt.tx.init(params_j["params"]), is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
    jt._train_step = jt._build_train_step()

    tdm = WaveDataModule(batch_size=2, n_steps_input=4, n_steps_output=n_out, device="cpu",
                         waves=dict(resolution=RES, n_trajectories=2, n_steps=12, seed=0,
                                    with_pressure=True))
    tm = TANTE(dset_metadata=metadata(TanteMetadata, RES), device="cpu", **KW)
    load_jax_params(tm, flat0)
    tt = R_Trainer(str(tmp_path / "torch"), "channels_last_default", tm, tdm,
                   AdamW(lr=LR, weight_decay=WD), tmetrics.MSE(), tmetrics.L2RE(), device="cpu",
                   **common)
    load_optax_adam_state(tt.optimizer, tm, 5, mu, nu)
    raw = {}
    clip = tt._clip

    def capture_clip(params):
        raw.clear()
        raw.update({k.replace(".", "/"): p.grad.clone() for k, p in tm.named_parameters()})
        return clip(params)

    tt._clip = capture_clip
    steps = []
    for x, y in batches:
        before = jax_params_from_state_dict(tm.state_dict())
        jold = flatten(jt.params)
        jt.params, jt.opt_state, jl, jrt, jvar, jcalls = jt._train_step(
            jt.params, jt.opt_state, jnp.asarray(x), jnp.asarray(y), jt._next_dropout_key())
        loss, rt, var, calls = tt.train_step(torch.from_numpy(x), torch.from_numpy(y))
        after, jnew = jax_params_from_state_dict(tm.state_dict()), flatten(jt.params)
        steps.append(dict(
            torch=(float(loss), float(rt), float(var), float(calls)),
            jax=(float(jl), float(jrt), float(jvar), float(jcalls)),
            grads=(dict(raw), flatten({"params": jt.tx.grads[-1]})),
            updates=({k: after[k] - before[k] for k in before},
                     {k: jnew[k] - jold[k] for k in jold}),
            params=before))
    return steps, tt


def rts_of(params_j, jm, x, out_t, n_steps):
    """Every r_t the JAX engine logs for this batch at these weights."""
    apply = lambda w: jm.apply(params_j, w, out_t)  # noqa: E731
    if out_t >= 2:
        _, rts, act, _ = jroll.rollout_adaptive_train_vf(apply, jnp.asarray(x), n_steps,
                                                          int(out_t))
        return np.asarray(rts)[np.asarray(act)], np.asarray(act)
    _, rts = jroll.rollout_adaptive_train(apply, jnp.asarray(x), n_steps)
    return np.asarray(rts).ravel(), None


RKW = {
    "one_frame": dict(),
    "vf_growth": dict(train_out_T=4.0, rt_band_hi=4.0, rt_eps=3.0, rt_supervision=0.05),
    "vf_abs": dict(train_out_T=4.0, rt_band_hi=4.0, rt_eps=3.0, rt_supervision=0.05,
                   rt_sup_mode="abs", rt_sup_tau=0.02),
}


@pytest.mark.parametrize("case", sorted(RKW))
def test_r_trainer_steps_match_jax(case, tmp_path):
    rkw = RKW[case]
    out_t = rkw.get("train_out_T", 1.5)
    jm, params = jax_model_and_params()
    batches = [step_batch(s) for s in (0, 1)]
    params = rt_head(params, batches[0][0], out_t)
    # The weights are chosen so that no r_t sits near an integer (where the
    # two packages' roundings could floor it differently) and, in the
    # variable-frame engine, the two samples consume different counts.
    for x, _ in batches:
        rts, act = rts_of(params, jm, x, out_t, 6)
        assert np.min(np.abs(rts - np.round(rts))) >= 0.05, rts
        if act is not None:
            assert act[:, 0].sum() != act[:, 1].sum(), act
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the one-frame case's unreachable band
        steps, tt = side_by_side(tmp_path, params, jm, rkw, batches)
    for n, s in enumerate(steps):
        # Loss, r_t mean / spread and calls: f32 rollouts of six model calls,
        # summed in another order: 1e-4.
        np.testing.assert_allclose(s["torch"], s["jax"], rtol=1e-4, atol=1e-7, err_msg=n)
        got, want = s["grads"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                       atol=1e-4 * np.abs(want[k]).max() + 1e-9, err_msg=k)
        # Updates: the random moments dominate the Adam step, so it is well
        # conditioned; 1e-4 of the largest update of the tensor, plus one f32
        # spacing of the parameter (an update is a difference of two f32
        # parameters: near 1, a LayerNorm scale's resolves 1.2e-7).
        got, want, params = *s["updates"], s["params"]
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-4 * np.abs(want[k]).max() + np.spacing(np.abs(params[k]).max()),
                err_msg=k)
    if out_t >= 2:
        assert steps[0]["torch"][3] < 6  # slots were skipped: fewer real calls
        assert tt.gradient_checkpointing
