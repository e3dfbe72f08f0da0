"""Port parity: the serving path's rollouts (``tante_tpu_torch.train.rollout``
and ``tante_tpu_torch.serve.Predictor``) against the JAX package, f32 on
the CPU, from one JAX init loaded through ``convert.py``.

n_calls and the per-call emission floor(r_t) must match exactly; r_t and
the frames to 1e-4 abs / 1e-4 rel (f32, another summation order,
compounded over the autoregressive steps)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from _torch_parity import frames, metadata, models
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.serve import Predictor as JaxPredictor
from tante_tpu.train import rollout as jroll
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.train import rollout as troll

ATOL = RTOL = 1e-4
# r_t = clip(2.6, 0, K - 1) + 1.001 = 3.601 -> 3 frames per call at K = 4.
RT_BIAS, K = 2.6, 4


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_rollout_tante_latent_matches_jax():
    jm, params, tm = models(True)
    x = frames(10)
    want = jroll.rollout_tante_latent(jm, params, jnp.asarray(x), 6)
    with torch.no_grad():
        got = troll.rollout_tante_latent(tm, torch.from_numpy(x), 6)
    assert got.shape == want.shape == (2, 6, 32, 64, 4)
    close(got, want)


@pytest.mark.parametrize("force_budget", [False, True])
def test_rollout_adaptive_eval_tante_matches_jax(force_budget):
    jm, params, tm = models(False, RT_BIAS)
    x = frames(11)
    want, want_rt, want_calls = jroll.rollout_adaptive_eval_tante(
        jm, params, jnp.asarray(x), 7, max_frames_per_call=K, force_budget=force_budget
    )
    with torch.no_grad():
        got, got_rt, got_calls = troll.rollout_adaptive_eval_tante(
            tm, torch.from_numpy(x), 7, max_frames_per_call=K, force_budget=force_budget
        )
    # 3 frames per call (r_t 3.6) -> 3 calls; the forced 4-frame blocks -> 2.
    assert got_calls == int(want_calls) == (2 if force_budget else 3)
    np.testing.assert_array_equal(np.isnan(got_rt.numpy()), np.isnan(np.asarray(want_rt)))
    close(got_rt.numpy()[:got_calls], np.asarray(want_rt)[:got_calls])
    close(got, want)


def test_generic_rollouts_match_jax():
    """The model-agnostic engines on a deterministic stand-in model."""
    x = frames(12)

    def fake(mod, k, rt):
        def fn(w):
            base = w.mean(1, keepdims=True)
            y = mod.concatenate([base * (1.0 + 0.1 * i) for i in range(k)], 1)
            return y if rt is None else (y, mod.full((w.shape[0],), rt))
        return fn

    got = troll.rollout_fixed(fake(torch, 2, None), torch.from_numpy(x), 5, 2)
    want = jroll.rollout_fixed(fake(jnp, 2, None), jnp.asarray(x), 5, 2)
    close(got, want)
    got, got_rt, got_calls = troll.rollout_adaptive_eval(
        fake(torch, 3, 2.5), torch.from_numpy(x), 7, max_frames_per_call=3)
    want, want_rt, want_calls = jroll.rollout_adaptive_eval(
        fake(jnp, 3, 2.5), jnp.asarray(x), 7, max_frames_per_call=3)
    assert got_calls == int(want_calls) == 4
    close(got, want)
    close(got_rt.numpy()[:4], np.asarray(want_rt)[:4])


def test_predictor_matches_jax():
    jm, params, tm = models(True)
    x = frames(13)
    got = Predictor(tm, device="cpu").rollout(x, 3)
    close(got, JaxPredictor(jm, params).rollout(x, 3))

    jm, params, tm = models(False, RT_BIAS)
    p = Predictor(tm, device="cpu")
    got, got_rt, got_calls = p.rollout_adaptive(x, 7, max_frames_per_call=K)
    want, want_rt, want_calls = jroll.rollout_adaptive_eval_tante(
        jm, params, jnp.asarray(x), 7, max_frames_per_call=K)
    assert got_calls == int(want_calls) == 3
    close(got_rt, np.asarray(want_rt)[:3])
    close(got, want)
    with pytest.raises(ValueError):
        Predictor(models(True)[2], device="cpu").rollout_adaptive(x, 2)


ASSET = Path(__file__).resolve().parents[1] / "tante_tpu" / "assets" / "tante_flagship.npz"


def test_trained_flagship_adaptive_rollout_matches_jax():
    """The whole slice at full width on the trained asset: flagship TANTE
    (embed 256, 8 heads, THWTHWTHW, 128x384, deg=False), B=1, K=8, 8 steps,
    f32 on both sides.  n_calls and the r_t log must match exactly."""
    flat = dict(np.load(ASSET))
    kw = dict(in_T=4, taylor_order=1, attn_axes="THWTHWTHW", embed_dim=256, patch_scale=8,
              n_head=8, mlp_ratio=1.0, output_length=1, deg=False)
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata, (128, 384)), **kw)
    params = {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                        for k, v in flat.items()})}
    tm = TANTE(dset_metadata=metadata(TanteMetadata, (128, 384)), device="cpu", **kw)
    x = wave_input()
    want, want_rt, want_calls = jax.jit(
        lambda p, x: jroll.rollout_adaptive_eval_tante(jm, p, x, 8, max_frames_per_call=8)
    )(params, jnp.asarray(x))
    got, got_rt, got_calls = Predictor.from_numpy(tm, flat, device="cpu").rollout_adaptive(
        x, 8, max_frames_per_call=8)
    want_rt = np.asarray(want_rt)[: int(want_calls)]
    assert got_calls == int(want_calls)
    # The emission decisions are identical; the r_t values agree to f32
    # rounding of two summation orders.
    np.testing.assert_array_equal(np.floor(got_rt), np.floor(want_rt))
    np.testing.assert_allclose(got_rt, want_rt, rtol=1e-5)
    assert got.shape == (1, 8, 128, 384, 4)
    close(got, want)


def wave_input():
    """One sample of ``bench.py:_wave_input`` (seed 7): the synthetic-waves
    fields the trained asset was trained on."""
    h, w, n = 128, 384, 4
    rng = np.random.default_rng(7)
    gx, gy = np.meshgrid(np.linspace(0, 2 * np.pi, h, endpoint=False),
                         np.linspace(0, 2 * np.pi, w, endpoint=False), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, size=(1, 1, 1, 1)).astype(np.float32)
    speed = rng.uniform(0.1, 0.3, size=(1, 1, 1, 1)).astype(np.float32)
    t = np.arange(n, dtype=np.float32).reshape(1, n, 1, 1)

    def wave(kx, ky, amp=1.0):
        return amp * np.sin(kx * gx + ky * gy + phase + speed * t).astype(np.float32)

    k1, k2 = (1, 2), (3, 1)
    return np.stack([wave(*k1) + 0.5 * wave(*k2), wave(*k2) + 0.25 * wave(*k1), wave(*k1),
                     wave(k1[1], k1[0], amp=0.7)], axis=-1)


def test_predictor_weight_cast_is_bit_identical():
    """Predictor stores a bf16 model's weights in bf16; every use casts
    them to bf16 anyway, so the rollout is bit-identical."""
    kw = dict(in_T=4, taylor_order=1, attn_axes="THWT", embed_dim=128, patch_scale=8,
              n_head=4, deg=False, dtype=torch.bfloat16, device="cpu", seed=1)
    md = metadata(TanteMetadata)
    x = torch.from_numpy(frames(14))
    with torch.no_grad():
        want = troll.rollout_adaptive_eval_tante(TANTE(dset_metadata=md, **kw), x, 3, 2)
    p = Predictor(TANTE(dset_metadata=md, **kw), device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in p.model.parameters())
    got, rt, calls = p.rollout_adaptive(x, 3, max_frames_per_call=2)
    assert calls == want[2]
    assert torch.equal(got, want[0])
    assert np.array_equal(rt, want[1][:calls].numpy())
