"""Port parity: AViT (``tante_tpu_torch/models/avit.py``) against the JAX
package, f32 on the CPU: every part (norms, T5 buckets, position biases, the
attention helper, both blocks, the hMLP stem and head) at 1e-5 / 1e-4, a
2-block AViT at 32x64 (the geometry of ``tests/test_model_transplant.py``:
at a 1x2 patch grid the RMS instance norm's std over 2 elements amplifies
rounding), the reference's own AViT state_dict
(``tests/fixtures/transplant.npz``, ``avit.*``) reproducing ``avit.y`` at
1e-4, and ``Predictor.rollout`` against the JAX ``rollout_fixed``.  Port
only: drop path and gradient checkpointing with one generator, and
``Trainer(enable_amp=True)`` refusing a model without a compute dtype, as
``model.clone(dtype=...)`` refuses it in JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flatten, metadata, transplant
from test_model_transplant import FIXTURES, _nhwc, avit_params, sd_of
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models import avit as javit
from tante_tpu.train.rollout import rollout_fixed as jax_rollout_fixed
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models import avit as tavit
from tante_tpu_torch.ops import fused_attention as fa
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.train import metrics as tmetrics
from tante_tpu_torch.train.evaler import Evaler
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.trainer import Trainer

ATOL = RTOL = 1e-4
T, H, W, F = 4, 32, 64, 3
KW = dict(in_T=T, out_steps=4, patch_size=(16, 16), embed_dim=32, num_heads=4,
          processor_blocks=2, drop_path=0.0)


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=rtol)


def run(params, jm, tm, *args, **kw):
    want = jm.apply(params, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
                    **kw)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    return got, want


def avit_pair(seed=0):
    jm = javit.AViT(dset_metadata=metadata(JaxMetadata, (H, W)), **KW)
    tm = tavit.AViT(dset_metadata=metadata(TanteMetadata, (H, W)), device="cpu", **KW)
    x = rand(seed, 2, T, H, W, 4)
    params, tm = transplant(jm, tm, x, seed=seed)
    return jm, params, tm, x


# ---- parts --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["RMSInstanceNorm", "InstanceNorm"])
def test_instance_norms_match_jax(name):
    x = rand(1, 2, 3, 6, 5, 8)
    params, tm = transplant(getattr(javit, name)(8), getattr(tavit, name)(8), x, seed=1)
    got, want = run(params, getattr(javit, name)(8), tm, x)
    close(got, want, atol=1e-5, rtol=1e-5)


def test_t5_buckets_and_position_biases_match_jax():
    rel = np.arange(-300, 301, dtype=np.int32)
    want = javit.t5_relative_position_bucket(jnp.asarray(rel))
    got = tavit.t5_relative_position_bucket(torch.from_numpy(rel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for jcls, tcls, args in ((javit.RelativePositionBias, tavit.RelativePositionBias, (6, 6)),
                             (javit.ContinuousPositionBias1D, tavit.ContinuousPositionBias1D,
                              (5, 5))):
        params, tm = transplant(jcls(n_heads=4), tcls(4, gen=torch.Generator()), *args)
        got, want = run(params, jcls(n_heads=4), tm, *args)
        assert got.shape == (1, 4, args[0], args[0])
        close(got, want, atol=1e-5, rtol=1e-5)


def test_heads_attention_matches_jax():
    q, k, v = (rand(i, 3, 6, 4, 8) for i in range(3))  # (B, L, heads, D)
    bias = rand(3, 1, 4, 6, 6)
    for b in (None, bias):  # packed (4 * 6 <= 128) / plain with the bias
        want = javit._heads_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      None if b is None else jnp.asarray(b))
        got = tavit._heads_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     None if b is None else torch.from_numpy(b))
        close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["TemporalAttentionBlock", "AxialAttentionBlock"])
def test_space_time_blocks_match_jax(name, monkeypatch):
    x = rand(4, 2, T, 4, 6, 32) if name.startswith("Temporal") else rand(4, 3, 4, 6, 32)
    jm = getattr(javit, name)(32, 4)
    params, tm = transplant(jm, getattr(tavit, name)(32, 4, gen=torch.Generator()), x, seed=2)
    calls = []
    real = fa.packed_attention_ref
    monkeypatch.setattr(fa, "packed_attention_ref", lambda *a: calls.append(1) or real(*a))
    got, want = run(params, jm, tm, x)
    close(got, want)
    # The row and the column attention go through the packed core; the
    # temporal one (position bias) does not.
    assert len(calls) == (0 if name.startswith("Temporal") else 2)


def test_hmlp_stem_and_head_match_jax():
    x = rand(5, 3, 32, 64, 8)
    params, tm = transplant(javit.HMLPStem(32), tavit.HMLPStem(8, 32, gen=torch.Generator()), x,
                            seed=3)
    got, want = run(params, javit.HMLPStem(32), tm, x)
    assert got.shape == (3, 2, 4, 32)
    close(got, want)
    z = rand(6, 3, 2, 4, 32)
    params, tm = transplant(javit.HMLPOutput(5, 32), tavit.HMLPOutput(5, 32,
                                                                       gen=torch.Generator()),
                            z, seed=4)
    got, want = run(params, javit.HMLPOutput(5, 32), tm, z)
    assert got.shape == (3, 32, 64, 5)
    close(got, want)


# ---- the model ----------------------------------------------------------------------


def test_avit_matches_jax():
    jm, params, tm, x = avit_pair()
    got, want = run(params, jm, tm, x)
    assert got.shape == (2, 4, H, W, 4)
    close(got, want)


def test_reference_avit_state_dict_loads_into_the_port():
    """The reference's own torch state_dict mapped by the layout rules of
    tests/test_model_transplant.py (no tree of ours in between)."""
    fx = np.load(FIXTURES)
    md = metadata(TanteMetadata, (H, W))
    md.n_fields = F
    tm = tavit.AViT(dset_metadata=md, device="cpu", **KW)
    load_jax_params(tm, flatten({"params": avit_params(sd_of(fx, "avit"), n_blocks=2)}))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(_nhwc(fx["avit.x"])))
    close(got, _nhwc(fx["avit.y"]), rtol=0)


def test_predictor_rollout_matches_jax_rollout_fixed():
    jm, params, tm, x = avit_pair(seed=7)
    want = jax_rollout_fixed(lambda w: jm.apply(params, w), jnp.asarray(x), 6, 4)
    got = Predictor(tm, device="cpu").rollout(x, 6)
    assert got.shape == (2, 6, H, W, 4)
    close(got, want)


def test_drop_path_and_gradient_checkpointing_share_one_generator():
    """Drop path draws per-sample masks from the caller's generator; with
    gradient checkpointing the recompute draws the same masks again, so
    loss and gradients equal those of the plain model."""
    md = metadata(TanteMetadata, (H, W))
    kw = {**KW, "drop_path": 0.5}
    x = torch.from_numpy(rand(8, 4, T, H, W, 4))
    out = []
    for ckpt in (False, True):
        tm = tavit.AViT(dset_metadata=md, device="cpu", gradient_checkpointing=ckpt, **kw)
        gen = torch.Generator().manual_seed(3)
        loss = (tm(x, deterministic=False, generator=gen) ** 2).mean()
        loss.backward()
        grads = [p.grad for p in tm.parameters() if p.grad is not None]  # RMS biases: unused
        out.append((loss.detach(), grads, gen.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert torch.equal(out[0][2], out[1][2])  # the stream continues where it would have
    with torch.no_grad():
        assert not torch.allclose(tm(x, deterministic=False, generator=gen), tm(x))
    with pytest.raises(ValueError, match="Generator"):
        tm(x, deterministic=False)


def test_amp_refuses_a_model_without_compute_dtype(tmp_path):
    with pytest.raises(TypeError):
        javit.AViT(**KW).clone(dtype=jnp.bfloat16)
    dm = WaveDataModule(batch_size=2, n_steps_input=T, n_steps_output=4, eval_steps_output=4,
                        data_workers=1, seed=0, device="cpu",
                        waves=dict(resolution=(H, W), n_trajectories=1, n_steps=10, seed=0))
    model = tavit.AViT(dset_metadata=dm.train_dataset.metadata, device="cpu", **KW)
    with pytest.raises(TypeError, match="compute dtype"):
        Trainer(str(tmp_path), "channels_last_default", model, dm, AdamW(lr=1e-3),
                tmetrics.MSE(), tmetrics.L2RE(), max_epoch=1, enable_amp=True, device="cpu")
    with pytest.raises(TypeError, match="compute dtype"):
        Evaler(str(tmp_path), "channels_last_default", model, dm,
               *(getattr(tmetrics, n)() for n in ("MSE", "L2RE", "NNMSE", "VRMSE")),
               enable_amp=True, device="cpu")
    assert all(m.dtype == torch.float32 for m in model.modules() if hasattr(m, "dtype"))
    # In f32 the Trainer steps AViT with drop path from its own generator.
    tr = Trainer(str(tmp_path), "channels_last_default",
                 tavit.AViT(dset_metadata=dm.train_dataset.metadata, device="cpu",
                            **{**KW, "drop_path": 0.2}),
                 dm, AdamW(lr=1e-3), tmetrics.MSE(), tmetrics.L2RE(), max_epoch=1,
                 n_steps_output=4, device="cpu")
    (x,), y = tr.formatter.process_input(next(iter(dm.train_dataloader())))
    assert np.isfinite(float(tr.train_step(x, y)))
