"""Tensor-parallel shards narrower than a head group, on the CPU.

At tp 8 the 128-wide channel block (8 heads of 16, MLP ratio 1) splits into
16-wide shards: one head of 16 and a 16-column MLP shard a rank.  The halves'
kernels run 64-column head groups and passes, so the wrappers re-lay such a
shard zero-padded to one group (``fused_block.half_weights``,
``half_long_weights``): its live columns as they are, three zero heads in
the attention half (zero q|k|v columns and biases, zero out-projection
rows) and 48 zero hidden columns in the MLP half (zero fc1 columns and
bias, zero fc2 rows).  Here the re-laid weights are read back as the kernels
read them (bf16 core-matrix slabs, f32 fragment-order slabs) and held to
the unpadded shard; then the halves they describe, with the padding,
against JAX's ``_xla_attn_half`` / ``_xla_mlp_half`` on the same shard, and
the eight shards recombined against the unsplit block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_params, to_torch, unarrange_weight
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.parallel.sharding import shard_block
from test_torch_f32_halves import unarrange_f32
from test_torch_half_tiles import relaid_attn_half, relaid_mlp_half

C, HEADS, TP = 128, 8, 8  # the channel block at tp 8: 16-wide shards
QS = (C // HEADS) ** -0.5 * tblock.LOG2E  # q's prescale, folded into the slabs


def shards(seed=0):
    p = to_torch(block_params(C, C, seed=seed))
    out = []
    for r in range(TP):
        ps = shard_block(p, TP, r)
        out.append((tblock.AttnHalfParams(*(getattr(ps, f) for f in tblock.AttnHalfParams._fields)),
                    tblock.MlpHalfParams(*(getattr(ps, f) for f in tblock.MlpHalfParams._fields))))
    return p, out


def unarrange(dtype):
    return unarrange_f32 if dtype == torch.float32 else unarrange_weight


def test_the_channel_block_at_tp_8_is_sixteen_wide():
    _, sh = shards()
    for ap, mp in sh:
        assert ap.wq.shape == (C, 16) and ap.wo.shape == (16, C)
        assert mp.w1.shape == (C, 16) and mp.w2.shape == (16, C)
    assert tblock.tp_fusable(C, HEADS, C, TP)


@pytest.mark.parametrize("long", [False, True], ids=["short", "long"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_padded_attention_shard_keeps_its_columns_and_zeros_the_rest(dtype, long):
    """q|k|v of the one group: the live 16 columns of wq (prescaled), wk, wv
    and their biases as the shard's, columns 16-63 of each zero; the
    out-projection's rows 0-15 the shard's wo, rows 16-63 zero."""
    _, sh = shards(1)
    for r, (ap, _) in enumerate(sh):
        ap = tblock.AttnHalfParams(*(t.to(dtype) for t in ap))
        if long:
            plan = tblock.half_long_plan(C, 16, 1, dtype)
            w = tblock.half_long_weights(ap, 1, plan)
        else:
            plan = tblock.half_plan("attn", 16, C, 16, dtype)
            w = tblock.half_weights(ap, plan, 1)
        assert plan.width == 64
        qkv = unarrange(dtype)(w.slabs[:C * 192], C, 192, plan.np[0]).float()
        wq = (ap.wq * QS).float()  # rounded once in the dtype, as the wrapper folds it
        for o, live in ((0, wq), (64, ap.wk.float()), (128, ap.wv.float())):
            assert torch.equal(qkv[:, o:o + 16], live), (r, o)
            assert not qkv[:, o + 16:o + 64].any(), (r, o)
        bq = (ap.bq * QS).float()
        for o, live in ((0, bq), (64, ap.bk.float()), (128, ap.bv.float())):
            assert torch.equal(w.bias[o:o + 16].float(), live)
            assert not w.bias[o + 16:o + 64].any()
        wo = unarrange(dtype)(w.slabs[C * 192:], 64, C, plan.np[1]).float()
        assert torch.equal(wo[:16], ap.wo.float()) and not wo[16:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_padded_mlp_shard_keeps_its_columns_and_zeros_the_rest(dtype):
    """fc1's 16 live columns and bias as the shard's, 48 zero columns and a
    zero bias past them; fc2's 16 live rows, 48 zero rows."""
    _, sh = shards(2)
    for _, mp in sh:
        mp = tblock.MlpHalfParams(*(t.to(dtype) for t in mp))
        plan = tblock.half_plan("mlp", 1, C, 16, dtype)
        w = tblock.half_weights(mp, plan)
        assert plan.width == 64
        w1 = unarrange(dtype)(w.slabs[:C * 64], C, 64, plan.np[0])
        assert torch.equal(w1[:, :16], mp.w1) and not w1[:, 16:].any()
        assert torch.equal(w.bias[:16], mp.b1) and not w.bias[16:].any()
        w2 = unarrange(dtype)(w.slabs[C * 64:], 64, C, plan.np[1])
        assert torch.equal(w2[:16], mp.w2) and not w2[16:].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [16, 48])
def test_padded_halves_compute_the_jax_halves(l, causal):
    """The halves as the kernels compute them from the padded f32 re-layout
    (``test_torch_half_tiles.relaid_*``) against JAX's plain halves on each
    16-wide shard, within 1e-5."""
    _, sh = shards(3)
    x = np.random.default_rng(l).normal(size=(4, l, C)).astype(np.float32)
    xt = torch.from_numpy(x)
    for ap, mp in sh:
        plan = tblock.half_plan("attn", l, C, 16)
        got = relaid_attn_half(xt, tblock.half_weights(ap, plan, 1), plan, 16, l, 1, causal, "fast")
        ja = jblock.AttnHalfParams(*(jnp.asarray(t.numpy()) for t in ap))
        want = np.asarray(jblock._xla_attn_half(jnp.asarray(x), ja, l, 1, causal))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        plan = tblock.half_plan("mlp", 1, C, 16)
        got = relaid_mlp_half(xt, tblock.half_weights(mp, plan), plan)
        jm = jblock.MlpHalfParams(*(jnp.asarray(t.numpy()) for t in mp))
        want = np.asarray(jblock._xla_mlp_half(jnp.asarray(x), jm))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("l", [16, 256])
def test_eight_shards_recombine_into_the_block(l):
    """The eight shards' plain halves summed, + bo and residual, then the MLP
    halves summed, + b2 and residual (``fused_block_apply_tp``'s order)
    against the unsplit block, f32, within 1e-5."""
    p, sh = shards(4)
    x = torch.from_numpy(np.random.default_rng(l + 1).normal(size=(3, l, C)).astype(np.float32))
    attn = sum(tblock.attn_half_ref(x, ap, l, 1, True) for ap, _ in sh)
    xm = x + attn + p.bo
    y = xm + sum(tblock.mlp_half_ref(xm, mp) for _, mp in sh) + p.b2
    torch.testing.assert_close(y, tblock.block_ref(x, p, l, HEADS, True), atol=1e-5, rtol=1e-5)
