"""The Python side of the Hopper tensor-parallel halves, on the CPU
(``ops/fused_block.py``: ``half_plan``, ``half_weights``, the re-layout
cache): the kernel cannot run here, so what it is handed is checked.

The re-laid shard weights are read back the way the kernel reads them
(``unarrange_weight``: a pass's slabs in K order, each in wgmma's core-matrix
layout), per 64-column head group and through the zero padding of a shard
narrower than a group, and the half computed from them in f32 with the
kernel's own softmax forms (scores in log2 units, ``exp2``) must equal
``attn_half_ref`` / ``mlp_half_ref`` and the JAX package's
``_xla_attn_half`` / ``_xla_mlp_half`` on the same shard at 1e-5 (f32 sums in
another order).  The shards come from ``parallel/sharding.py:shard_block``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_params, to_torch, unarrange_weight
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.ops.activations import gelu_tanh_f32
from tante_tpu_torch.parallel.collectives import _CopyToTP
from tante_tpu_torch.parallel.sharding import shard_block

ATOL = RTOL = 1e-5
CLAMP = 60.0 * tblock.LOG2E  # the "fast" softmax's clamp, in log2 units


def halves(p):
    return (tblock.AttnHalfParams(*(getattr(p, f) for f in tblock.AttnHalfParams._fields)),
            tblock.MlpHalfParams(*(getattr(p, f) for f in tblock.MlpHalfParams._fields)))


def relaid_attn_half(x, w: tblock.HalfWeights, plan, ca, l, heads, causal, softmax):
    """The attention half as the kernel computes it from its re-laid
    weights (f32): per head group one (C, 192) q|k|v projection, attention
    in log2 units per head of the group, then the (W, C) out-projection."""
    s, _, c = x.shape
    d = ca // heads
    xn = tblock.ln(x, w.ln_scale, w.ln_bias)
    groups, per_group = plan.width // 64, c * tblock.SM90_QKV_N
    ao = []
    for g in range(groups):
        wg = unarrange_weight(w.slabs[g * per_group:(g + 1) * per_group], c, 192, plan.np[0])
        qkv = xn @ wg + w.bias[192 * g:192 * g + 192]
        for j in range(64 // d):
            q, k, v = (qkv[..., o + j * d:o + (j + 1) * d] for o in (0, 64, 128))
            sc = q @ k.transpose(-1, -2)  # (S, L, L), log2 units
            keep = torch.ones(l, l, dtype=torch.bool)
            if causal:
                keep = torch.tril(keep)
            if softmax == "safe":
                e = torch.exp2(sc - sc.masked_fill(~keep, -1e30).amax(-1, keepdim=True))
            else:
                e = torch.exp2(torch.clamp(sc, max=CLAMP))
            e = e.masked_fill(~keep, 0.0)
            ao.append((e @ v) / (e.sum(-1, keepdim=True) + 1e-30))
    ao = torch.cat(ao, dim=-1)
    wo = unarrange_weight(w.slabs[groups * per_group:], plan.width, c, plan.np[1])
    return ao @ wo


def relaid_mlp_half(x, w: tblock.HalfWeights, plan):
    c = x.shape[-1]
    w1 = unarrange_weight(w.slabs[:c * plan.width], c, plan.width, plan.np[0])
    w2 = unarrange_weight(w.slabs[c * plan.width:], plan.width, c, plan.np[1])
    h = gelu_tanh_f32(tblock.ln(x, w.ln_scale, w.ln_bias) @ w1 + w.bias)
    return h @ w2


# (C, hidden, heads, tp, L, causal): the flagship width at every tp the
# 8 heads split into (tp 8: 32-wide shards, zero-padded to one group),
# C = 128 with hidden 256 (tp 4: a 32-wide attention shard, 64-wide MLP),
# and the channel block's width at tp 8 (16-wide shards: one head of 16).
HALF_CASES = [
    (256, 256, 8, 1, 16, False),
    (256, 256, 8, 2, 16, False),
    (256, 256, 8, 2, 4, True),
    (256, 256, 8, 4, 48, False),
    (256, 256, 8, 8, 4, True),
    (128, 256, 4, 2, 16, True),
    (128, 256, 4, 4, 8, False),
    (128, 128, 8, 8, 16, True),
]


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("c,hidden,heads,tp,l,causal", HALF_CASES)
def test_relaid_half_weights_compute_the_half(c, hidden, heads, tp, l, causal, softmax):
    p = block_params(c, hidden, seed=c + tp + l)
    x = np.random.default_rng(tp + l).normal(size=(5, l, c)).astype(np.float32)
    xt = torch.from_numpy(x)
    local = heads // tp
    for r in range(tp):
        ap, mp = halves(shard_block(to_torch(p), tp, r))
        ca, hl = ap.wq.shape[-1], mp.w1.shape[-1]
        ja = jblock.AttnHalfParams(*(jnp.asarray(t.numpy()) for t in ap))
        jm = jblock.MlpHalfParams(*(jnp.asarray(t.numpy()) for t in mp))

        plan = tblock.half_plan("attn", l, c, ca)
        w = tblock.half_weights(ap, plan, local)
        assert plan.width % 64 == 0 and 0 <= plan.width - ca < 64
        got = relaid_attn_half(xt, w, plan, ca, l, local, causal, softmax)
        want = tblock.attn_half_ref(xt, ap, l, local, causal)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jblock._xla_attn_half(jnp.asarray(x), ja, l, local, causal)),
            atol=ATOL, rtol=RTOL)
        # The padding the kernel relies on: zero q|k|v columns and biases
        # past the shard, zero out-projection rows.
        last = unarrange_weight(w.slabs[(plan.width // 64 - 1) * c * 192:][:c * 192], c, 192, 192)
        pad = plan.width - ca
        if pad:
            for o in (0, 64, 128):
                assert not last[:, o + 64 - pad:o + 64].any()
                assert not w.bias[-192 + o + 64 - pad:len(w.bias) - 128 + o].any()
        wo = unarrange_weight(w.slabs[plan.width // 64 * c * 192:], plan.width, c, plan.np[1])
        assert torch.equal(wo[:ca], ap.wo) and not wo[ca:].any()

        plan = tblock.half_plan("mlp", 1, c, hl)
        w = tblock.half_weights(mp, plan)
        got = relaid_mlp_half(xt, w, plan)
        torch.testing.assert_close(got, tblock.mlp_half_ref(xt, mp), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jblock._xla_mlp_half(jnp.asarray(x), jm)), atol=ATOL,
            rtol=RTOL)
        w2 = unarrange_weight(w.slabs[c * plan.width:], plan.width, c, plan.np[1])
        assert torch.equal(w2[:hl], mp.w2) and not w2[hl:].any() and not w.bias[hl:].any()


class _Group:
    """A stand-in process group: ``_CopyToTP.forward`` only keeps it."""


def test_halves_relay_once_per_weight_version_through_copy_to_tp_views():
    """``fused_block_apply_tp`` hands each half new ``copy_to_tp`` views of
    the LayerNorm parameters on every call; the re-layout is cached under
    their base, so it is made once per weight version."""
    p = to_torch(block_params(256, 256, seed=3))
    shard = tblock.BlockParams(*(t.to(torch.bfloat16) for t in shard_block(p, 2, 1)))
    g = _Group()
    plan_a = tblock.half_plan("attn", 16, 256, 128)
    plan_m = tblock.half_plan("mlp", 1, 256, 128)

    def call():
        ap = tblock.AttnHalfParams(_CopyToTP.apply(shard.ln1_scale, g),
                                   _CopyToTP.apply(shard.ln1_bias, g), shard.wq, shard.bq,
                                   shard.wk, shard.bk, shard.wv, shard.bv, shard.wo)
        mp = tblock.MlpHalfParams(_CopyToTP.apply(shard.ln2_scale, g),
                                  _CopyToTP.apply(shard.ln2_bias, g), shard.w1, shard.b1,
                                  shard.w2)
        assert ap.ln1_scale is not shard.ln1_scale and ap.ln1_scale._base is shard.ln1_scale
        return tblock.half_weights(ap, plan_a, 4), tblock.half_weights(mp, plan_m)

    before = tblock.relaid_weights.count
    first = call()
    for _ in range(3):
        again = call()
        assert again[0] is first[0] and again[1] is first[1]
    assert tblock.relaid_weights.count == before + 2
    with torch.no_grad():  # an optimizer step: in place, a new version
        shard.wq.mul_(2.0)
        shard.ln2_scale.add_(1.0)
    second = call()
    assert second[0] is not first[0] and second[1] is not first[1]
    assert tblock.relaid_weights.count == before + 4
    assert call()[0] is second[0]
    qs = 32**-0.5 * tblock.LOG2E
    wq0 = unarrange_weight(second[0].slabs[:256 * 192], 256, 192, 192)[:, :64]
    assert torch.equal(wq0, shard.wq[:, :64] * qs)


@pytest.mark.parametrize("kind", ["attn", "mlp"])
def test_halves_relay_once_per_version_of_the_f32_parameters_they_are_cast_from(kind):
    """A Trainer keeps f32 parameters and casts them to bf16 on every call
    (``FusedTransformerBlock.block_params``, through ``cast_weight``); the
    re-layout is cached under the parameters, so the casts made per call,
    and ``copy_to_tp``'s views of them, do not re-lay it.  An optimizer
    step in place on a parameter re-lays it, from the new values."""
    master = [torch.nn.Parameter(t) for t in
              shard_block(to_torch(block_params(256, 256, seed=4)), 2, 0)]
    g = _Group()
    plan = tblock.half_plan(kind, 16 if kind == "attn" else 1, 256, 128)

    def call():
        p = tblock.BlockParams(*(tblock.cast_weight(t, torch.bfloat16) for t in master))
        assert p.wq is not master[2] and p.wq._cast_of is master[2]
        if kind == "attn":
            ap = tblock.AttnHalfParams(_CopyToTP.apply(p.ln1_scale, g),
                                       _CopyToTP.apply(p.ln1_bias, g), p.wq, p.bq, p.wk, p.bk,
                                       p.wv, p.bv, p.wo)
            return tblock.half_weights(ap, plan, 4), p
        mp = tblock.MlpHalfParams(_CopyToTP.apply(p.ln2_scale, g), _CopyToTP.apply(p.ln2_bias, g),
                                  p.w1, p.b1, p.w2)
        return tblock.half_weights(mp, plan), p

    before = tblock.relaid_weights.count
    first, _ = call()
    for _ in range(3):
        assert call()[0] is first
    assert tblock.relaid_weights.count == before + 1
    moved = master[2] if kind == "attn" else master[12]  # wq / w1
    with torch.no_grad():  # an optimizer step: in place on the f32 parameter
        moved.add_(0.5)
    second, p = call()
    assert second is not first and tblock.relaid_weights.count == before + 2
    assert call()[0] is second
    if kind == "attn":
        w = unarrange_weight(second.slabs[:256 * 192], 256, 192, 192)[:, :64]
        want = p.wq[:, :64] * (32**-0.5 * tblock.LOG2E)
    else:
        w = unarrange_weight(second.slabs[:256 * 128], 256, 128, plan.np[0])
        want = p.w1
    assert torch.equal(w, want)


def tile_rows(n_rows: int, per: int, grid: int) -> list:
    """The rows each CTA covers, in order: CTA i runs tiles i, i + grid, ...
    (``fused_half_sm90.cu``: a tile is ``per`` rows of whole sequences)."""
    tiles = -(-n_rows // per)
    return [r for cta in range(grid) for t in range(cta, tiles, grid)
            for r in range(t * per, min((t + 1) * per, n_rows))]


@pytest.mark.parametrize("kind,n_seqs,l", [("attn", 1536, 16), ("attn", 512, 48),
                                           ("attn", 6144, 4), ("attn", 37, 16), ("attn", 21, 3),
                                           ("attn", 10, 33), ("mlp", 24576, 1), ("mlp", 300, 1)])
def test_half_tiles_cover_every_row_once(kind, n_seqs, l):
    plan = tblock.half_plan(kind, l, 256, 128)
    per = plan.seqs * l
    assert per <= plan.rows and (kind == "mlp" or per % l == 0)
    tiles = -(-n_seqs // plan.seqs)
    for grid in (tiles, min(tiles, 132)):  # min(tiles, resident CTAs): one a SM of 132
        assert sorted(tile_rows(n_seqs * l, per, grid)) == list(range(n_seqs * l))
    if n_seqs * l == 24576:  # the flagship: 128-row tiles
        assert plan.rows == 128 and tiles in (192, 256)


def test_half_plan_keeps_the_whole_envelope_and_refuses_outside_it():
    """Every C and local width ``_check_half_x`` takes (C % 64 == 0, C <= 512,
    a multiple of 16 in [16, 2C]; the attention half's also <= C) has a plan
    within the shared memory, at every L up to 64."""
    for c in range(64, 513, 64):
        for local in range(16, 2 * c + 1, 16):
            cases = [("mlp", 1)] + [("attn", l) for l in (1, 3, 4, 16, 48, 64) if local <= c]
            for kind, l in cases:
                plan = tblock.half_plan(kind, l, c, local)
                assert plan is not None, (kind, l, c, local)
                assert tblock.half_smem(kind == "attn", plan.rows, c, plan.width, plan.np,
                                        plan.stages) <= tblock.SMEM_OPTIN
                assert plan.rows >= plan.seqs * l and plan.stages >= 2
                assert 0 <= plan.width - local < 64 and plan.width % 64 == 0
                assert plan.width % plan.np[0] == 0 or kind == "attn"
                assert c % plan.np[1] == 0 and plan.rows == (128 if c <= 256 else 64)
    for kind, l, c, local in [("attn", 65, 256, 128), ("attn", 0, 256, 128),
                              ("attn", 16, 256, 288), ("mlp", 1, 256, 544), ("mlp", 1, 256, 40),
                              ("mlp", 1, 256, 8), ("mlp", 1, 576, 128), ("mlp", 1, 96, 64),
                              ("attn", 16, 192, 0), ("mlp", 2, 256, 128)]:
        assert tblock.half_plan(kind, l, c, local) is None, (kind, l, c, local)
