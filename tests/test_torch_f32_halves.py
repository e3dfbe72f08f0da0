"""The Python side of the f32 tensor-parallel halves, on the CPU
(``ops/fused_block.py``: ``half_plan`` and ``half_weights`` in f32, the
re-layout cache, the argument checks): the kernels
(``csrc/fused_half_sm90_f32.cu``) cannot run here, so what they are handed
is checked.

The re-laid f32 shard weights are read back the way the f32 body reads them
(slabs of 16 K rows x one column pass in mma.sync's B-fragment order, pass
after pass), per
64-column head group and through the zero padding of a shard narrower than a
group, and the half computed from them in f32 with the kernel's softmax
forms (scores in log2 units, ``exp2``) must equal ``attn_half_ref`` /
``mlp_half_ref`` and the JAX package's ``_xla_attn_half`` /
``_xla_mlp_half`` (``pallas_block.py:741``, ``:766``) in f32 on the same
shard at 1e-5 (f32 sums in another order).  The shards come from
``parallel/sharding.py:shard_block``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_params, to_torch
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.ops.activations import gelu_tanh_f32
from tante_tpu_torch.parallel.sharding import shard_block

ATOL = RTOL = 1e-5
CLAMP = 60.0 * tblock.LOG2E  # the "fast" softmax's clamp, in log2 units
F32 = torch.float32


def halves(p):
    return (tblock.AttnHalfParams(*(getattr(p, f) for f in tblock.AttnHalfParams._fields)),
            tblock.MlpHalfParams(*(getattr(p, f) for f in tblock.MlpHalfParams._fields)))


def unarrange_f32(flat, k, n, np_):
    """The (K, N) weight the f32 body reads: pass p, slab kc, 8-column tile
    j, lane 4g + t, element e at (((p * K/16 + kc) * np/8 + j) * 32 + 4g + t)
    * 4 + e holds row 16 kc + 4e + t, column p * np + 8j + g."""
    t = flat.reshape(n // np_, k // 16, np_ // 8, 8, 4, 4)  # pass, kc, j, g, t, e
    return t.permute(1, 5, 4, 0, 2, 3).reshape(k, n)


def relaid_attn_half(x, w: tblock.HalfWeights, plan, ca, l, heads, causal, softmax):
    """The attention half as the f32 kernel computes it from its re-laid
    weights: per head group one (C, 192) q|k|v pass, attention in log2 units
    per head of the group (normalised after the AV sum), then the (W, C)
    out-projection."""
    c = x.shape[-1]
    d = ca // heads
    xn = tblock.ln(x, w.ln_scale, w.ln_bias)
    groups, per_group = plan.width // 64, c * tblock.SM90_QKV_N
    ao = []
    for g in range(groups):
        wg = unarrange_f32(w.slabs[g * per_group:(g + 1) * per_group], c, 192, plan.np[0])
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
    wo = unarrange_f32(w.slabs[groups * per_group:], plan.width, c, plan.np[1])
    return ao @ wo


def relaid_mlp_half(x, w: tblock.HalfWeights, plan):
    c = x.shape[-1]
    w1 = unarrange_f32(w.slabs[:c * plan.width], c, plan.width, plan.np[0])
    w2 = unarrange_f32(w.slabs[c * plan.width:], plan.width, c, plan.np[1])
    h = gelu_tanh_f32(tblock.ln(x, w.ln_scale, w.ln_bias) @ w1 + w.bias)
    return h @ w2


# (C, hidden, heads, tp, L, causal): the flagship width (d = 32) at every tp
# its 8 heads split into (tp 8: 32-wide shards, zero-padded to one group),
# d = 64 (4 heads of C = 256) and d = 16 (8 heads of C = 128, hidden 2C: a
# 128-wide MLP shard at tp 2; at tp 4 a 32-wide attention shard of two heads).
HALF_CASES = [
    (256, 256, 8, 2, 16, False),
    (256, 256, 8, 2, 4, True),
    (256, 256, 8, 4, 48, False),
    (256, 256, 8, 8, 4, True),
    (256, 256, 4, 2, 32, True),
    (128, 256, 8, 2, 16, False),
    (128, 256, 8, 4, 8, True),
]


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("c,hidden,heads,tp,l,causal", HALF_CASES)
def test_relaid_f32_half_weights_compute_the_half(c, hidden, heads, tp, l, causal, softmax):
    p = block_params(c, hidden, seed=c + tp + l + heads)
    x = np.random.default_rng(tp + l).normal(size=(5, l, c)).astype(np.float32)
    xt = torch.from_numpy(x)
    local = heads // tp
    for r in range(tp):
        ap, mp = halves(shard_block(to_torch(p), tp, r))
        ca, hl = ap.wq.shape[-1], mp.w1.shape[-1]
        ja = jblock.AttnHalfParams(*(jnp.asarray(t.numpy()) for t in ap))
        jm = jblock.MlpHalfParams(*(jnp.asarray(t.numpy()) for t in mp))

        plan = tblock.half_plan("attn", l, c, ca, F32)
        w = tblock.half_weights(ap, plan, local)
        assert plan.f32 and w.slabs.dtype == F32 and w.bias.dtype == F32
        assert w.slabs.numel() == plan.width // 64 * c * 192 + plan.width * c
        got = relaid_attn_half(xt, w, plan, ca, l, local, causal, softmax)
        want = tblock.attn_half_ref(xt, ap, l, local, causal)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jblock._xla_attn_half(jnp.asarray(x), ja, l, local, causal)),
            atol=ATOL, rtol=RTOL)
        # What the kernel reads in each group: wq prescaled, wk, wv, exactly;
        # zero columns and biases past the shard, zero out-projection rows.
        qs = (ca // local) ** -0.5 * tblock.LOG2E
        for g in range(plan.width // 64):
            wg = unarrange_f32(w.slabs[g * c * 192:(g + 1) * c * 192], c, 192, 192)
            cols = slice(64 * g, min(64 * g + 64, ca))
            n = cols.stop - cols.start
            assert torch.equal(wg[:, :n], ap.wq[:, cols] * qs)
            assert torch.equal(wg[:, 64:64 + n], ap.wk[:, cols])
            assert torch.equal(wg[:, 128:128 + n], ap.wv[:, cols])
            for o in (0, 64, 128):
                assert not wg[:, o + n:o + 64].any()
                assert not w.bias[192 * g + o + n:192 * g + o + 64].any()
        wo = unarrange_f32(w.slabs[plan.width // 64 * c * 192:], plan.width, c, plan.np[1])
        assert torch.equal(wo[:ca], ap.wo) and not wo[ca:].any()

        plan = tblock.half_plan("mlp", 1, c, hl, F32)
        w = tblock.half_weights(mp, plan)
        got = relaid_mlp_half(xt, w, plan)
        torch.testing.assert_close(got, tblock.mlp_half_ref(xt, mp), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jblock._xla_mlp_half(jnp.asarray(x), jm)), atol=ATOL,
            rtol=RTOL)
        w1 = unarrange_f32(w.slabs[:c * plan.width], c, plan.width, plan.np[0])
        w2 = unarrange_f32(w.slabs[c * plan.width:], plan.width, c, plan.np[1])
        assert torch.equal(w1[:, :hl], mp.w1) and not w1[:, hl:].any()
        assert torch.equal(w2[:hl], mp.w2) and not w2[hl:].any() and not w.bias[hl:].any()


def test_f32_slab_rows_are_where_the_kernel_reads_them():
    """Lane 4g + t's float4 of 8-column tile j in slab kc of pass p holds
    rows 16 kc + {t, t + 4, 8 + t, 12 + t} of column p*np + 8j + g: the B
    fragments ``gemm_f32`` loads, for the out-projection of a 32-wide shard
    padded to 64 rows."""
    p = to_torch(block_params(256, 256, seed=7))
    ap, _ = halves(shard_block(p, 8, 3))
    plan = tblock.half_plan("attn", 16, 256, 32, F32)
    assert (plan.width, plan.np) == (64, (192, 128))
    w = tblock.half_weights(ap, plan, 1)
    wo = w.slabs[256 * 192:]  # one head group, then wo: 64 x 256 in passes of 128
    assert wo.numel() == 64 * 256
    padded = torch.cat([ap.wo, torch.zeros(32, 256)])
    for pss, kc, j, g, t in [(0, 0, 0, 0, 0), (0, 1, 3, 2, 1), (1, 1, 15, 7, 3),
                             (1, 3, 8, 4, 2)]:
        got = wo[((pss * 4 + kc) * 16 + j) * 128 + (4 * g + t) * 4:][:4]
        rows = [16 * kc + t, 16 * kc + t + 4, 16 * kc + 8 + t, 16 * kc + 12 + t]
        want = padded[rows, pss * 128 + 8 * j + g]
        assert torch.equal(got, want), (pss, kc, j, g, t)
        assert (kc < 2) == bool(want.any())  # rows 32..63 are the shard's zero padding


# ---- the f32 tile plans -------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("l", [4, 16, 32, 48])
def test_f32_plans_at_the_shipped_shapes(tp, l):
    """The flagship width (C = hidden = 256) at tp 2, 4, 8: 64-row tiles of
    whole sequences, the q|k|v pass 192 wide, the rest 128 or 64 wide."""
    a = tblock.half_plan("attn", l, 256, 256 // tp, F32)
    m = tblock.half_plan("mlp", 1, 256, 256 // tp, F32)
    width = max(64, 256 // tp)
    assert a == tblock.HalfPlan(64, 64 // l, width, (192, 128), a.stages, True)
    assert m == tblock.HalfPlan(64, 64, width, (128 if width % 128 == 0 else 64, 128), m.stages,
                                True)
    for kind, plan in (("attn", a), ("mlp", m)):
        smem = tblock.half_smem(kind == "attn", 64, 256, width, plan.np, plan.stages, F32)
        assert smem <= tblock.SMEM_OPTIN and plan.stages >= 3
        if plan.stages < tblock.SM90_MAX_STAGES:  # as many stages as fit
            assert tblock.half_smem(kind == "attn", 64, 256, width, plan.np, plan.stages + 1,
                                    F32) > tblock.SMEM_OPTIN


def test_f32_mlp_half_at_twice_c_fits():
    """The f32 MLP half reckoned at W = 2C: at C = 256 its hidden tile alone
    is 64 x 516 floats (~132 KB), and the plan still fits with stages."""
    plan = tblock.half_plan("mlp", 1, 256, 512, F32)
    assert plan is not None and plan.width == 512 and plan.np == (128, 128)
    assert 64 * (512 + 4) * 4 == 132096
    assert tblock.half_smem(False, 64, 256, 512, plan.np, plan.stages, F32) <= tblock.SMEM_OPTIN


def test_f32_half_plans_cover_c_up_to_256_and_refuse_wider():
    for c in range(64, 257, 64):
        for local in range(16, 2 * c + 1, 16):
            cases = [("mlp", 1)] + [("attn", l) for l in (1, 3, 4, 16, 48, 64) if local <= c]
            for kind, l in cases:
                plan = tblock.half_plan(kind, l, c, local, F32)
                assert plan is not None, (kind, l, c, local)
                assert tblock.half_smem(kind == "attn", plan.rows, c, plan.width, plan.np,
                                        plan.stages, F32) <= tblock.SMEM_OPTIN
                assert plan.rows == 64 and plan.seqs == 64 // l and plan.stages >= 2
                assert 0 <= plan.width - local < 64 and plan.width % 64 == 0
                # the f32 body's instantiations: q|k|v 192 wide, the rest 64 or 128
                assert plan.np[0] == (192 if kind == "attn" else plan.np[0])
                assert kind == "attn" or (plan.np[0] in (64, 128) and plan.width % plan.np[0] == 0)
                assert plan.np[1] in (64, 128) and c % plan.np[1] == 0
    for kind, l, c, local in [("attn", 16, 320, 160), ("attn", 16, 512, 256),
                              ("mlp", 1, 512, 256), ("mlp", 1, 384, 192), ("attn", 65, 256, 128),
                              ("attn", 16, 256, 288), ("mlp", 1, 256, 544), ("mlp", 1, 256, 40),
                              ("mlp", 2, 256, 128)]:
        assert tblock.half_plan(kind, l, c, local, F32) is None, (kind, l, c, local)


def parent_bf16_half_plan(kind, l, c, local):
    """The bf16 half plan as the tree before the f32 halves made it: 128-row
    tiles when C <= 256 (else 64), passes ``_pass_width``, as many stages as
    fit in bf16 (``fused_half_sm90.cu:half_layout``)."""
    attn = kind == "attn"
    if not (c % 64 == 0 and 0 < c <= 512 and local % 32 == 0
            and 32 <= local <= (c if attn else 2 * c) and 1 <= l <= (64 if attn else 1)):
        return None
    width = -(-local // 64) * 64
    pw = lambda n: n if n <= 192 else 128 if n % 128 == 0 else 64  # noqa: E731
    np_ = (192 if attn else pw(width), pw(c))
    rows = 128 if c <= 256 else 64
    for stages in (4, 3, 2):
        smem = (rows * c * 2 + (rows * 200 * 2 if attn else 0) + rows * width * 2
                + stages * 32 * max(np_) * 2 + 64)
        if smem <= 232448:
            return (rows, rows // l, width, np_, stages)
    return None


def test_bf16_half_plans_are_unchanged():
    for c in range(64, 513, 64):
        for local in range(32, 2 * c + 1, 32):
            for kind, l in [("mlp", 1), ("attn", 4), ("attn", 16), ("attn", 48), ("attn", 64)]:
                plan = tblock.half_plan(kind, l, c, local)
                assert plan == tblock.half_plan(kind, l, c, local, torch.bfloat16)
                want = parent_bf16_half_plan(kind, l, c, local)
                assert (None if plan is None else tuple(plan)[:5]) == want, (kind, l, c, local)
                assert plan is None or not plan.f32


# ---- the re-layout cache and the checks ------------------------------------------


@pytest.mark.parametrize("kind", ["attn", "mlp"])
def test_f32_and_bf16_relayouts_of_one_shard_are_cached_apart(kind):
    """An f32 shard and its bf16 copies (``cast_weight``, made anew on every
    call) re-lay apart, once each per weight version, each in its kernels'
    slab layout."""
    master = [torch.nn.Parameter(t.clone()) for t in
              shard_block(to_torch(block_params(256, 256, seed=6)), 2, 1)]
    l = 16 if kind == "attn" else 1

    def call(dtype):
        p = tblock.BlockParams(*(tblock.cast_weight(t, dtype) for t in master))
        ap, mp = halves(p)
        plan = tblock.half_plan(kind, l, 256, 128, dtype)
        return (tblock.half_weights(ap, plan, 4) if kind == "attn"
                else tblock.half_weights(mp, plan)), plan

    before = tblock.relaid_weights.count
    (w32, p32), (w16, p16) = call(F32), call(torch.bfloat16)
    assert tblock.relaid_weights.count == before + 2 and w32 is not w16
    assert w32.slabs.dtype == F32 and w16.slabs.dtype == torch.bfloat16
    assert p32.f32 and not p16.f32 and p32.rows == 64 and p16.rows == 128
    for _ in range(2):
        assert call(F32)[0] is w32 and call(torch.bfloat16)[0] is w16
    assert tblock.relaid_weights.count == before + 2
    with torch.no_grad():  # an optimizer step on the f32 parameter: both re-lay
        master[2 if kind == "attn" else 12].add_(0.25)
    assert call(F32)[0] is not w32 and call(torch.bfloat16)[0] is not w16
    assert tblock.relaid_weights.count == before + 4


def _shard_args(x_dtype, p_dtype, odd=None, kind="attn"):
    x = torch.zeros(4, 16, 256, dtype=x_dtype)
    p = shard_block(to_torch(block_params(256, 256, seed=1)), 2, 0)
    p = tblock.BlockParams(*(t.to(p_dtype).clone() for t in p))  # torch-aligned storage
    if odd is not None:
        p = p._replace(**{odd: p._asdict()[odd].to(torch.bfloat16 if p_dtype == F32 else F32)})
    ap, mp = halves(p)
    return x, ap, mp


@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
def test_half_checks_accept_one_dtype_bf16_or_f32(dtype):
    x, ap, mp = _shard_args(dtype, dtype)
    tblock._check_attn_half(x, ap, 16, 4)
    tblock._check_mlp_half(x, mp)


@pytest.mark.parametrize("x_dtype,p_dtype,odd", [
    (torch.float16, torch.float16, None),      # f16: no instantiation
    (F32, torch.bfloat16, None),               # f32 activations, bf16 weights
    (torch.bfloat16, F32, None),               # bf16 activations, f32 weights
    (F32, F32, "wo"),                          # one bf16 attention weight among f32
    (F32, F32, "ln2_scale"),                   # one bf16 MLP parameter among f32
    (torch.bfloat16, torch.bfloat16, "w1"),    # one f32 weight among bf16
    (torch.float64, torch.float64, None),
])
def test_half_checks_refuse_other_and_mixed_dtypes(x_dtype, p_dtype, odd):
    x, ap, mp = _shard_args(x_dtype, p_dtype, odd)
    bad_attn = odd in (None, "wo")
    bad_mlp = odd in (None, "ln2_scale", "w1")
    if bad_attn:
        with pytest.raises(ValueError):
            tblock._check_attn_half(x, ap, 16, 4)
    if bad_mlp:
        with pytest.raises(ValueError):
            tblock._check_mlp_half(x, mp)


def test_half_wrappers_ask_for_a_cuda_tensor_and_first_design_for_bf16():
    x, ap, mp = _shard_args(F32, F32)
    for check in (lambda: tblock._check_half_device(x),
                  lambda: tblock.block_tile_attn_half(x, ap, 16, 4, False),
                  lambda: tblock.block_tile_mlp_half(x, mp)):
        with pytest.raises(ValueError, match="CUDA|bf16 only"):
            check()
    with pytest.raises(ValueError, match="bf16 only"):
        tblock.block_tile_attn_half(x, ap, 16, 4, False)


def test_f32_half_plan_refusal_reaches_the_wrapper_as_an_error():
    """Where no f32 tile fits (C > 256) the wrapper raises with the plan,
    never launches: ``_half_plan_for``."""
    with pytest.raises(ValueError, match="no attn half tile plan"):
        tblock._half_plan_for("attn", 16, 512, 256, F32)
    with pytest.raises(ValueError, match="no mlp half tile plan"):
        tblock._half_plan_for("mlp", 1, 320, 160, F32)
    assert tblock._half_plan_for("attn", 16, 512, 256, torch.bfloat16).rows == 64
