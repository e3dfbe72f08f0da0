"""The f32 block kernels' arithmetic and Python side, on the CPU.

The f32 instantiation of the Hopper block body (``ops/csrc/block_sm90.cuh``,
``block_tile_f32``) computes every matmul product as three TF32 tensor-core
products (3xTF32: ``tests/_torch_tf32.py``), with ``d**-0.5 * log2(e)``
folded into ``wq``/``bq``, exp2 softmax in both forms (no max subtract and
a clamp at 60*log2(e), or max subtract), the AV sum normalised after with a
``+1e-30`` guard, one-pass LayerNorm moments and an accurate tanh in the
GELU.  ``kernel_f32`` below is that arithmetic in PyTorch; it is held
against the JAX package's f32 block (``_xla_block``, what JAX runs off the
TPU), canonical T block and chain, on the same numpy-seeded inputs and
weights, within the tolerance the card's kernel is held to against its
plain version (``chip_smoke.py``: relative L2 <= 1e-5, max abs <= 1e-4 max
|ref|).

Then the Python side the kernels read: the f32 tile plan against the shared
memory the card opts into, the bf16 plans unchanged, the f32 weight slabs
(in mma.sync's B-fragment order), and the argument checks (one dtype, bf16
or f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_params, to_jax, to_torch
from _torch_tf32 import mm3
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.ops.activations import gelu_tanh_f32

REL_L2, MAX_ABS_SHARE = 1e-5, 1e-4
C, HEADS = 256, 8


def kernel_f32(x, p, l, heads, causal, softmax="fast", mm=mm3, amm=torch.matmul):
    """The f32 kernel's arithmetic on (S, L, C) f32 rows: the projections
    and the MLP through ``mm`` (the card's 3xTF32 product), the attention's
    scores and AV sum through ``amm`` (f32 FMAs on the card)."""
    s, _, c = x.shape
    d = c // heads
    qs = d**-0.5 * tblock.LOG2E
    xn = tblock.ln(x, p.ln1_scale, p.ln1_bias)
    q = mm(xn, p.wq * qs) + p.bq * qs
    k = mm(xn, p.wk) + p.bk
    v = mm(xn, p.wv) + p.bv
    q, k, v = (t.reshape(s, l, heads, d).transpose(1, 2) for t in (q, k, v))  # (S, h, L, d)
    scores = amm(q, k.transpose(-1, -2))
    keep = torch.ones(l, l, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    if softmax == "fast":
        e = torch.exp2(torch.clamp(scores, max=60 * tblock.LOG2E))
    else:
        mx = torch.where(keep, scores, torch.full_like(scores, -1e30)).amax(-1, keepdim=True)
        e = torch.exp2(scores - mx)
    e = torch.where(keep, e, torch.zeros_like(e))
    o = amm(e, v) / (e.sum(-1, keepdim=True) + 1e-30)
    x1 = x + (mm(o.transpose(1, 2).reshape(s, l, c), p.wo) + p.bo)
    h = gelu_tanh_f32(mm(tblock.ln(x1, p.ln2_scale, p.ln2_bias), p.w1) + p.b1)
    return x1 + (mm(h, p.w2) + p.b2)


def kernel_f32_canon_t(x5, p, heads):
    b, t, h, w, c = x5.shape
    y = kernel_f32(x5.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c), p, t, heads, True)
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


def kernel_f32_chain(x5, ps, axes, heads):
    """The f32 single-block kernels in sequence on canonical (B, T, H, W, C),
    which the f32 chain kernel equals bit for bit on the card."""
    b, t, hp, wp, c = x5.shape
    x = x5
    for axis, p in zip(axes, ps):
        if axis == "T":
            x = kernel_f32_canon_t(x, p, heads)
        elif axis == "H":
            y = kernel_f32(x.permute(0, 1, 3, 2, 4).reshape(b * t * wp, hp, c), p, hp, heads,
                           False)
            x = y.reshape(b, t, wp, hp, c).permute(0, 1, 3, 2, 4)
        else:
            x = kernel_f32(x.reshape(b * t * hp, wp, c), p, wp, heads, False).reshape(x.shape)
    return x


def assert_within_kernel_tolerance(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(got).all()
    assert rel <= REL_L2, rel
    assert err <= MAX_ABS_SHARE * peak, (err, peak)


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("l,causal", [(4, True), (16, False), (32, False), (48, False)])
def test_f32_kernel_arithmetic_matches_jax_f32_block(l, causal, softmax):
    """L 4: the causal T block; 16 / 48: the bench field's H / W; 32: the
    active_matter geometry of configs/tante.yaml."""
    p = block_params(C, C, seed=100 + l)
    x = np.random.default_rng(l).normal(size=(256 // l, l, C)).astype(np.float32)
    want = jblock._xla_block(jnp.asarray(x), to_jax(p), l, HEADS, causal)
    got = kernel_f32(torch.from_numpy(x), to_torch(p), l, HEADS, causal, softmax)
    assert_within_kernel_tolerance(got.numpy(), want)


def test_f32_canon_t_arithmetic_matches_jax_canon_t():
    b, t, h, w = 1, 4, 4, 8
    p = block_params(C, C, seed=7)
    x = np.random.default_rng(2).normal(size=(b, t, h, w, C)).astype(np.float32)
    assert jblock.canon_t_supported(t, h, w, C, HEADS)
    assert tblock.canon_t_supported(t, h, w, C, HEADS, C, torch.float32)
    want = jblock.fused_block_canon_t(jnp.asarray(x), to_jax(p), HEADS)
    got = kernel_f32_canon_t(torch.from_numpy(x), to_torch(p), HEADS)
    assert_within_kernel_tolerance(got.numpy(), want)


@pytest.mark.parametrize("axes", ["THW", "WTH"])
def test_f32_chain_arithmetic_matches_jax_chain_apply(axes):
    dims = (4, 4, 8)
    b = 1
    ps = [block_params(C, C, seed=20 + i) for i in range(len(axes))]
    x5 = np.random.default_rng(3).normal(size=(b, *dims, C)).astype(np.float32)
    perm = {"T": (0, 2, 3, 1, 4), "H": (0, 1, 3, 2, 4), "W": (0, 1, 2, 3, 4)}
    sizes = dict(zip("THW", dims))
    x3 = x5.transpose(perm[axes[0]]).reshape(-1, sizes[axes[0]], C)
    want = jblock.fused_chain_apply(jnp.asarray(x3), [to_jax(p) for p in ps], axes, HEADS, dims)
    got5 = kernel_f32_chain(torch.from_numpy(x5), [to_torch(p) for p in ps], axes, HEADS)
    got = got5.permute(perm[axes[-1]]).reshape(-1, sizes[axes[-1]], C)
    assert tblock.group_fusable(axes, dims, C, HEADS, C, torch.float32)
    assert_within_kernel_tolerance(got.numpy(), want)


# --------------------------------------------------------------------------
# The f32 tile plan
# --------------------------------------------------------------------------

# (L, C, hidden) of the shipped TANTE configs and the bench field: T 4; the
# bench field's H 16 and W 48 (128 x 384 at patch 8); active_matter's 32.
SHIPPED = [(4, 256, 256), (16, 256, 256), (32, 256, 256), (48, 256, 256)]


@pytest.mark.parametrize("l,c,hidden", SHIPPED)
def test_f32_plan_fits_the_shared_memory_at_the_shipped_shapes(l, c, hidden):
    plan = tblock.sm90_plan(l, c, hidden, torch.float32)
    assert plan.rows == tblock.SM90_F32_ROWS == 64 and plan.seqs == 64 // l
    assert plan.np == (192, 128, 128, 128) and plan.stages == 3
    assert tblock.sm90_smem(plan.rows, c, hidden, plan.np, plan.stages,
                            torch.float32) <= tblock.SMEM_OPTIN
    # One stage more would not fit: the plan takes as many as fit.
    assert tblock.sm90_smem(plan.rows, c, hidden, plan.np, plan.stages + 1,
                            torch.float32) > tblock.SMEM_OPTIN


def test_f32_plan_covers_c_up_to_256_and_refuses_wider():
    for c in range(64, 257, 64):
        for hidden in range(64, 2 * c + 1, 64):
            for l in (1, 4, 16, 32, 48, 64):
                plan = tblock.sm90_plan(l, c, hidden, torch.float32)
                assert plan is not None, (l, c, hidden)
                assert tblock.sm90_smem(plan.rows, c, hidden, plan.np, plan.stages,
                                        torch.float32) <= tblock.SMEM_OPTIN
                assert plan.rows == 64 and plan.stages >= 2
                # the body's instantiations: q|k|v 192 wide, the rest 64 or 128
                assert plan.np[0] == 192 and set(plan.np[1:]) <= {64, 128}
    for l, c, hidden in [(16, 320, 320), (16, 512, 512), (65, 256, 256), (16, 256, 576)]:
        assert tblock.sm90_plan(l, c, hidden, torch.float32) is None, (l, c, hidden)
    assert not tblock.canon_t_supported(4, 16, 48, 512, 8, 512, torch.float32)
    assert tblock.canon_t_supported(4, 16, 48, 512, 8, 512, torch.bfloat16)
    assert not tblock.group_fusable("THW", (4, 16, 48), 512, 8, 512, torch.float32)
    assert tblock.group_fusable("THW", (4, 16, 48), 512, 8, 512, torch.bfloat16)


# The bf16 plans as the parent tree made them (rows, seqs, passes, stages).
BF16_PLANS = {
    (4, 256, 256): (128, 32, (192, 128, 128, 128), 4),
    (16, 256, 256): (128, 8, (192, 128, 128, 128), 4),
    (32, 256, 256): (128, 4, (192, 128, 128, 128), 4),
    (48, 256, 256): (128, 2, (192, 128, 128, 128), 4),
    (16, 64, 64): (128, 8, (192, 64, 64, 64), 4),
    (16, 512, 512): (64, 4, (192, 128, 128, 128), 4),
    (64, 384, 768): (64, 1, (192, 128, 128, 128), 4),
}


@pytest.mark.parametrize("shape", sorted(BF16_PLANS))
def test_bf16_plans_are_unchanged(shape):
    rows, seqs, np_, stages = BF16_PLANS[shape]
    plan = tblock.sm90_plan(*shape)
    assert plan == tblock.sm90_plan(*shape, torch.bfloat16)
    assert (plan.rows, plan.seqs, plan.np, plan.stages) == (rows, seqs, np_, stages)


# --------------------------------------------------------------------------
# The f32 weight slabs
# --------------------------------------------------------------------------


def unarrange_f32(flat, k, n, np_):
    """The (K, N) weight the f32 body reads: pass p, slab kc, 8-column tile
    j, lane 4g + t, element e at (((p * K/16 + kc) * np/8 + j) * 32 + 4g + t)
    * 4 + e holds row 16 kc + 4e + t, column p * np + 8j + g."""
    t = flat.reshape(n // np_, k // 16, np_ // 8, 8, 4, 4)  # pass, kc, j, g, t, e
    return t.permute(1, 5, 4, 0, 2, 3).reshape(k, n)


@pytest.mark.parametrize("k,n,np_", [(256, 192, 192), (256, 256, 128), (128, 512, 64),
                                     (512, 256, 128)])
def test_f32_slabs_hold_each_weight_exactly(k, n, np_):
    w = torch.from_numpy(np.random.default_rng(k + n).normal(size=(k, n)).astype(np.float32))
    flat = tblock.arrange_weight_f32(w, np_)
    assert flat.dtype == torch.float32 and flat.shape == (k * n,)
    assert torch.equal(unarrange_f32(flat, k, n, np_), w)
    # What gemm_f32's lane 4g + t of warp w loads as one float4 from slab kc
    # of pass p, tile w + 8j: rows t, t + 4 (b0, b1 of the first k8 step),
    # 8 + t, 12 + t (the second's) of column p * np + 8(w + 8j) + g.
    tiles = np_ // 8
    for p, kc, tile, g, t in [(0, 0, 0, 0, 0), (0, 1, 3, 5, 2), (n // np_ - 1, k // 16 - 1,
                                                                tiles - 1, 7, 3)]:
        off = ((p * (k // 16) + kc) * tiles + tile) * 128 + (4 * g + t) * 4
        col = p * np_ + 8 * tile + g
        rows = [16 * kc + t, 16 * kc + t + 4, 16 * kc + 8 + t, 16 * kc + 12 + t]
        assert torch.equal(flat[off:off + 4], w[rows, col]), (p, kc, tile, g, t)


def test_f32_weights_keep_the_prescaled_f32_q_and_every_matrix():
    p = to_torch(block_params(C, C, seed=5))
    plan = tblock.sm90_plan(16, C, C, torch.float32)
    w = tblock.sm90_weights(p, HEADS, plan)
    qs = (C // HEADS) ** -0.5 * tblock.LOG2E
    per_group = C * 192
    assert w.slabs.dtype == torch.float32 and w.slabs.numel() == 4 * per_group + 3 * C * C
    for g in range(C // 64):
        wg = unarrange_f32(w.slabs[g * per_group:(g + 1) * per_group], C, 192, 192)
        cols = slice(64 * g, 64 * g + 64)
        assert torch.equal(wg[:, :64], p.wq[:, cols] * qs)
        assert torch.equal(wg[:, 64:128], p.wk[:, cols])
        assert torch.equal(wg[:, 128:], p.wv[:, cols])
        assert torch.equal(w.bqkv[192 * g:192 * g + 64], p.bq[cols] * qs)
    rest = w.slabs[4 * per_group:]
    for i, name in enumerate(("wo", "w1", "w2")):
        got = unarrange_f32(rest[i * C * C:(i + 1) * C * C], C, C, 128)
        assert torch.equal(got, getattr(p, name)), name
    assert tblock.sm90_weights(p, HEADS, plan) is w  # cached until a new version
    with torch.no_grad():
        p.w2.mul_(2.0)
    assert tblock.sm90_weights(p, HEADS, plan) is not w


def test_bf16_and_f32_relayouts_of_one_block_are_cached_apart():
    p32 = to_torch(block_params(64, 64, seed=9))
    p16 = tblock.BlockParams(*(tblock.cast_weight(t, torch.bfloat16) for t in p32))
    w32 = tblock.sm90_weights(p32, 4, tblock.sm90_plan(16, 64, 64, torch.float32))
    w16 = tblock.sm90_weights(p16, 4, tblock.sm90_plan(16, 64, 64))
    assert w32.slabs.dtype == torch.float32 and w16.slabs.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# Argument checks: one dtype, bf16 or f32
# --------------------------------------------------------------------------


def _args(x_dtype, p_dtype, odd=None):
    x = torch.zeros(4, 16, 64, dtype=x_dtype)
    p = to_torch(block_params(64, 64, seed=1))
    p = tblock.BlockParams(*(t.to(p_dtype).clone() for t in p))  # torch-aligned storage
    if odd is not None:
        p = p._replace(**{odd: p._asdict()[odd].to(torch.bfloat16)})
    return x, p


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_checks_accept_one_dtype_bf16_or_f32(dtype):
    x, p = _args(dtype, dtype)
    tblock._check_block_args(x, p, 16, 4)


@pytest.mark.parametrize("x_dtype,p_dtype,odd", [
    (torch.float16, torch.float16, None),      # f16: no instantiation
    (torch.float32, torch.bfloat16, None),     # f32 activations, bf16 weights
    (torch.bfloat16, torch.float32, None),     # bf16 activations, f32 weights
    (torch.float32, torch.float32, "w1"),      # one bf16 weight among f32
    (torch.float64, torch.float64, None),
])
def test_checks_refuse_other_and_mixed_dtypes(x_dtype, p_dtype, odd):
    x, p = _args(x_dtype, p_dtype, odd)
    with pytest.raises(ValueError):
        tblock._check_block_args(x, p, 16, 4)


def test_kernel_checks_ask_for_a_cuda_tensor_first():
    x, p = _args(torch.float32, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tblock._check_kernel_args(x, p, 16, 4)


def test_first_designs_entries_take_bf16_only():
    x5 = torch.zeros(1, 4, 2, 2, 64)
    p = to_torch(block_params(64, 64, seed=2))
    with pytest.raises(ValueError, match="bf16 only"):
        tblock.block_tile_canon_t(x5, p, 4)
    with pytest.raises(ValueError, match="bf16 only"):
        tblock.block_tile_chain(x5, [p], "T", 4, (4, 2, 2))
