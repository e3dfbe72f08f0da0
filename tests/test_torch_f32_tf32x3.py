"""The f32 tile body's 3xTF32 products, on the CPU.

The f32 block kernels and tp halves (``ops/csrc/block_sm90.cuh``:
``gemm_f32``) run every matmul product on the tensor cores as three TF32
products: each operand split into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna``), lo.hi + hi.lo + hi.hi summed in f32, lo.lo dropped
(``tests/_torch_tf32.py`` emulates it).  Here that arithmetic is held, on
numpy-seeded inputs and weights, against the JAX package's f32 reference
run on the CPU, within the limits the card holds the kernels to against
their plain versions (``chip_smoke.py``): relative L2 1e-5 and max abs
1e-4 * max |ref| for a block, relative L2 1e-6 for a half.  A single TF32
pass misses the block's limit, so the comparison is not vacuous; the split
itself is checked bit by bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_params, to_jax, to_torch
from _torch_tf32 import LOW_BITS, mm1, mm3, mm3_card, split_tf32, tf32_rna
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.ops.activations import gelu_tanh_f32
from tante_tpu_torch.parallel.sharding import shard_block
from test_torch_f32_blocks import C, HEADS, assert_within_kernel_tolerance, kernel_f32

HALF_REL_L2 = 1e-6
CLAMP = 60.0 * tblock.LOG2E  # the "fast" softmax's clamp, in log2 units


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---- the split ----------------------------------------------------------------


def test_tf32_rounding_is_cvt_rna():
    """To nearest on 10 mantissa bits, ties away from zero, either sign."""
    ulp = 2.0**-10
    cases = [(1.0, 1.0), (1 + ulp / 4, 1.0), (1 + ulp / 2, 1 + ulp), (1 + 3 * ulp / 2, 1 + 2 * ulp),
             (1 + ulp * 0.75, 1 + ulp), (-(1 + ulp / 2), -(1 + ulp)), (0.0, 0.0),
             (2.0**-100 * (1 + ulp / 2), 2.0**-100 * (1 + ulp))]
    x, want = (torch.tensor(v, dtype=torch.float32) for v in zip(*cases))
    assert torch.equal(tf32_rna(x), want)


def test_split_tf32_holds_x_to_2_pow_minus_22():
    """hi keeps its low 13 bits clear, lo too, and |x - (hi + lo)| <= 2^-22
    |x| over f32 values of every sign and binade whose remainder x - hi is
    normal too (|x| >= 2^-102)."""
    rng = np.random.default_rng(0)
    n = 1 << 18
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exponent = rng.integers(25, 254, n, dtype=np.uint32) << 23
    mantissa = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    x = torch.from_numpy((sign | exponent | mantissa).view(np.float32))
    x = x[x.abs() < 3.0e38]  # hi of the largest binade's top rounds to inf
    hi, lo = split_tf32(x)
    assert not (hi.view(torch.int32) & LOW_BITS).any()
    assert not (lo.view(torch.int32) & LOW_BITS).any()
    err = (x.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()


def test_3xtf32_partial_is_f32_accurate_and_one_pass_is_not():
    """A tp half's bare (4096 x 128) . (128 x 256) partial against float64:
    3xTF32 as close as f32's own product, one TF32 pass ~1e-4 off."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(4096, 128)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(128, 256)) / np.sqrt(128)).astype(np.float32))
    exact = a.double() @ b.double()
    three, f32 = rel_l2(mm3(a, b), exact), rel_l2(a @ b, exact)
    assert three <= HALF_REL_L2 and three <= 4 * f32, (three, f32)
    assert rel_l2(mm1(a, b), exact) > 1e-5


def test_truncating_accumulation_needs_a_fresh_sum_per_slab():
    """The tensor cores round each sum into an accumulator toward zero.
    Summed into one running total over K = 256 (96 truncations), a tp half's
    bare partial drifts past 1e-6 (the H100 read 2.5e-6 to 3e-6 so); summed
    per 16-deep slab into a fresh fragment and added to the total rounding
    to nearest, as ``gemm_f32`` does, it stays as close as f32's own
    product."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(1024, 256)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(256, 256)) / 16).astype(np.float32))
    exact = a.double() @ b.double()
    fresh, running = rel_l2(mm3_card(a, b), exact), rel_l2(mm3_card(a, b, False), exact)
    assert fresh <= HALF_REL_L2 / 4 and running > HALF_REL_L2, (fresh, running)
    assert fresh <= 3 * rel_l2(a @ b, exact)


# ---- the block ----------------------------------------------------------------


@pytest.mark.parametrize("l,causal", [(16, False), (48, False)])
def test_one_tf32_pass_misses_the_f32_block_limit(l, causal):
    """The block in one TF32 pass per product is ~1e-4 off JAX's f32 block:
    outside the limit the 3xTF32 arithmetic meets (test_torch_f32_blocks.py
    holds ``kernel_f32`` to it at L 4, 16, 32, 48 in both softmax forms)."""
    p = block_params(C, C, seed=100 + l)
    x = np.random.default_rng(l).normal(size=(256 // l, l, C)).astype(np.float32)
    want = np.asarray(jblock._xla_block(jnp.asarray(x), to_jax(p), l, HEADS, causal))
    three = kernel_f32(torch.from_numpy(x), to_torch(p), l, HEADS, causal)
    assert_within_kernel_tolerance(three.numpy(), want)
    one = kernel_f32(torch.from_numpy(x), to_torch(p), l, HEADS, causal, mm=mm1, amm=mm1)
    assert rel_l2(one.numpy(), want) > 1e-5


# ---- the tp halves --------------------------------------------------------------


def kernel_attn_half_f32(x, p: tblock.AttnHalfParams, l, heads, causal, softmax, mm=mm3,
                         amm=torch.matmul):
    """The f32 attention half's arithmetic (``fused_half_sm90_f32.cu``):
    block_tile_f32's first half, the out-projection's pre-bias partial."""
    s = x.shape[0]
    ca = p.wq.shape[-1]
    d = ca // heads
    qs = d**-0.5 * tblock.LOG2E
    xn = tblock.ln(x, p.ln1_scale, p.ln1_bias)
    q = mm(xn, p.wq * qs) + p.bq * qs
    k = mm(xn, p.wk) + p.bk
    v = mm(xn, p.wv) + p.bv
    q, k, v = (t.reshape(s, l, heads, d).transpose(1, 2) for t in (q, k, v))
    scores = amm(q, k.transpose(-1, -2))
    keep = torch.ones(l, l, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    if softmax == "safe":
        e = torch.exp2(scores - scores.masked_fill(~keep, -1e30).amax(-1, keepdim=True))
    else:
        e = torch.exp2(torch.clamp(scores, max=CLAMP))
    e = e.masked_fill(~keep, 0.0)
    o = amm(e, v) / (e.sum(-1, keepdim=True) + 1e-30)
    return mm(o.transpose(1, 2).reshape(s, l, ca), p.wo)


def kernel_mlp_half_f32(x, p: tblock.MlpHalfParams, mm=mm3):
    h = gelu_tanh_f32(mm(tblock.ln(x, p.ln2_scale, p.ln2_bias), p.w1) + p.b1)
    return mm(h, p.w2)


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("tp,l,causal", [(2, 16, False), (2, 4, True), (4, 48, False),
                                         (8, 32, False)])
def test_3xtf32_halves_match_jax_halves(tp, l, causal, softmax):
    """Every shard of the flagship width (C = hidden = 256, 8 heads) at tp 2,
    4, 8: the 3xTF32 halves against JAX's ``_xla_attn_half`` /
    ``_xla_mlp_half`` in f32 and the port's plain halves, relative L2 <=
    1e-6."""
    p = block_params(C, C, seed=300 + tp + l)
    x = np.random.default_rng(30 + l).normal(size=(8, l, C)).astype(np.float32)
    xt = torch.from_numpy(x)
    local = HEADS // tp
    for r in range(tp):
        shard = shard_block(to_torch(p), tp, r)
        ap = tblock.AttnHalfParams(*(getattr(shard, f) for f in tblock.AttnHalfParams._fields))
        mp = tblock.MlpHalfParams(*(getattr(shard, f) for f in tblock.MlpHalfParams._fields))
        ja = jblock.AttnHalfParams(*(jnp.asarray(t.numpy()) for t in ap))
        jm = jblock.MlpHalfParams(*(jnp.asarray(t.numpy()) for t in mp))
        got = kernel_attn_half_f32(xt, ap, l, local, causal, softmax)
        want = np.asarray(jblock._xla_attn_half(jnp.asarray(x), ja, l, local, causal))
        assert rel_l2(got.numpy(), want) <= HALF_REL_L2, (r, rel_l2(got.numpy(), want))
        assert rel_l2(got, tblock.attn_half_ref(xt, ap, l, local, causal)) <= HALF_REL_L2
        got = kernel_mlp_half_f32(xt, mp)
        want = np.asarray(jblock._xla_mlp_half(jnp.asarray(x), jm))
        assert rel_l2(got.numpy(), want) <= HALF_REL_L2, (r, rel_l2(got.numpy(), want))
        assert rel_l2(got, tblock.mlp_half_ref(xt, mp)) <= HALF_REL_L2
