"""Port parity: the head-packed attention core, ``MultiheadAttention``,
``Mlp`` and ``TransformerBlock`` of ``tante_tpu_torch`` against the JAX
package, f32 on the CPU.

- The plain core (``packed_attention_ref``, and the wrapper, which takes it
  on the CPU) against the Pallas kernel in interpret mode at the cases of
  ``tests/test_pallas_kernels.py`` (causal and not), atol 2e-5 as there.
- The wrapper's kernel geometry: the (S0, S1, heads, L, D) views and the
  output layout it hands the CUDA kernel, walked on the CPU by an emulation
  of the kernel, for the packed form and for (*lead, L, heads, D)
  projections with zero to two leading axes and strided views.
- The autograd Function's gradients (backward = the plain version) against
  ``jax.grad`` through ``pallas_attention.packed_attention``: 1e-5.
- ``MultiheadAttention`` on all three branches (packed, unpacked per head,
  general: bias, cross-attention), and ``TransformerBlock``: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import transplant
from tante_tpu.models.common import Mlp as JaxMlp
from tante_tpu.models.common import TransformerBlock as JaxTransformerBlock
from tante_tpu.ops import attention as jattn
from tante_tpu.ops.pallas_attention import packed_attention as jax_packed_attention
from tante_tpu.ops.pallas_attention import packed_attention_core
from tante_tpu_torch.models.common import Mlp, TransformerBlock
from tante_tpu_torch.ops import fused_attention as fa
from tante_tpu_torch.ops.attention import MultiheadAttention

ATOL = RTOL = 1e-5
# (S, heads, L, D): the cases of tests/test_pallas_kernels.py
CORE_CASES = [(10, 8, 16, 32), (7, 4, 4, 16)]


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def qkv(seed, s, nh, l, d):
    p = nh * l
    return rand(seed, s, p, d, scale=d**-0.5), rand(seed + 1, s, p, d), rand(seed + 2, s, p, d)


# ---- the core ---------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,nh,l,d", CORE_CASES)
def test_plain_core_matches_the_pallas_kernel(s, nh, l, d, causal):
    q, k, v = qkv(0, s, nh, l, d)
    want = packed_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), l=l,
                                 causal=causal, seq_tile=4, interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    close(fa.packed_attention_ref(*t, l, causal), want, atol=2e-5, rtol=0)
    close(fa.packed_attention(*t, l, causal), want, atol=2e-5, rtol=0)  # CPU: the plain version


@pytest.mark.parametrize("causal", [False, True])
def test_packed_head_attention_matches_jax(causal):
    q, k, v = (rand(i, 3, 10, 4, 16) for i in range(3))
    want = jattn.packed_head_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = fa.packed_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    close(got, want)


def emulated_launch(q5, k5, v5, o5, causal, scale):
    """What the kernel computes on its (S0, S1, H, L, D) views: per segment
    f32 scores (q scaled inside), max-subtract softmax, weights in v's dtype,
    the AV product written through the output view."""
    scores = scale * torch.einsum("abhid,abhjd->abhij", q5.float(), k5.float())
    if causal:
        l = q5.shape[3]
        keep = torch.ones(l, l, dtype=torch.bool).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v5.dtype)
    o5.copy_(torch.einsum("abhij,abhjd->abhid", w.float(), v5.float()).to(o5.dtype))
    fa.packed_attention.launches += 1


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_geometry_walked_on_the_cpu(monkeypatch, causal):
    monkeypatch.setattr(fa, "_launch", emulated_launch)
    fa.packed_attention.launches = 0
    # The packed (S, P, D) form of the JAX signature.
    q, k, v = (torch.from_numpy(a) for a in qkv(3, 5, 4, 8, 16))
    close(fa._kernel(q, k, v, 8, causal, False), fa.packed_attention_ref(q, k, v, 8, causal))
    # (*lead, L, heads, D) with 0, 1 and 2 leading axes; q, k, v as strided
    # slices of one fused projection, and a column view of an axial layout.
    fused = torch.from_numpy(rand(4, 2, 6, 5, 3, 3 * 8))  # (B, H, W, heads, 3 * D)
    q, k, v = fused.chunk(3, dim=-1)
    for views in ((q, k, v), tuple(t.transpose(1, 2) for t in (q, k, v)),
                  tuple(t[0] for t in (q, k, v)), tuple(t[0, 0] for t in (q, k, v))):
        got = fa._kernel(*views, views[0].shape[-3], causal, True)
        assert got.is_contiguous() and got.shape == views[0].shape
        close(got, fa._head_ref(*views, causal))
    assert fa.packed_attention.launches == 5


def test_kernel_envelope_is_checked_before_the_build():
    for shape, what in (((2, 129, 16), "heads \\* L"), ((2, 16, 4), "D = 4")):
        q = torch.zeros(shape)
        with pytest.raises(ValueError, match=what):
            fa._kernel(q, q, q, shape[1], False, False)
    with pytest.raises(ValueError, match="f32 or bf16"):
        q = torch.zeros(2, 16, 16, dtype=torch.float16)
        fa._kernel(q, q, q, 4, False, False)
    with pytest.raises(ValueError, match="leading axes"):
        q = torch.zeros(2, 2, 2, 4, 2, 16)
        fa._kernel(q, q, q, 4, False, True)
    with pytest.raises(ValueError, match="dividing P"):
        q = torch.zeros(2, 10, 16)
        fa.packed_attention(q, q, q, 4)


@pytest.mark.parametrize("heads_last", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_jax_grad(monkeypatch, causal, heads_last):
    """``_PlainGrad`` (its forward on the plain version here: the kernel runs
    on the card only) against jax.grad through the JAX package's
    ``packed_attention`` custom VJP."""
    monkeypatch.setattr(fa, "_kernel", fa._plain)
    s, nh, l, d = 6, 4, 8, 16
    q, k, v = qkv(5, s, nh, l, d)
    cot = rand(9, s, nh * l, d)

    def jax_loss(a, b, c):
        return jnp.sum(jax_packed_attention(a, b, c, l, causal) * cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    if heads_last:  # the same function on (S, L, heads, D) views, q unscaled
        views = [t.unflatten(1, (nh, l)).transpose(1, 2) for t in leaves]
        views[0] = views[0] * d**0.5
        out = fa._PlainGrad.apply(*views, l, causal, True).transpose(1, 2).reshape(s, -1, d)
    else:
        out = fa._PlainGrad.apply(*leaves, l, causal, False)
    (out * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(leaves, want):
        close(t.grad, w)


# ---- MultiheadAttention, Mlp, TransformerBlock -------------------------------------


# (label, L, k/v input, attn_bias, causal): the branch each case takes (4 heads:
# L = 40 is past the 128-token packing gate)
MHA_CASES = [
    ("packed", 10, None, False, False),
    ("packed causal", 10, None, False, True),
    ("unpacked", 40, None, False, False),
    ("unpacked causal", 40, None, False, True),
    ("bias", 10, None, True, False),
    ("cross", 10, 7, False, False),
]


@pytest.mark.parametrize("label,l,kv_len,bias,causal", MHA_CASES, ids=[c[0] for c in MHA_CASES])
def test_multihead_attention_matches_jax(monkeypatch, label, l, kv_len, bias, causal):
    c, heads = 32, 4
    x = rand(10, 2, l, c)
    kv = rand(11, 2, kv_len, c) if kv_len else None
    ab = rand(12, 1, heads, l, l) if bias else None
    monkeypatch.setattr(jattn, "PACKED_ATTENTION_MAX_TOKENS", 128)  # the default, whatever TANTE_PACKED_MAX says
    tm = MultiheadAttention(c, heads, gen=torch.Generator().manual_seed(0))
    params, tm = transplant(jattn.MultiheadAttention(c, heads), tm, x)
    args = (x,) if kv is None else (x, kv, kv)
    want = jattn.MultiheadAttention(c, heads).apply(
        params, *(jnp.asarray(a) for a in args), causal=causal,
        attn_bias=None if ab is None else jnp.asarray(ab))
    targs = [torch.from_numpy(a) for a in args]
    calls = []
    real = fa.packed_attention_ref
    monkeypatch.setattr(fa, "packed_attention_ref", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = tm(*targs, causal=causal, attn_bias=None if ab is None else torch.from_numpy(ab))
    close(got, want)
    assert len(calls) == int(label.startswith("packed"))


def test_mlp_and_transformer_block_match_jax():
    c, heads = 32, 4
    x = rand(20, 3, 12, c)
    params, tm = transplant(JaxMlp(48, c), Mlp(c, 48, c, gen=torch.Generator()), x)
    close(tm(torch.from_numpy(x)).detach(), JaxMlp(48, c).apply(params, jnp.asarray(x)))
    for causal in (False, True):
        jb = JaxTransformerBlock(c, heads, mlp_ratio=2.0, dropout=0.1)
        params, tb = transplant(jb, TransformerBlock(c, heads, mlp_ratio=2.0, dropout=0.1), x,
                                seed=1)
        want = jb.apply(params, jnp.asarray(x), causal=causal)
        with torch.no_grad():
            close(tb(torch.from_numpy(x), causal=causal), want)


def test_transformer_block_dropout_sites():
    """Active dropout: the three sites draw from the caller's generator (the
    attention weights through the general branch), the same seed gives the
    same output, and a missing generator is an error."""
    c, heads = 32, 4
    x = torch.from_numpy(rand(21, 2, 12, c))
    tb = TransformerBlock(c, heads, dropout=0.5, gen=torch.Generator().manual_seed(0))
    run = lambda g: tb(x, deterministic=False, generator=g)  # noqa: E731
    a, b = run(torch.Generator().manual_seed(1)), run(torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert not torch.allclose(a, tb(x))
    assert not torch.allclose(a, run(torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError, match="Generator"):
        tb(x, deterministic=False)
