"""Port parity: the chain/group of fused blocks and the gradients of every
block entry point (``tante_tpu_torch.ops.fused_block``) against the JAX
package (its off-TPU path: the plain XLA math), f32 on the CPU, same seeded
numpy inputs and weights.

Tolerances: forward 1e-5 abs / 1e-5 rel (the same f32 formulation summed in
another order).  Gradients of sum(y**2): 1e-5 relative to the largest entry
of the reference gradient (entries span orders of magnitude within one
tensor, and each is a sum over every token); ``bk`` is held to ``bq``'s scale
instead, because a bias on k shifts every score of a query alike, softmax
ignores it, and its true gradient is zero: both packages return rounding
noise there.  Models: 1e-4, as the other model tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    B, F, H, KW, T, W, block_params, flatten, frames, metadata, to_jax, to_torch,
    walk_chain_plan,
)
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.attn_backbone import AttnBackbone as JaxBackbone
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.convert import load_jax_params, state_dict_from_jax
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.attn_backbone import AttnBackbone
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import fused_block as tblock

ATOL = RTOL = 1e-5
DIMS = (4, 6, 5)  # (T, H, W): three different lengths
C, HEADS, BATCH = 64, 4, 2
_PERM = {"T": (0, 2, 3, 1, 4), "H": (0, 1, 3, 2, 4), "W": (0, 1, 2, 3, 4)}


def to_order(x5, axis):
    """(B, T, H, W, C) numpy -> (S, L, C) in ``axis``'s token order."""
    l = x5.shape[1 + "THW".index(axis)]
    return np.ascontiguousarray(x5.transpose(_PERM[axis])).reshape(-1, l, x5.shape[-1])


def inputs(axes, seed=0):
    ps = [block_params(C, C, seed=10 * i + seed) for i in range(len(axes))]
    x5 = np.random.default_rng(seed).normal(size=(BATCH, *DIMS, C)).astype(np.float32)
    return x5, ps


def assert_grads_close(got, want, names):
    scale = {n: float(np.abs(np.asarray(w)).max()) for n, w in zip(names, want)}
    for n, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, err_msg=n,
                                   atol=1e-5 * scale[n.replace("bk[", "bq[")])


def grad_names(n_blocks):
    return ["x"] + [f"{f}[{i}]" for i in range(n_blocks) for f in tblock.BlockParams._fields]


def torch_grads(fn, x, ps):
    x = torch.from_numpy(x).requires_grad_(True)
    ps = [to_torch(p, requires_grad=True) for p in ps]
    (fn(x, ps) ** 2).sum().backward()
    return [x.grad] + [t.grad for p in ps for t in p]


def jax_grads(fn, x, ps):
    gx, gps = jax.grad(lambda a, p: jnp.sum(fn(a, p) ** 2), argnums=(0, 1))(
        jnp.asarray(x), tuple(to_jax(p) for p in ps))
    return [gx] + [t for p in gps for t in p]


@pytest.mark.parametrize("axes", ["THW", "HW", "WT", "TH", "HWTHW"])
def test_group_ref_matches_jax_group(axes):
    x5, ps = inputs(axes)
    want = jblock.fused_group_apply(jnp.asarray(x5), tuple(to_jax(p) for p in ps), axes, HEADS)
    got = tblock.fused_group_apply(torch.from_numpy(x5), [to_torch(p) for p in ps], axes, HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# "WT" and "HT" start and end on different axes: the chain's output order
# differs from its input order.
@pytest.mark.parametrize("axes", ["THW", "HW", "WT", "HT", "WH"])
def test_chain_ref_matches_jax_chain_forward_and_grad(axes):
    x5, ps = inputs(axes, seed=1)
    x3 = to_order(x5, axes[0])
    jfn = lambda a, p: jblock.fused_chain_apply(a, p, axes, HEADS, DIMS)  # noqa: E731
    tfn = lambda a, p: tblock.fused_chain_apply(a, p, axes, HEADS, DIMS)  # noqa: E731
    want = jfn(jnp.asarray(x3), tuple(to_jax(p) for p in ps))
    got = tfn(torch.from_numpy(x3), [to_torch(p) for p in ps])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert_grads_close(torch_grads(tfn, x3, ps), jax_grads(jfn, x3, ps), grad_names(len(axes)))


def test_group_ref_gradient_matches_jax():
    axes = "THW"
    x5, ps = inputs(axes, seed=2)
    jfn = lambda a, p: jblock.fused_group_apply(a, p, axes, HEADS)  # noqa: E731
    tfn = lambda a, p: tblock.fused_group_apply(a, p, axes, HEADS)  # noqa: E731
    assert_grads_close(torch_grads(tfn, x5, ps), jax_grads(jfn, x5, ps), grad_names(3))


@pytest.mark.parametrize("causal", [False, True])
def test_block_gradient_matches_jax(causal):
    l = 6
    p = block_params(C, 2 * C, seed=3)
    x = np.random.default_rng(3).normal(size=(5, l, C)).astype(np.float32)
    jfn = lambda a, ps: jblock.fused_block_apply(a, ps[0], l, HEADS, causal)  # noqa: E731
    tfn = lambda a, ps: tblock.fused_block_apply(a, ps[0], l, HEADS, causal)  # noqa: E731
    assert_grads_close(torch_grads(tfn, x, [p]), jax_grads(jfn, x, [p]), grad_names(1))


def test_canon_t_gradient_matches_jax():
    c, heads = 128, 4
    p = block_params(c, c, seed=4)
    x = np.random.default_rng(4).normal(size=(2, 4, 3, 5, c)).astype(np.float32)
    jfn = lambda a, ps: jblock.fused_block_canon_t(a, ps[0], heads)  # noqa: E731
    tfn = lambda a, ps: tblock.fused_block_canon_t(a, ps[0], heads)  # noqa: E731
    assert_grads_close(torch_grads(tfn, x, [p]), jax_grads(jfn, x, [p]), grad_names(1))


# The ints the CUDA kernel is given (its whole addressing) walked on the CPU:
# exact, because each sequence sees the same rows in the same order.
@pytest.mark.parametrize("axes", ["THW", "HW", "WT", "TH", "T", "HWTHW", "WWH"])
def test_chain_plan_addresses_the_tokens_chain_ref_does(axes):
    x5, ps = inputs(axes, seed=5)
    tps = [to_torch(p) for p in ps]
    want5 = tblock.group_ref(torch.from_numpy(x5), tps, axes, HEADS)
    plan = tblock.chain_plan(axes, DIMS, BATCH)
    got5 = walk_chain_plan(torch.from_numpy(x5).reshape(-1, C), tps, plan, HEADS)
    assert torch.equal(got5.reshape(want5.shape), want5)
    x3 = torch.from_numpy(to_order(x5, axes[0]))
    want3 = tblock.chain_ref(x3, tps, axes, HEADS, DIMS)
    plan = tblock.chain_plan(axes, DIMS, BATCH, tblock._ORDER[axes[0]], tblock._ORDER[axes[-1]])
    got3 = walk_chain_plan(x3.reshape(-1, C), tps, plan, HEADS)
    assert torch.equal(got3.reshape(want3.shape), want3)


def test_recompute_function_gives_plain_autograd_gradients():
    """``_RecomputeGrad`` with a stand-in launch (the plain version, detached
    as a kernel's output is): backward must equal ordinary autograd, and
    tensors that need no gradient get none."""
    axes = "TH"
    x5, ps = inputs(axes, seed=6)
    plain = lambda x, p: tblock.group_ref(x, p, axes, HEADS)  # noqa: E731
    launched = []

    def launch(x, p):
        launched.append(1)
        return plain(x, p).detach()

    want = torch_grads(plain, x5, ps)
    got = torch_grads(lambda x, p: tblock._run(launch, plain, x, p), x5, ps)
    assert launched == [1]  # forward only: backward recomputes the plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    x = torch.from_numpy(x5)
    frozen = [to_torch(p) for p in ps]
    assert not tblock._run(launch, plain, x, frozen).requires_grad


def test_fusable_gates():
    assert tblock.group_fusable("THWTHWTHW", (4, 16, 48), 256, 8)
    assert tblock.chain_fusable("WT", (4, 16, 48), 256, 8, 512)
    assert not tblock.group_fusable("THL", (4, 16, 48), 256, 8)      # unknown axis
    assert not tblock.group_fusable("THW", (4, 16, 48), 256, 7)      # heads do not divide C
    # The kernel's own envelope (the TPU gate's VMEM budget is gone):
    assert not tblock.group_fusable("THW", (4, 96, 48), 256, 8)      # an axis longer than a tile
    assert not tblock.group_fusable("THW", (4, 16, 48), 32, 4)       # head dim 8
    assert not tblock.group_fusable("T" * 13, (4, 16, 48), 256, 8)   # more blocks than a launch
    assert tblock.group_fusable("THW", (8, 64, 64), 512, 8)          # no whole-element ceiling


# ---- models ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(fused_chain=2), dict(fused_chain=3), dict(fused_group=True)],
                         ids=["chain2", "chain3", "group"])
def test_backbone_chain_and_group_match_jax(kw):
    t, h, w, c, heads, axes = 4, 4, 8, 128, 4, "THWLHW"[: 6 if "fused_chain" in kw else 3]
    if "fused_group" in kw:
        axes = "THWTH"
    jm = JaxBackbone(tensor_shape=(t, h, w, c), attn_axes=axes, n_head=heads, **kw)
    x = np.random.default_rng(0).normal(size=(2, t, h, w, c)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = AttnBackbone((t, h, w, c), axes, heads, **kw)
    tm.load_state_dict(state_dict_from_jax(flatten(params)))
    plain = AttnBackbone((t, h, w, c), axes, heads)
    plain.load_state_dict(tm.state_dict())
    calls = []
    for name in ("fused_chain_apply", "fused_group_apply"):
        orig = getattr(tblock, name)
        import tante_tpu_torch.models.attn_backbone as bb

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append((_name, a[2]))
            return _orig(*a, **k)

        setattr(bb, name, spy)
    try:
        got = tm(torch.from_numpy(x))
    finally:
        bb.fused_chain_apply, bb.fused_group_apply = tblock.fused_chain_apply, tblock.fused_group_apply
    expect = {"chain2": [("fused_chain_apply", "TH"), ("fused_chain_apply", "HW")],
              "chain3": [("fused_chain_apply", "THW"), ("fused_chain_apply", "HW")],
              "group": [("fused_group_apply", "THWTH")]}
    key = "group" if "fused_group" in kw else f"chain{kw['fused_chain']}"
    assert calls == expect[key]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.detach().numpy(), plain(torch.from_numpy(x)).detach().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused_chain", [2, 3])
def test_tante_with_chain_matches_jax(fused_chain):
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata), fused_chain=fused_chain, **KW)
    x = frames(11)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, T, H, W, F), jnp.float32))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = TANTE(dset_metadata=metadata(TanteMetadata), fused_chain=fused_chain, device="cpu", **KW)
    load_jax_params(tm, flatten(params))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (B, 1, H, W, F)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
