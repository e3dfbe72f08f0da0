"""Port parity: the fused transformer block's plain PyTorch versions
(``tante_tpu_torch.ops.fused_block``) against the JAX package's XLA block
math, f32 on the CPU, same seeded numpy inputs and weights.

Tolerance: 1e-5 abs / 1e-5 rel — the same f32 formulation summed in
another order (LayerNorm moments, matmuls, softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_params, to_jax, to_torch
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import _build
from tante_tpu_torch.ops import fused_block as tblock

ATOL = RTOL = 1e-5


@pytest.mark.parametrize("l", [4, 16])
@pytest.mark.parametrize("causal", [False, True])
def test_block_ref_matches_xla_block(l, causal):
    c, heads = 64, 4
    p = block_params(c, c, seed=l + causal)
    x = np.random.default_rng(1).normal(size=(6, l, c)).astype(np.float32)
    want = np.asarray(jblock._xla_block(jnp.asarray(x), to_jax(p), l, heads, causal))
    got = tblock.block_ref(torch.from_numpy(x), to_torch(p), l, heads, causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_canon_t_ref_matches_jax_canon_t():
    b, t, h, w, c, heads = 2, 4, 4, 8, 128, 4
    p = block_params(c, c, seed=7)
    x = np.random.default_rng(2).normal(size=(b, t, h, w, c)).astype(np.float32)
    assert jblock.canon_t_supported(t, h, w, c, heads)
    assert tblock.canon_t_supported(t, h, w, c, heads)
    want = np.asarray(jblock.fused_block_canon_t(jnp.asarray(x), to_jax(p), heads))
    got = tblock.canon_t_ref(torch.from_numpy(x), to_torch(p), heads).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (3.0 + rng.normal(size=(5, 96))).astype(np.float32)
    s, b = rng.normal(size=96).astype(np.float32), rng.normal(size=96).astype(np.float32)
    want = np.asarray(jblock._ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tblock.ln(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("canon", [False, True])
def test_wrapper_on_cpu_takes_the_plain_path(canon):
    """A CPU tensor runs the plain version and launches nothing."""
    c, heads = 128, 4
    p = to_torch(block_params(c, c, seed=11))
    rng = np.random.default_rng(4)
    tblock.reset_launches()
    if canon:
        x = torch.from_numpy(rng.normal(size=(1, 3, 2, 4, c)).astype(np.float32))
        got = tblock.fused_block_canon_t(x, p, heads)
        want = tblock.canon_t_ref(x, p, heads)
    else:
        x = torch.from_numpy(rng.normal(size=(5, 8, c)).astype(np.float32))
        got = tblock.fused_block_apply(x, p, 8, heads, False)
        want = tblock.block_ref(x, p, 8, heads, False)
    assert torch.equal(got, want)
    assert not tblock.fused_block_apply.launches
    assert not tblock.fused_block_canon_t.launches


def test_wrapper_refuses_a_non_cpu_tensor_it_cannot_launch():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    a device the kernel does not take is refused, not run plainly."""
    c, heads = 64, 4
    p = to_torch(block_params(c, c, seed=5))
    x = torch.empty((4, 16, c), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tblock.fused_block_apply(x, p, 16, heads, False)


def test_canon_t_gate_matches_jax_where_vmem_does_not_bind():
    """Same T / C / heads gate; the TPU gate's VMEM ceiling (one whole batch
    element on chip) has no counterpart in the pixel-tiled CUDA kernel, so
    the grids here stay under it."""
    for t, c, heads in [(1, 128, 4), (2, 128, 4), (4, 256, 8), (8, 256, 8), (9, 256, 8),
                        (4, 192, 4), (4, 128, 3)]:
        assert tblock.canon_t_supported(t, 4, 8, c, heads) == jblock.canon_t_supported(
            t, 4, 8, c, heads
        ), (t, c, heads)
    assert tblock.canon_t_supported(4, 16, 48, 256, 8)  # the flagship T block


def test_ptxas_summary_parses_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function '_Z3fooILi4EEvv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooILi4EEvv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 464 bytes cmem[0]\n"
    )
    assert _build.ptxas_summary(log) == [{
        "kernel": "_Z3fooILi4EEvv", "registers": 168,
        "spill_store_bytes": 4, "spill_load_bytes": 12,
    }]
