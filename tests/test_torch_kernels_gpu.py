"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided in
the fixture, never at import, so every worker collects the same tests).
Run on the card (no JAX there, so skip the JAX conftest and the xdist addopts):
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels_gpu.py

Inputs are seeded bf16; the plain version runs in f32 from the same bf16
inputs.  Tolerance: |kernel - plain| <= 5e-2 + 2e-2 |plain| — bf16 keeps 8
mantissa bits and the kernel rounds q, k, v, the attention output, the fc1
output and both residual sums to bf16 (a CPU emulation of those rounding
points at these shapes gives a max error of 0.032 at |y| ~ 5)."""

import numpy as np
import pytest
import torch

from tante_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.gpu
ATOL, RTOL = 5e-2, 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    return torch.device("cuda")


def params(c, hidden, seed, device):
    rng = np.random.default_rng(seed)

    def u(*shape, fan_in=None, scale=1.0, offset=0.0):
        bound = 1.0 / np.sqrt(fan_in or shape[0])
        a = offset + scale * rng.uniform(-bound, bound, size=shape)
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)

    return fb.BlockParams(
        ln1_scale=u(c, scale=0.1, offset=1.0), ln1_bias=u(c, scale=0.1),
        wq=u(c, c), bq=u(c), wk=u(c, c), bk=u(c), wv=u(c, c), bv=u(c), wo=u(c, c), bo=u(c),
        ln2_scale=u(c, scale=0.1, offset=1.0), ln2_bias=u(c, scale=0.1),
        w1=u(c, hidden), b1=u(hidden, fan_in=c), w2=u(hidden, c), b2=u(c, fan_in=hidden),
    )


def bf16_normal(shape, seed, device):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device, torch.bfloat16)


def f32(p):
    return fb.BlockParams(*(t.float() for t in p))


@pytest.mark.parametrize("s,l,c,hidden,heads,causal", [
    (1536, 16, 256, 256, 8, False),   # flagship H blocks
    (512, 48, 256, 256, 8, False),    # flagship W blocks
    (512, 48, 256, 256, 8, True),
    (6144, 4, 256, 256, 8, True),     # rearranged T block
    (7, 48, 128, 256, 4, False),      # ragged tile, hidden = 2C
    (33, 16, 256, 256, 16, False),    # head dim 16
    (40, 8, 256, 512, 4, True),       # head dim 64, hidden = 2C
    (21, 3, 256, 256, 8, True),       # padded rows (63 of 64)
    (10, 16, 192, 128, 6, False),     # C and hidden not powers of two
])
def test_fused_block_kernel_matches_plain(cuda, s, l, c, hidden, heads, causal):
    p = params(c, hidden, seed=l + c, device=cuda)
    x = bf16_normal((s, l, c), seed=s, device=cuda)
    before = fb.fused_block_apply.launches
    got = fb.fused_block_apply(x, p, l, heads, causal)
    torch.cuda.synchronize()
    assert fb.fused_block_apply.launches == before + 1
    want = fb.block_ref(x.float(), f32(p), l, heads, causal)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,t,h,w,c,heads", [
    (8, 4, 16, 48, 256, 8),   # flagship T blocks
    (2, 8, 4, 8, 128, 4),
    (1, 3, 5, 7, 256, 8),     # ragged last tile
])
def test_fused_block_canon_t_kernel_matches_plain(cuda, b, t, h, w, c, heads):
    p = params(c, c, seed=t, device=cuda)
    x = bf16_normal((b, t, h, w, c), seed=b * t, device=cuda)
    before = fb.fused_block_canon_t.launches
    got = fb.fused_block_canon_t(x, p, heads)
    torch.cuda.synchronize()
    assert fb.fused_block_canon_t.launches == before + 1
    want = fb.canon_t_ref(x.float(), f32(p), heads)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


def test_kernel_refuses_what_it_cannot_hold(cuda):
    p = params(256, 256, seed=0, device=cuda)
    with pytest.raises(ValueError):  # f32 activations
        fb.fused_block_apply(torch.zeros(4, 16, 256, device=cuda), p, 16, 8, False)
    with pytest.raises(ValueError):  # sequence longer than a tile
        fb.fused_block_apply(bf16_normal((2, 96, 256), 0, cuda), p, 96, 8, False)
