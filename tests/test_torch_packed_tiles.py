"""What the head-packed attention wrapper hands its Hopper kernel, and what
the kernel computes, on the CPU (``ops/fused_attention.py`` and
``ops/csrc/packed_attention.cu``): the kernel cannot run here.

(a) The launch plan (``packed_plan``: warps, ring stages, padded rows,
    shared memory) over the whole envelope (P = heads * L up to 128, D 8 to
    128, f32 and bf16, a few unit counts; causal masking does not enter the
    plan) fits in a CTA's 227 KB, and the persistent grid (``packed_grid``)
    with the kernel's deal of units to warps hands every unit out exactly
    once, the SMs' shares within one unit.  The card's plan equals it
    (``tests/test_torch_kernels_gpu.py``).
(b) The copy rule: AViT's row and column views, the packed form and the
    slices of a fused projection go to the kernel as they are; an operand
    with channel stride != 1, one off a 16-byte boundary, or rows of
    D * itemsize bytes that are no multiple of 16 is copied (zero-padded
    rows) and counted in ``packed_attention.copies``.
(c) The kernel's order of work, emulated per (sequence, head) unit in f32
    with single-rounding FMAs: scores summed over each parity of 16-byte
    chunks and the two parities added, times scale * log2(e); exp2 of the
    differences to the row max, their sum (L <= 16: four keys a lane, then
    across the row's four lanes; L > 16: each key parity in order, then the
    two), the division, the weights rounded to v's dtype; the AV product
    over the keys in order.  Held against the Pallas kernel in interpret
    mode (``packed_attention_core``) and ``packed_head_attention`` of the
    JAX package at 1e-5, causal and not; in bf16 against the plain version
    at the kernel's bf16 limit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tante_tpu.ops import attention as jattn
from tante_tpu.ops.pallas_attention import packed_attention_core
from tante_tpu_torch.ops import fused_attention as fa

ATOL = RTOL = 1e-5
BF16_TOL = 2e-2  # the kernel's bf16 limit (tests/test_torch_kernels_gpu.py:packed_tolerance)
# (S, heads, L, D): the cases of tests/test_pallas_kernels.py, and a P = 128
# case whose L = 32 takes the kernel's two-pass softmax.
CORE_CASES = [(10, 8, 16, 32), (7, 4, 4, 16), (3, 4, 32, 16)]
SMS = 132  # an H100's SMs
LOG2E = np.float32(1.4426950408889634)


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def tolerance(dtype):
    return (BF16_TOL, BF16_TOL) if dtype == torch.bfloat16 else (ATOL, RTOL)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ---- (a) the launch plan ------------------------------------------------------------


def deal(units, plan, grid):
    """The units each warp takes, in order, indexed cta * warps + warp, as
    the kernel deals them: unit u = cta + grid * (warp + warps * k) is the
    k-th of that warp."""
    return [list(range(cta + grid * warp, units, grid * plan.warps))
            for cta in range(grid) for warp in range(plan.warps)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 24, 64, 128])
def test_plan_fits_the_envelope(d, itemsize):
    for l in range(1, fa.PACKED_ATTENTION_MAX_TOKENS + 1):  # heads = 1 .. 128 // l
        for units in (1, 28, 1536, 12288, 1 << 20):
            p = fa.packed_plan(l, d, itemsize, units, SMS)
            chunks = p.row_bytes // 16
            assert p.row_bytes % 16 == 0 and p.row_bytes > d * itemsize and chunks % 4 == 2
            assert p.unit_bytes == 3 * l * p.row_bytes and p.scratch_bytes == 64 * l
            assert p.smem_bytes == p.warps * (p.stages * p.unit_bytes + p.scratch_bytes)
            assert p.smem_bytes <= fa.PLAN_SMEM_LIMIT
            assert 1 <= p.stages <= fa.PLAN_MAX_STAGES
            # a ring of two wherever one warp holds two units
            assert p.stages >= 2 or 2 * p.unit_bytes + p.scratch_bytes > fa.PLAN_SMEM_LIMIT
            # warps: up to 16, no more than give each two units of an SM's share
            per_sm = -(-units // SMS)
            assert 1 <= p.warps <= min(fa.PLAN_MAX_WARPS, (per_sm + 1) // 2)
            deeper = p.warps * ((p.stages + 1) * p.unit_bytes + p.scratch_bytes)
            assert p.stages == fa.PLAN_MAX_STAGES or deeper > fa.PLAN_SMEM_LIMIT


def test_plan_at_the_main_shapes():
    """AViT (1536 units of L 16, D 64, f32; ~12 an SM): 6 warps of a two-unit
    ring, every warp one or two units; a TransformerBlock (12288 units of
    L 16, D 32, bf16): 16 warps of two."""
    assert fa.packed_plan(16, 64, 4, 1536, SMS) == fa.PackedPlan(6, 2, 288, 13824, 1024, 172032)
    assert fa.packed_plan(16, 32, 2, 12288, SMS) == fa.PackedPlan(16, 2, 96, 4608, 1024, 163840)
    dealt = deal(1536, fa.packed_plan(16, 64, 4, 1536, SMS), SMS)
    assert {len(w) for w in dealt} == {1, 2}


@pytest.mark.parametrize("ctas_per_sm", [1, 2])
@pytest.mark.parametrize("units", [1, 5, 24, 131, 1536, 1542, 12288])
def test_deal_hands_out_every_unit_once(units, ctas_per_sm):
    for l, d, size in ((16, 64, 4), (16, 32, 2), (128, 128, 4), (1, 8, 2)):
        plan = fa.packed_plan(l, d, size, units, SMS)
        grid = fa.packed_grid(units, SMS, ctas_per_sm)
        assert grid == min(units, SMS * ctas_per_sm)
        dealt = deal(units, plan, grid)
        assert len(dealt) == grid * plan.warps
        assert sorted(u for w in dealt for u in w) == list(range(units))
        per_cta = [sum(len(w) for w in dealt[c * plan.warps:(c + 1) * plan.warps])
                   for c in range(grid)]
        assert max(per_cta) - min(per_cta) <= 1
        for w in dealt:  # each warp takes its units in order
            assert w == sorted(w)


# ---- (b) the copy rule ------------------------------------------------------------


def emulated_launch(q5, k5, v5, o5, causal, scale):
    """The launch as the kernel sees it: its inputs need no copy, and the
    output is what the kernel writes through the output view."""
    for t in (q5, k5, v5):
        assert fa.rows_aligned(t)
    o5.copy_(emulate_kernel(q5, k5, v5, causal, scale))
    fa.packed_attention.launches += 1


@pytest.fixture
def cpu_kernel(monkeypatch):
    monkeypatch.setattr(fa, "_launch", emulated_launch)
    fa.packed_attention.copies = 0
    return fa.packed_attention


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_main_path_views_need_no_copy(cpu_kernel, dtype):
    """AViT's row and column views (fused (B', H, W, heads, 3D) projection
    sliced in three), the packed (S, P, D) form and 0-2 leading axes."""
    fused = torch.from_numpy(rand(1, 2, 4, 4, 3, 3 * 16)).to(dtype)
    q, k, v = fused.chunk(3, dim=-1)
    for views in ((q, k, v), tuple(t.transpose(1, 2) for t in (q, k, v)),
                  tuple(t[0] for t in (q, k, v)), tuple(t[0, 0] for t in (q, k, v))):
        got = fa._kernel(*views, views[0].shape[-3], False, True)
        close(got.float(), fa._head_ref(*views, False).float(), *tolerance(dtype))
    packed = [torch.from_numpy(rand(2 + i, 5, 4 * 8, 16)).to(dtype) for i in range(3)]
    fa._kernel(*packed, 8, True, False)
    assert cpu_kernel.copies == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_operands_the_kernel_cannot_stage_are_copied_once(cpu_kernel, dtype):
    s, heads, l, d = 3, 4, 8, 16
    q, k, v = (torch.from_numpy(rand(10 + i, s, heads * l, d)).to(dtype) for i in range(3))
    want = fa._kernel(q, k, v, l, True, False)
    strided = k.transpose(1, 2).contiguous().transpose(1, 2)  # channel stride P
    flat = torch.zeros(k.numel() + 1, dtype=dtype)
    shifted = flat[1:].view(k.shape)  # base 2 or 4 bytes off the allocation's
    shifted.copy_(k)
    assert not fa.rows_aligned(strided[:, None].unflatten(2, (heads, l)))
    assert not fa.rows_aligned(shifted[:, None].unflatten(2, (heads, l)))
    for other in (strided, shifted):
        before = cpu_kernel.copies
        assert torch.equal(fa._kernel(q, other, v, l, True, False), want)
        assert cpu_kernel.copies == before + 1
    # Rows of 10 channels (40 or 20 bytes): all three copied into zero-padded rows.
    q, k, v = (torch.from_numpy(rand(20 + i, s, heads * l, 10)).to(dtype) for i in range(3))
    before = cpu_kernel.copies
    got = fa._kernel(q, k, v, l, False, False)
    assert cpu_kernel.copies == before + 3
    close(got.float(), fa.packed_attention_ref(q, k, v, l, False).float(), *tolerance(dtype))


def test_padded_copy_keeps_values_and_aligns_rows():
    t5 = torch.from_numpy(rand(30, 2, 1, 3, 10, 5)).transpose(-1, -2)  # channel stride 5
    padded = fa._staged(t5)
    assert fa.rows_aligned(padded) and padded.stride(-1) == 1 and padded.stride(-2) == 12
    assert torch.equal(padded, t5)
    assert torch.equal(padded._base[..., 10:], torch.zeros(2, 1, 3, 5, 2))


# ---- (c) the kernel's order of work ---------------------------------------------


def fma(a, b, c):
    """f32 fused multiply-add: the exact product and sum, rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def emulate_units(q, k, v, causal, scale, elems):
    """The kernel on (U, L, D) units of f32 values (bf16 ones for ``elems``
    = 8, whose weights are rounded to bf16), in its order of work."""
    u, l, d = q.shape
    chunks = -(-d // elems)
    parts = []
    for parity in (0, 1):  # each lane sums the chunks of its parity, in order
        acc = np.zeros((u, l, l), np.float32)
        for c in range(parity, chunks, 2):
            for ch in range(c * elems, min((c + 1) * elems, d)):
                acc = fma(q[:, :, None, ch], k[:, None, :, ch], acc)
        parts.append(acc)
    x = (parts[0] + parts[1]) * np.float32(np.float32(scale) * LOG2E)
    keep = np.tril(np.ones((l, l), bool)) if causal else np.ones((l, l), bool)
    x = np.where(keep, x, -np.inf).astype(np.float32)
    m = x.max(-1, keepdims=True)
    e = np.exp2(x - m).astype(np.float32)  # 0 where skipped
    if l <= 16:  # keys kg + 4b on lane kg, in b order; then lanes (0 + 1) + (2 + 3)
        lanes = []
        for kg in range(4):
            s = np.zeros((u, l), np.float32)
            for j in range(kg, l, 4):
                s = (s + e[..., j]).astype(np.float32)
            lanes.append(s)
        total = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])).astype(np.float32)
    else:  # each key parity in order, then the two
        halves = []
        for parity in (0, 1):
            s = np.zeros((u, l), np.float32)
            for j in range(parity, l, 2):
                s = (s + e[..., j]).astype(np.float32)
            halves.append(s)
        total = (halves[0] + halves[1]).astype(np.float32)
    w = (e / total[..., None]).astype(np.float32)
    if elems == 8:
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    out = np.zeros((u, l, d), np.float32)
    for j in range(l):  # keys in order
        out = fma(w[..., j][..., None], v[:, None, j, :], out)
    return out


def emulate_kernel(q5, k5, v5, causal, scale):
    """``emulate_units`` on (S0, S1, H, L, D) views; output in q's dtype."""
    shape = q5.shape
    units = [t.float().reshape(-1, *shape[-2:]).numpy() for t in (q5, k5, v5)]
    elems = 16 // q5.element_size()
    out = emulate_units(*units, causal, scale, elems)
    return torch.from_numpy(out).reshape(shape).to(q5.dtype)


def qkv(seed, s, nh, l, d):
    p = nh * l
    return rand(seed, s, p, d, scale=d**-0.5), rand(seed + 1, s, p, d), rand(seed + 2, s, p, d)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,nh,l,d", CORE_CASES)
def test_order_of_work_matches_the_pallas_kernel(s, nh, l, d, causal):
    q, k, v = qkv(40, s, nh, l, d)
    want = packed_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), l=l,
                                 causal=causal, seq_tile=4, interpret=True)
    units = [a.reshape(s * nh, l, d) for a in (q, k, v)]
    got = emulate_units(*units, causal, 1.0, 4).reshape(s, nh * l, d)
    close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_order_of_work_matches_packed_head_attention(causal):
    """A narrow AViT-like axial attention: (B', L 16, heads 3, D 16)
    projections, q unscaled (the kernel scales its f32 scores by D**-0.5)."""
    b, l, h, d = 4, 16, 3, 16
    q, k, v = (rand(50 + i, b, l, h, d) for i in range(3))
    want = jattn.packed_head_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    units = [a.transpose(0, 2, 1, 3).reshape(b * h, l, d) for a in (q, k, v)]
    got = emulate_units(*units, causal, d**-0.5, 4)
    close(got.reshape(b, h, l, d).transpose(0, 2, 1, 3), want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,nh,l,d", CORE_CASES)
def test_order_of_work_in_bf16_matches_the_plain_version(s, nh, l, d, causal):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv(60, s, nh, l, d))
    units = [t.float().numpy().reshape(s * nh, l, d) for t in (q, k, v)]
    got = torch.from_numpy(emulate_units(*units, causal, 1.0, 8)).to(torch.bfloat16)
    want = fa.packed_attention_ref(q, k, v, l, causal)
    close(got.float().reshape(s, nh * l, d), want.float(), BF16_TOL, BF16_TOL)
