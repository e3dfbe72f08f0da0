"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided in
the fixture, never at import, so every worker collects the same tests).
Run on the card (no JAX there, so skip the JAX conftest and the xdist addopts):
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels_gpu.py

Inputs are seeded bf16; the plain version runs in f32 from the same bf16
inputs.  Tolerance: |kernel - plain| <= 5e-2 + 2e-2 |plain| — bf16 keeps 8
mantissa bits and the kernel rounds q, k, v, the attention output, the fc1
output and both residual sums to bf16 (a CPU emulation of those rounding
points at these shapes gives a max error of 0.032 at |y| ~ 5).

The canonical T kernel and the chain run the single-block kernel's tile
body under strided row maps, with the same tile plans and rounding points.
So the canonical T kernel equals ``fused_block_apply`` on the rearranged
tensor bit for bit, and a chain of n blocks equals the single-block kernels
applied in sequence (the canonical T kernel at T inside its gate,
``fused_block_apply`` on rearranged tensors otherwise) bit for bit: any
difference is an addressing or synchronisation fault.  The chain is also
held to the f32 plain chain within CHAIN_ATOL[n] + 2e-2 |plain| (the error
grows with depth as each block rounds its activations to bf16; the first
design's chain read 0.058 at 3 blocks and 0.121 at 9 on an NVIDIA H100 80GB
HBM3 at 700 W).

The f32 instantiations (``test_f32_*``): f32 inputs and weights against the
f32 plain version with TF32 off, relative L2 <= 1e-5 and max abs <= 1e-4
max |plain| (every product three TF32 tensor-core products, 3xTF32, as
close as an f32 FMA; only the order of the sums differs), in both softmax
forms; a tile multiplies only its 16-row blocks that hold valid rows (tiles
of 48 valid rows, as a W tile holds, at most 0.85 of 64-row tiles' time on as
many tiles; a sequence in a ragged last tile bit-equal to the same sequence
in a full tile); the canonical T and chain kernels bit for bit against
the f32 single-block kernels, as in bf16; gradients through the Functions
within 1e-4 of f32 autograd; f16 and mixed dtypes refused, and f32 past
C = 256.

Both softmax forms: the "safe" cases of the JAX package's on-chip test
(``tests/test_pallas_tpu.py``, its geometries and 0.05-scaled weights) and
every single-block case again under ``set_block_tuning(softmax="safe")``, at
the same limit.

Gradients of the autograd Functions (backward = the plain version
recomputed in bf16) against ordinary autograd through the f32 plain version:
relative L2 error per tensor <= GRAD_REL.  ``bk`` is the exception: a bias on
k shifts every score of a query alike, which softmax ignores, so its true
gradient is zero and only rounding is left; it is held to GRAD_REL of the
norm of ``bq``'s gradient instead.

The mode-mixing kernel (``spectral_mode_matmul``) is f32 throughout and sums
over Cin in order with FMAs where the plain version sums four products
separately: |kernel - plain| <= 1e-4 + 1e-4 |plain| (the CPU tests' tolerance
against the Pallas kernel), plain = the four f32 einsums on the card with
TF32 off.  Its Function's gradients are the plain version's own: 1e-5.

The head-packed attention core (``packed_attention``) against its plain
version on the same inputs: f32 within 1e-5 + 1e-5 |plain| (sums in another
order), bf16 within 2e-2 + 2e-2 |plain| (the plain version rounds its AV
product to bf16; the kernel accumulates in f32 and rounds once).

The tensor-parallel halves (``attn_half_apply`` / ``mlp_half_apply``) on each
shard: limits of their own against their plain versions (a half is a
pre-bias partial with no residual, far smaller than a block's output), and
the shards'
partials summed (rounded to bf16 as the all-reduce leaves them) plus bias and
residual against the unsplit f32 block; their Functions' gradients as the
block's.  The f32 halves (``test_f32_tp_half_*``, ``fused_half_sm90_f32.cu``)
at every head dim, both softmax forms and shard widths 16 / 32 / 64 / 128: f32
inputs and weights against the f32 plain halves with TF32 off, relative L2
<= 1e-6 and max abs <= 1e-4 max |plain|; the shards' f32 partials summed,
plus bias and residual, against the unsplit f32 block kernel within 1e-6;
f32 launches counted apart from bf16; a plan past the f32 tile (C > 256)
refused.

The long entry (``fused_block_long``: the qkv kernel into a workspace, then
the attention kernel over streamed key blocks and the block's tail) at
L = 48 (below the single-block limit, through the low-level entry) to 3072,
causal and not, both softmax forms, bf16 and f32 at the block tolerances
above; the C axis's block (width 128, head dim 16), head dims 32 and 64,
C = 512 in bf16, ragged tiles; launches that mix 128-row items with 64-row
pair items (the tiles past the grid's last whole wave), two launches
bit-equal, and the launch's item counts against their Python mirror
(``long_big_tiles``, ``long_item_map``); one launch of each entry per block;
``fused_block_apply`` at L > 64 equal to it bit for bit; its plan against
the kernel's own mirror (``tante_block_long_smem``); refusals (a CPU tensor,
head dim 8, f32 past C = 256, mixed dtypes); gradients through its
Function.

The long attention half (``attn_half_apply`` at L > 64: the qkv kernel into
the shard's workspace, then the attention kernel and out-projection partial,
``fused_half_long_sm90.cu``): every shard at tp 2, 4 and 8 (the C block's
32- and 16-wide shards padded to a group), causal and not, both softmax forms, bf16
at the halves' limits and f32 at the long block's (wq / wk 2.75x wider, as
the long block's cases), one launch of each kernel a call and none of the
short half's, two launches bit-equal; launches that mix 128-row items
with pair items, and the launch's item counts against their Python mirror
(``half_long_attn_work`` against ``long_big_tiles``, ``long_item_map``);
the shards' partials + bo, then the MLP halves + b2, against
``fused_block_long``; gradients through its Function; its plan against
``tante_attn_half_long_smem``; refusals (a CPU tensor, mixed dtypes, f32
past C = 256)."""

from collections import Counter

import numpy as np
import pytest
import torch

from tante_tpu_torch.ops import fused_block as fb
from tante_tpu_torch.ops import fused_spectral as fs
from tante_tpu_torch.parallel.sharding import shard_block
from _torch_tf32 import mm3
from chip_smoke import qkv_agree, qkv_launch, qkv_operands, qkv_reference

pytestmark = pytest.mark.gpu
ATOL, RTOL = 5e-2, 2e-2
HALF_ATOL, HALF_RTOL, HALF_REL_L2 = 1.5e-2, 2e-2, 2e-2  # as chip_smoke.py
CHAIN_ATOL = {1: 5e-2, 2: 1e-1, 3: 1e-1, 9: 2.5e-1, 12: 3e-1}
GRAD_REL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    return torch.device("cuda")


def params(c, hidden, seed, device, dtype=torch.bfloat16, qk_scale=1.0):
    """One block's weights, uniform in +-1/sqrt(fan in); wq and wk
    ``qk_scale`` times that."""
    rng = np.random.default_rng(seed)

    def u(*shape, fan_in=None, scale=1.0, offset=0.0):
        bound = 1.0 / np.sqrt(fan_in or shape[0])
        a = offset + scale * rng.uniform(-bound, bound, size=shape)
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    return fb.BlockParams(
        ln1_scale=u(c, scale=0.1, offset=1.0), ln1_bias=u(c, scale=0.1),
        wq=u(c, c, scale=qk_scale), bq=u(c), wk=u(c, c, scale=qk_scale), bk=u(c), wv=u(c, c),
        bv=u(c), wo=u(c, c), bo=u(c), ln2_scale=u(c, scale=0.1, offset=1.0),
        ln2_bias=u(c, scale=0.1), w1=u(c, hidden), b1=u(hidden, fan_in=c), w2=u(hidden, c),
        b2=u(c, fan_in=hidden),
    )


def bf16_normal(shape, seed, device):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device, torch.bfloat16)


def f32(p):
    return fb.BlockParams(*(t.float() for t in p))


def all_launches() -> Counter:
    """Every block wrapper's launches so far, summed, by activation dtype."""
    return sum((fn.launches for fn in fb.WRAPPERS), Counter())


BLOCK_CASES = [
    (1536, 16, 256, 256, 8, False),   # flagship H blocks
    (512, 48, 256, 256, 8, False),    # flagship W blocks
    (512, 48, 256, 256, 8, True),
    (6144, 4, 256, 256, 8, True),     # rearranged T block
    (7, 48, 128, 256, 4, False),      # ragged tile, hidden = 2C
    (33, 16, 256, 256, 16, False),    # head dim 16
    (40, 8, 256, 512, 4, True),       # head dim 64, hidden = 2C
    (21, 3, 256, 256, 8, True),       # padded rows (63 of 64)
    (10, 16, 192, 128, 6, False),     # C and hidden not powers of two
]


@pytest.mark.parametrize("s,l,c,hidden,heads,causal", BLOCK_CASES)
def test_fused_block_kernel_matches_plain(cuda, s, l, c, hidden, heads, causal):
    p = params(c, hidden, seed=l + c, device=cuda)
    x = bf16_normal((s, l, c), seed=s, device=cuda)
    before = fb.fused_block_apply.launches.copy()
    got = fb.fused_block_apply(x, p, l, heads, causal)
    torch.cuda.synchronize()
    assert fb.fused_block_apply.launches - before == Counter({torch.bfloat16: 1})
    want = fb.block_ref(x.float(), f32(p), l, heads, causal)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


CANON_T_CASES = [
    (8, 4, 16, 48, 256, 8),   # flagship T blocks
    (2, 8, 4, 8, 128, 4),
    (1, 3, 5, 7, 256, 8),     # ragged last tile
]


def rearranged_t(x5, p, heads):
    """``fused_block_apply`` on the (B*H*W, T, C) rearrangement, back to
    canonical."""
    b, t, h, w, c = x5.shape
    y = fb.fused_block_apply(x5.permute(0, 2, 3, 1, 4).reshape(-1, t, c).contiguous(), p, t,
                             heads, True)
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4).contiguous()


@pytest.mark.parametrize("b,t,h,w,c,heads", CANON_T_CASES)
def test_fused_block_canon_t_kernel_matches_plain(cuda, b, t, h, w, c, heads):
    p = params(c, c, seed=t, device=cuda)
    x = bf16_normal((b, t, h, w, c), seed=b * t, device=cuda)
    before = fb.fused_block_canon_t.launches.copy()
    got = fb.fused_block_canon_t(x, p, heads)
    torch.cuda.synchronize()
    assert fb.fused_block_canon_t.launches - before == Counter({torch.bfloat16: 1})
    want = fb.canon_t_ref(x.float(), f32(p), heads)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


# (B, T, H, W, C, heads): T = 2, 4, 8; C = 128, 256 and 512 (64-row tiles);
# pixel counts that leave a ragged last tile and tiles that cross a batch
# element; head dims 32 and 64.
@pytest.mark.parametrize("b,t,h,w,c,heads", [
    (8, 4, 16, 48, 256, 8),   # flagship: 192 tiles of 32 pixels, none ragged
    (2, 2, 5, 7, 128, 4),     # 70 sequences in tiles of 64
    (3, 4, 5, 7, 256, 8),     # 105 in tiles of 32, across batch elements
    (2, 8, 3, 11, 512, 8),    # C = 512: 64-row tiles of 8 sequences, 66 of them
    (1, 2, 9, 9, 512, 16),    # 81 in tiles of 32
])
def test_canon_t_kernel_equals_rearranged_block_bit_for_bit(cuda, b, t, h, w, c, heads):
    p = params(c, c, seed=t + c, device=cuda)
    x = bf16_normal((b, t, h, w, c), seed=b + h * w, device=cuda)
    before = fb.fused_block_canon_t.launches.copy(), fb.fused_block_apply.launches.copy()
    got = fb.fused_block_canon_t(x, p, heads)
    torch.cuda.synchronize()
    assert (fb.fused_block_canon_t.launches - before[0], fb.fused_block_apply.launches
            - before[1]) == (Counter({torch.bfloat16: 1}), Counter())
    assert torch.equal(got, rearranged_t(x, p, heads))
    want = fb.canon_t_ref(x.float(), f32(p), heads)
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


@pytest.fixture
def safe_softmax():
    fb.set_block_tuning(softmax="safe")
    try:
        yield
    finally:
        fb.set_block_tuning(softmax="fast")


@pytest.mark.parametrize("s,l,c,hidden,heads,causal", BLOCK_CASES)
def test_fused_block_kernel_matches_plain_safe_softmax(cuda, safe_softmax, s, l, c, hidden, heads,
                                                       causal):
    test_fused_block_kernel_matches_plain(cuda, s, l, c, hidden, heads, causal)


# tests/test_pallas_tpu.py GEOMETRIES: (rows, L, causal, softmax).
@pytest.mark.parametrize("s,l,causal,softmax", [
    (6144, 4, True, "safe"), (6144, 4, True, "fast"), (1536, 16, False, "safe"),
    (512, 48, False, "safe"),
])
def test_fused_block_kernel_softmax_forms_match_plain(cuda, s, l, causal, softmax):
    c, heads = 256, 8
    rng = np.random.default_rng(l)
    x = torch.from_numpy(rng.normal(size=(s, l, c)).astype(np.float32)).to(cuda, torch.bfloat16)
    shapes = [(c,), (c,), (c, c), (c,), (c, c), (c,), (c, c), (c,), (c, c), (c,), (c,), (c,),
              (c, c), (c,), (c, c), (c,)]
    p = fb.BlockParams(*(torch.from_numpy(rng.normal(size=sh).astype(np.float32) * 0.05)
                         .to(cuda, torch.bfloat16) for sh in shapes))
    fb.set_block_tuning(softmax=softmax)
    try:
        got = fb.fused_block_apply(x, p, l, heads, causal)
        torch.cuda.synchronize()
    finally:
        fb.set_block_tuning(softmax="fast")
    want = fb.block_ref(x.float(), f32(p), l, heads, causal)
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


def test_kernel_refuses_what_it_cannot_hold(cuda):
    p = params(256, 256, seed=0, device=cuda)
    with pytest.raises(ValueError):  # f16 activations and weights: no instantiation
        fb.fused_block_apply(torch.zeros(4, 16, 256, device=cuda, dtype=torch.float16),
                             fb.BlockParams(*(t.half() for t in p)), 16, 8, False)
    with pytest.raises(ValueError):  # f32 activations, bf16 weights
        fb.fused_block_apply(torch.zeros(4, 16, 256, device=cuda), p, 16, 8, False)
    with pytest.raises(ValueError):  # a sequence longer than a tile, hidden > 2C: no long plan
        fb.fused_block_apply(bf16_normal((2, 96, 256), 0, cuda), params(256, 768, 0, cuda), 96,
                             8, False)
    p512 = params(512, 512, seed=0, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="no tile plan"):  # f32 holds C <= 256
        fb.fused_block_apply(torch.zeros(4, 16, 512, device=cuda), p512, 16, 8, False)


# --------------------------------------------------------------------------
# The f32 instantiations (the *_f32_fwd entries): against the f32 plain
# version with TF32 off, relative L2 <= 1e-5 and max abs <= 1e-4 max |plain|
# (3xTF32 products in another summation order; chip_smoke.py's limits); the
# canonical T and chain kernels bit for bit against the f32 single-block
# kernel, as in bf16.
# --------------------------------------------------------------------------

F32_REL_L2, F32_MAX_ABS_SHARE = 1e-5, 1e-4


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def f32_normal(shape, seed, device, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device)


def assert_f32_close(got, want):
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    assert rel <= F32_REL_L2 and err <= F32_MAX_ABS_SHARE * peak, (rel, err, peak)


F32_BLOCK_CASES = [c for c in BLOCK_CASES if c[2] <= 256] + [
    (1024, 32, 256, 256, 8, False),   # configs/tante.yaml's active_matter (32 x 32 tokens)
    (5, 64, 256, 256, 8, True),       # L = 64, a whole tile
]


@pytest.mark.parametrize("s,l,c,hidden,heads,causal", F32_BLOCK_CASES)
def test_f32_fused_block_kernel_matches_plain(cuda, no_tf32, s, l, c, hidden, heads, causal):
    p = params(c, hidden, seed=l + c, device=cuda, dtype=torch.float32)
    x = f32_normal((s, l, c), seed=s, device=cuda)
    before = fb.fused_block_apply.launches.copy()
    got = fb.fused_block_apply(x, p, l, heads, causal)
    torch.cuda.synchronize()
    assert fb.fused_block_apply.launches - before == Counter({torch.float32: 1})
    assert_f32_close(got, fb.block_ref(x, p, l, heads, causal))


@pytest.mark.parametrize("s,l,c,hidden,heads,causal", F32_BLOCK_CASES)
def test_f32_fused_block_kernel_matches_plain_safe_softmax(cuda, no_tf32, safe_softmax, s, l, c,
                                                           hidden, heads, causal):
    test_f32_fused_block_kernel_matches_plain(cuda, no_tf32, s, l, c, hidden, heads, causal)


def event_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def test_f32_tile_multiplies_only_its_valid_row_blocks(cuda, no_tf32):
    """The same 16-step sequences, 384 tiles of 3 (48 valid rows, as a W
    tile holds) against 384 tiles of 4 (64), through the f32 entry with the
    plan's sequences per tile set by hand: both right against the plain
    version, and the 48-row launch at most 0.85 of the other's time (its
    matmuls run 3 of 4 row blocks; with all 4 it would be ~0.95: LayerNorm
    does not shrink), the median of five timings in turns."""
    import ctypes

    from tante_tpu_torch.ops import _build

    lib = _build.load("fused_block_sm90")
    p = params(256, 256, seed=48, device=cuda, dtype=torch.float32)
    plan = fb.sm90_plan(16, 256, 256, torch.float32)
    w = fb.sm90_weights(p, 8, plan)
    ptrs, stream = fb._ptr_array([w]), torch.cuda.current_stream().cuda_stream
    runs, outs = {}, {}
    for seqs in (3, 4):
        x = f32_normal((384 * seqs, 16, 256), seed=seqs, device=cuda)
        y = torch.empty_like(x)
        plan_arr = (ctypes.c_int * 7)(*plan._replace(seqs=seqs).ints())
        runs[seqs] = (lambda x=x, y=y, pa=plan_arr: lib.tante_fused_block_sm90_f32_fwd(
            x.data_ptr(), y.data_ptr(), ptrs, pa, x.shape[0], 16, 256, 256, 8, 0, 0,
            cuda.index or 0, stream))
        assert runs[seqs]() == 0
        torch.cuda.synchronize()
        assert_f32_close(y, fb.block_ref(x, p, 16, 8, False))
    ratios = []
    for _ in range(5):
        a, b = event_ms(runs[3]), event_ms(runs[4])
        ratios.append(a / b)
    assert float(np.median(ratios)) <= 0.85, ratios


@pytest.mark.parametrize("l,n_seqs", [(16, 33), (16, 34), (16, 35), (12, 11), (20, 7), (24, 5)])
def test_f32_ragged_last_tile_rows_equal_a_full_tiles(cuda, no_tf32, l, n_seqs):
    """n_seqs not a multiple of the tile's sequences: the last tile holds 1
    to 3 row blocks (some partly valid).  Its sequences equal, bit for bit,
    the same sequences in a launch where their tile is full, and the plain
    version within the f32 limits."""
    p = params(256, 256, seed=l, device=cuda, dtype=torch.float32)
    seqs = fb.sm90_plan(l, 256, 256, torch.float32).seqs
    full = -(-n_seqs // seqs) * seqs
    x = f32_normal((full, l, 256), seed=n_seqs, device=cuda)
    ragged = fb.fused_block_apply(x[:n_seqs].contiguous(), p, l, 8, False)
    whole = fb.fused_block_apply(x, p, l, 8, False)
    torch.cuda.synchronize()
    assert n_seqs % seqs and torch.equal(ragged, whole[:n_seqs])
    assert_f32_close(ragged, fb.block_ref(x[:n_seqs], p, l, 8, False))


@pytest.mark.parametrize("b,t,h,w,c,heads", [
    (8, 4, 16, 48, 256, 8), (2, 2, 5, 7, 128, 4), (3, 4, 5, 7, 256, 8), (1, 8, 9, 9, 256, 16),
    (1, 8, 3, 5, 256, 8), (2, 6, 4, 3, 256, 8)])
def test_f32_canon_t_kernel_equals_rearranged_block_bit_for_bit(cuda, no_tf32, b, t, h, w, c,
                                                                 heads):
    p = params(c, c, seed=t + c, device=cuda, dtype=torch.float32)
    x = f32_normal((b, t, h, w, c), seed=b + h * w, device=cuda)
    before = fb.fused_block_canon_t.launches.copy()
    got = fb.fused_block_canon_t(x, p, heads)
    torch.cuda.synchronize()
    assert fb.fused_block_canon_t.launches - before == Counter({torch.float32: 1})
    assert torch.equal(got, rearranged_t(x, p, heads))
    assert_f32_close(got, fb.canon_t_ref(x, p, heads))


@pytest.mark.parametrize("b,t,h,w,c,heads,axes", [
    (8, 4, 16, 48, 256, 8, "THW"), (8, 4, 16, 48, 256, 8, "THWTHWTHW"),
    (3, 2, 5, 7, 128, 4, "HW"), (2, 8, 4, 8, 128, 4, "WT"), (2, 4, 8, 12, 128, 4, "THWTHWTHWTHW"),
    (2, 4, 16, 48, 256, 8, "WHT"), (3, 12, 5, 20, 256, 8, "TWH")])
def test_f32_chain_kernel_equals_sequence_and_matches_plain(cuda, no_tf32, b, t, h, w, c, heads,
                                                            axes):
    ps = [params(c, c, seed=10 * i + t, device=cuda, dtype=torch.float32)
          for i in range(len(axes))]
    x5 = f32_normal((b, t, h, w, c), seed=b + h, device=cuda)
    before = fb.fused_group_apply.launches.copy(), fb.fused_chain_apply.launches.copy()
    got5 = fb.fused_group_apply(x5, ps, axes, heads)
    got3 = fb.fused_chain_apply(to_order(x5, axes[0]), ps, axes, heads, (t, h, w))
    torch.cuda.synchronize()
    assert (fb.fused_group_apply.launches - before[0], fb.fused_chain_apply.launches
            - before[1]) == (Counter({torch.float32: 1}),) * 2
    seq = sequential(x5, ps, axes, heads)
    assert torch.equal(got5, seq)
    assert torch.equal(got3, to_order(seq, axes[-1]))
    assert_f32_close(got5, fb.group_ref(x5, ps, axes, heads))


@pytest.mark.parametrize("kind,shape,axes", [
    ("block", (1536, 16, 256), "H"), ("canon_t", (8, 4, 16, 48, 256), "T"),
    ("chain", (8, 4, 16, 48, 256), "THW")])
def test_f32_kernel_gradients_match_plain_autograd(cuda, no_tf32, kind, shape, axes):
    """The backward is the plain version's, fed the f32 kernel's output."""
    heads = 8
    ps = [params(256, 256, seed=3 * i + 1, device=cuda, dtype=torch.float32)
          for i in range(len(axes))]
    x = f32_normal(shape, seed=5, device=cuda)

    def run(x, ps, kernel):
        if kind == "block":
            return (fb.fused_block_apply if kernel else fb.block_ref)(x, ps[0], 16, heads, False)
        if kind == "canon_t":
            return (fb.fused_block_canon_t if kernel else fb.canon_t_ref)(x, ps[0], heads)
        fn = fb.fused_chain_apply if kernel else fb.chain_ref
        return fn(to_order(x, axes[0]), ps, axes, heads, shape[1:4])

    def grads(kernel):
        xl = x.detach().requires_grad_(True)
        pl = [fb.BlockParams(*(t.detach().requires_grad_(True) for t in p)) for p in ps]
        (run(xl, pl, kernel) ** 2).sum().backward()
        return [xl.grad] + [t.grad for p in pl for t in p]

    before = all_launches()
    got = grads(True)
    assert all_launches() - before == Counter({torch.float32: 1})
    want = grads(False)
    names = ["x"] + [f"{f}[{i}]" for i in range(len(ps)) for f in fb.BlockParams._fields]
    ref = dict(zip(names, want))
    errs = {n: float(torch.linalg.norm(g - w) / torch.linalg.norm(ref[n.replace("bk[", "bq[")]))
            for n, g, w in zip(names, got, want)}
    assert max(errs.values()) <= 1e-4, errs


def sequential(x5, ps, axes, heads):
    """The single-block kernels applied one after the other, as the
    per-block backbone path does."""
    b, t, h, w, c = x5.shape
    x = x5
    for axis, p in zip(axes, ps):
        if axis == "T" and fb.canon_t_supported(t, h, w, c, heads):
            x = fb.fused_block_canon_t(x.contiguous(), p, heads)
        elif axis == "T":
            y = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c).contiguous()
            y = fb.fused_block_apply(y, p, t, heads, True)
            x = y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
        elif axis == "H":
            y = x.permute(0, 1, 3, 2, 4).reshape(b * t * w, h, c).contiguous()
            y = fb.fused_block_apply(y, p, h, heads, False)
            x = y.reshape(b, t, w, h, c).permute(0, 1, 3, 2, 4)
        else:
            y = fb.fused_block_apply(x.reshape(b * t * h, w, c).contiguous(), p, w, heads, False)
            x = y.reshape(b, t, h, w, c)
    return x.contiguous()


_TO_ORDER = {"T": (0, 2, 3, 1, 4), "H": (0, 1, 3, 2, 4), "W": (0, 1, 2, 3, 4)}


def to_order(x5, axis):
    """(B, T, H, W, C) -> (S, L, C) in ``axis``'s token order."""
    l = x5.shape[1 + "THW".index(axis)]
    return x5.permute(_TO_ORDER[axis]).reshape(-1, l, x5.shape[-1]).contiguous()


CHAIN_CASES = [
    (8, 4, 16, 48, 256, 8, "THW"),         # flagship sub-chain
    (8, 4, 16, 48, 256, 8, "THWTHWTHW"),   # flagship whole group
    (3, 4, 16, 48, 256, 8, "TH"),          # ragged B
    (3, 2, 5, 7, 128, 4, "HW"),            # T = 2, ragged tiles
    (2, 8, 4, 8, 128, 4, "WT"),            # T = 8, starts on W, ends on T
    (1, 3, 6, 10, 192, 6, "THW"),          # C = 192: T outside the canonical gate
    (5, 4, 16, 16, 256, 8, "H"),           # a run of one
    (2, 4, 6, 10, 512, 8, "THW"),          # C = 512: 64-row tiles
    (2, 4, 8, 12, 128, 4, "THWTHWTHWTHW"), # twelve blocks, the most a launch takes
]


@pytest.mark.parametrize("b,t,h,w,c,heads,axes", CHAIN_CASES)
def test_chain_kernel_matches_sequence_and_plain(cuda, b, t, h, w, c, heads, axes):
    ps = [params(c, c, seed=10 * i + t, device=cuda) for i in range(len(axes))]
    x5 = bf16_normal((b, t, h, w, c), seed=b + h, device=cuda)
    before = fb.fused_group_apply.launches.copy(), fb.fused_chain_apply.launches.copy()
    got5 = fb.fused_group_apply(x5, ps, axes, heads)
    got3 = fb.fused_chain_apply(to_order(x5, axes[0]), ps, axes, heads, (t, h, w))
    torch.cuda.synchronize()
    assert (fb.fused_group_apply.launches - before[0], fb.fused_chain_apply.launches
            - before[1]) == (Counter({torch.bfloat16: 1}),) * 2
    seq = sequential(x5, ps, axes, heads)
    assert torch.equal(got5, seq)
    assert torch.equal(got3, to_order(seq, axes[-1]))
    want = fb.group_ref(x5.float(), [f32(p) for p in ps], axes, heads)
    err = float((got5.float() - want).abs().max())
    print(f"chain {axes} {tuple(x5.shape)}: max abs err vs f32 plain {err:.4f}")
    torch.testing.assert_close(got5.float(), want, atol=CHAIN_ATOL[len(axes)], rtol=RTOL)


@pytest.mark.parametrize("b,t,h,w,c,heads,axes", [(8, 4, 16, 48, 256, 8, "THW"),
                                                   (3, 2, 5, 7, 128, 4, "HW")])
def test_chain_kernel_safe_softmax_matches_sequence_and_plain(cuda, safe_softmax, b, t, h, w, c,
                                                              heads, axes):
    test_chain_kernel_matches_sequence_and_plain(cuda, b, t, h, w, c, heads, axes)


@pytest.mark.parametrize("b,t,h,w,c,heads,axes", [
    (8, 4, 16, 48, 256, 8, "THWTHWTHW"), (2, 4, 6, 10, 512, 8, "THW"),
    (2, 4, 8, 12, 128, 4, "THWTHWTHWTHW")])
def test_chain_kernel_safe_softmax_equals_sequence_more_cases(cuda, safe_softmax, b, t, h, w, c,
                                                              heads, axes):
    test_chain_kernel_matches_sequence_and_plain(cuda, b, t, h, w, c, heads, axes)


def test_first_design_entries_still_run(cuda):
    """The canonical T and chain entries of ``fused_block.cu`` (on no model
    path; the measurement scripts' baseline) against the plain versions."""
    b, t, h, w, c, heads = 2, 4, 16, 48, 256, 8
    ps = [params(c, c, seed=40 + i, device=cuda) for i in range(3)]
    x5 = bf16_normal((b, t, h, w, c), seed=41, device=cuda)
    counts = all_launches()
    got_t = fb.block_tile_canon_t(x5, ps[0], heads)
    got_c = fb.block_tile_chain(x5, ps, "THW", heads, (t, h, w))
    torch.cuda.synchronize()
    assert all_launches() == counts
    torch.testing.assert_close(got_t.float(), fb.canon_t_ref(x5.float(), f32(ps[0]), heads),
                               atol=ATOL, rtol=RTOL)
    want = fb.group_ref(x5.float(), [f32(p) for p in ps], "THW", heads)
    torch.testing.assert_close(got_c.float(), want, atol=CHAIN_ATOL[3], rtol=RTOL)


def test_chain_kernel_refuses_outside_its_envelope(cuda):
    ps = [params(256, 256, seed=i, device=cuda) for i in range(2)]
    with pytest.raises(ValueError):  # an axis longer than a tile
        fb.fused_group_apply(bf16_normal((1, 4, 96, 8, 256), 0, cuda), ps, "TH", 8)
    with pytest.raises(ValueError):  # an axis the chain does not know
        fb.fused_group_apply(bf16_normal((1, 4, 8, 8, 256), 0, cuda), ps, "TL", 8)
    with pytest.raises(ValueError):  # one parameter set too few
        fb.fused_group_apply(bf16_normal((1, 4, 8, 8, 256), 0, cuda), ps, "THW", 8)


@pytest.mark.parametrize("kind,shape,axes", [
    ("block", (1536, 16, 256), "H"),
    ("block", (512, 48, 256), "W"),
    ("canon_t", (8, 4, 16, 48, 256), "T"),
    ("chain", (8, 4, 16, 48, 256), "THW"),
    ("group", (2, 4, 16, 48, 256), "THWTHW"),
])
def test_kernel_gradients_match_plain_autograd(cuda, kind, shape, axes):
    heads, c = 8, shape[-1]
    ps = [params(c, c, seed=3 * i + 1, device=cuda) for i in range(len(axes))]
    x = bf16_normal(shape, seed=5, device=cuda)

    def run(x, ps, kernel):
        if kind == "block":
            fn = fb.fused_block_apply if kernel else fb.block_ref
            return fn(x, ps[0], shape[1], heads, False)
        if kind == "canon_t":
            return (fb.fused_block_canon_t if kernel else fb.canon_t_ref)(x, ps[0], heads)
        if kind == "group":
            return (fb.fused_group_apply if kernel else fb.group_ref)(x, ps, axes, heads)
        dims = shape[1:4]
        fn = fb.fused_chain_apply if kernel else fb.chain_ref
        return fn(to_order(x, axes[0]), ps, axes, heads, dims)

    def grads(x, ps, kernel):
        x = x.detach().requires_grad_(True)
        ps = [fb.BlockParams(*(t.detach().requires_grad_(True) for t in p)) for p in ps]
        (run(x, ps, kernel).float() ** 2).sum().backward()
        return [x.grad] + [t.grad for p in ps for t in p]

    before = all_launches()
    got = grads(x, ps, kernel=True)
    assert all_launches() - before == Counter({torch.bfloat16: 1})  # forward only
    want = grads(x.float(), [f32(p) for p in ps], kernel=False)
    names = ["x"] + [f"{f}[{i}]" for i in range(len(ps)) for f in fb.BlockParams._fields]
    ref = dict(zip(names, want))
    errs = {n: float(torch.linalg.norm(g.float() - w)
                     / torch.linalg.norm(ref[n.replace("bk[", "bq[")]))
            for n, g, w in zip(names, got, want)}
    print(f"grad {kind} {axes}: worst {max(errs, key=errs.get)} {max(errs.values()):.4f}")
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(errs.values()) <= GRAD_REL, errs


# --------------------------------------------------------------------------
# spectral_mode_matmul
# --------------------------------------------------------------------------


def f32_normal(shape, seed, device, scale=1.0):
    a = scale * np.random.default_rng(seed).normal(size=shape)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def spectral_operands(b, modes, ci, co, layout, device, seed=0):
    """x_re, x_im (B, *modes, Cin) and w_re, w_im (*modes, Cin, Cout) as the
    call sites hand them over.  ``stored``: the weight as the models keep it,
    (Cin, Cout, *modes, 2), through permuted views; ``cw``: that, and x
    channel-major (B, ..., Cin, L) seen as (B, ..., L, Cin); ``complex``:
    that weight, and x the re / im views of a complex tensor (an FFT slice);
    ``contiguous``: (M, Cin, Cout) weights of their own, the Pallas entry's
    signature."""
    n = len(modes)
    scale = 1.0 / np.sqrt(ci)
    if layout == "contiguous":
        w_re, w_im = (f32_normal((*modes, ci, co), seed + 2 + i, device, scale) for i in range(2))
    else:
        w = f32_normal((ci, co, *modes, 2), seed + 2, device, scale)
        perm = (*range(2, 2 + n), 0, 1)
        w_re, w_im = w[..., 0].permute(perm), w[..., 1].permute(perm)
    if layout == "complex":
        z = torch.view_as_complex(f32_normal((b, *modes, ci, 2), seed, device))
        return z.real, z.imag, w_re, w_im
    x_re, x_im = (f32_normal((b, *modes, ci), seed + i, device) for i in range(2))
    if layout == "cw":
        x_re, x_im = (t.transpose(-1, -2).contiguous().transpose(-1, -2) for t in (x_re, x_im))
    return x_re, x_im, w_re, w_im


SPECTRAL_CASES = [
    # TANTE-FNO flagship (embed 256, modes 32x32, stages (4, 2)); both corners in the batch
    (64, (32, 32), 4, 32, "stored"),     # encoder layer 1, the first window (2 * 8 * 4 frames)
    (16, (32, 32), 4, 32, "stored"),     # encoder layer 1, one new frame per sample
    (16, (8, 8), 64, 128, "stored"),     # encoder layer 2
    (16, (8, 8), 128, 64, "stored"),     # decoder layer 1
    (16, (32, 32), 32, 4, "stored"),     # decoder layer 2
    # FNO / TFNO, configs/fno.yaml: hidden 48, centered modes 20 x 11, B=4
    (4, (20, 11), 48, 48, "cw"),
    (4, (20, 11), 48, 48, "stored"),
    (4, (220,), 48, 48, "contiguous"),
    # UNO, configs/uno.yaml width 38: channel counts that are multiples of nothing
    (4, (32, 33), 38, 76, "stored"),
    (4, (4, 5), 304, 152, "stored"),
    # ragged
    (1, (7,), 4, 4, "contiguous"),
    (3, (13, 5), 38, 48, "stored"),
    (3, (5, 3), 128, 38, "cw"),
    (9, (6, 5), 48, 128, "complex"),     # a second batch tile, x from a complex tensor
    (2, (4, 3, 5), 8, 12, "complex"),    # three mode axes (the 3-D convolution's corners)
    (1, (33,), 1, 1, "contiguous"),
]


@pytest.mark.parametrize("b,modes,ci,co,layout", SPECTRAL_CASES)
def test_spectral_mode_matmul_kernel_matches_plain(cuda, b, modes, ci, co, layout):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = spectral_operands(b, modes, ci, co, layout, cuda)
    before = fs.spectral_mode_matmul.launches
    got = fs.spectral_mode_matmul(*args)
    torch.cuda.synchronize()
    assert fs.spectral_mode_matmul.launches == before + 1
    want = fs.spectral_mode_matmul_ref(*args)
    for g, w in zip(got, want):
        assert g.shape == (b, *modes, co) and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    if layout == "cw":  # the result keeps x's memory order: (B, ..., Cout, L) dense
        assert got[0].transpose(-1, -2).is_contiguous()


def test_spectral_kernel_refuses_what_it_cannot_take(cuda):
    xr, xi, wr, wi = spectral_operands(2, (3, 4), 5, 6, "stored", cuda)
    with pytest.raises(ValueError):  # f64
        fs.spectral_mode_matmul(xr.double(), xi.double(), wr.double(), wi.double())
    with pytest.raises(ValueError):  # the weight on another device
        fs.spectral_mode_matmul(xr, xi, wr.cpu(), wi.cpu())
    x4 = torch.zeros(1, 2, 2, 2, 2, 3, device=cuda)
    w4 = torch.zeros(2, 2, 2, 2, 3, 3, device=cuda)
    with pytest.raises(ValueError):  # four mode axes
        fs.spectral_mode_matmul(x4, x4, w4, w4)


@pytest.mark.parametrize("b,modes,ci,co,layout", [
    (4, (20, 11), 48, 48, "cw"), (16, (8, 8), 64, 128, "stored"), (3, (7,), 4, 38, "contiguous")])
def test_spectral_function_gradients_match_plain_autograd(cuda, b, modes, ci, co, layout):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = spectral_operands(b, modes, ci, co, layout, cuda)
    cot = [f32_normal((b, *modes, co), 20 + i, cuda) for i in range(2)]

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in args]
        o_re, o_im = fn(*leaves)
        ((o_re * cot[0]).sum() + (o_im * cot[1]).sum()).backward()
        return [t.grad for t in leaves]

    before = fs.spectral_mode_matmul.launches
    got = grads(fs.spectral_mode_matmul)
    assert fs.spectral_mode_matmul.launches == before + 1  # forward only
    for g, w in zip(got, grads(fs.spectral_mode_matmul_ref)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# The FNO baselines on the card: every model through the mode-mixing kernel
# --------------------------------------------------------------------------


def _family_case(name):
    """(model class, constructor arguments, input shape) at a small size."""
    from tante_tpu_torch.data.metadata import TanteMetadata
    from tante_tpu_torch.models import FNO, TFNO, UNO

    def md(res):
        return TanteMetadata(
            dataset_name="t", n_spatial_dims=len(res), spatial_resolution=tuple(res),
            field_names={0: ["f"] * 4, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
            n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[16], n_fields=4)

    fno = dict(in_T=4, modes1=8, modes2=8, hidden_channels=16, n_layers=2)
    return {
        "fno_cw": (FNO, dict(dset_metadata=md((32, 48)), **fno), (2, 4, 32, 48, 4)),
        "fno_wc": (FNO, dict(dset_metadata=md((32, 48)), layout="wc", **fno), (2, 4, 32, 48, 4)),
        "fno_3d": (FNO, dict(dset_metadata=md((6, 8, 10)), in_T=2, modes1=4, modes2=4, modes3=6,
                             hidden_channels=8, n_layers=2), (1, 2, 6, 8, 10, 4)),
        "tfno": (TFNO, dict(dset_metadata=md((32, 48)), **fno), (2, 4, 32, 48, 4)),
        "uno": (UNO, dict(in_T=4, dset_metadata=md((64, 96)), width=6), (2, 4, 64, 96, 4)),
    }[name]


@pytest.mark.parametrize("name", ["fno_cw", "fno_wc", "fno_3d", "tfno", "uno"])
def test_fno_family_on_the_card_matches_the_cpu(cuda, name):
    """f32, the same seeded weights: forward and parameter gradients on the
    card (mode mixing in the kernel, its backward through the plain version)
    against the CPU (plain version throughout).  1e-3: f32 matmuls summed in
    another order through a few layers.  (TANTE with the FNO encoder/decoder
    needs bf16 for its block kernels: ``chip_smoke.py`` holds it to the CPU.)"""
    from tante_tpu_torch.convert import load_jax_params, seeded_jax_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cls, kw, shape = _family_case(name)
    cpu, gpu = cls(device="cpu", **kw), cls(device=cuda, **kw)
    flat = seeded_jax_params(cpu, seed=3)
    load_jax_params(cpu, flat)
    load_jax_params(gpu, flat)
    x = f32_normal(shape, 9, "cpu")

    def run(model, x):
        model.zero_grad(set_to_none=True)
        y = model(x)
        y.square().mean().backward()
        return y.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()}

    before = fs.spectral_mode_matmul.launches
    got, got_grads = run(gpu, x.to(cuda))
    assert fs.spectral_mode_matmul.launches > before
    want, want_grads = run(cpu, x)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    for k, g in want_grads.items():
        scale = float(g.abs().max())
        torch.testing.assert_close(got_grads[k], g, atol=1e-3 * scale + 1e-7, rtol=1e-3, msg=k)


# --------------------------------------------------------------------------
# The head-packed attention core (``packed_attention``): f32 and bf16
# --------------------------------------------------------------------------

# (S, heads, L, D): the AViT shape (embed 384, 6 heads, a 16 x 16 patch grid),
# the cases of tests/test_pallas_kernels.py, the flagship-width TransformerBlock
# (C 256, 8 heads of 32 over L = 16), and the envelope's corners.
PACKED_CASES = [
    (256, 6, 16, 64), (10, 8, 16, 32), (7, 4, 4, 16), (1536, 8, 16, 32),
    (3, 1, 128, 128), (5, 128, 1, 8), (9, 3, 5, 24),
]


def packed_tolerance(dtype):
    """f32: the kernel sums in another order (1e-5); bf16: the plain version
    rounds its AV product to bf16 on the way (2e-2)."""
    return (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,heads,l,d", PACKED_CASES)
def test_packed_attention_kernel_matches_plain(cuda, s, heads, l, d, causal, dtype):
    from tante_tpu_torch.ops import fused_attention as fa

    p = heads * l
    q, k, v = (f32_normal((s, p, d), 40 + i, cuda).to(dtype) for i in range(3))
    q = q * d**-0.5
    before = fa.packed_attention.launches
    got = fa.packed_attention(q, k, v, l, causal)
    torch.cuda.synchronize()
    assert fa.packed_attention.launches == before + 1
    want = fa.packed_attention_ref(q, k, v, l, causal)
    assert got.shape == (s, p, d) and got.dtype == dtype
    atol, rtol = packed_tolerance(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_packed_head_attention_on_strided_views(cuda, dtype):
    """The AViT block's operands: q / k / v as strided slices of one fused
    projection, row views (B', H, W, heads, D) and column views (transposed
    H and W), written into a contiguous output, against the plain version."""
    from tante_tpu_torch.ops import fused_attention as fa

    fused = f32_normal((4, 16, 12, 6, 3 * 64), 50, cuda).to(dtype)
    q, k, v = fused.chunk(3, dim=-1)
    atol, rtol = packed_tolerance(dtype)
    for views in ((q, k, v), tuple(t.transpose(1, 2) for t in (q, k, v))):
        got = fa.packed_head_attention(*views)
        assert got.is_contiguous() and got.shape == views[0].shape
        want = fa._head_ref(*views, False)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_packed_attention_refuses_what_it_cannot_take(cuda):
    from tante_tpu_torch.ops import fused_attention as fa

    q = torch.zeros(2, 129, 16, device=cuda)
    with pytest.raises(ValueError):  # heads * L > 128
        fa.packed_attention(q, q, q, 129)
    q = torch.zeros(2, 16, 4, device=cuda)
    with pytest.raises(ValueError):  # D < 8
        fa.packed_attention(q, q, q, 4)
    q = torch.zeros(2, 16, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):  # f16
        fa.packed_attention(q, q, q, 4)


@pytest.mark.parametrize("heads_last", [False, True])
def test_packed_attention_function_gradients_match_plain_autograd(cuda, heads_last):
    from tante_tpu_torch.ops import fused_attention as fa

    s, heads, l, d = 64, 6, 16, 64
    shape = (s, l, heads, d) if heads_last else (s, heads * l, d)
    args = [f32_normal(shape, 60 + i, cuda) for i in range(3)]
    cot = f32_normal(shape, 63, cuda)
    fn = fa.packed_head_attention if heads_last else (
        lambda a, b, c: fa.packed_attention(a, b, c, l, True))
    plain = (lambda a, b, c: fa._head_ref(a, b, c, False)) if heads_last else (
        lambda a, b, c: fa.packed_attention_ref(a, b, c, l, True))

    def grads(f):
        leaves = [t.detach().requires_grad_(True) for t in args]
        (f(*leaves) * cot).sum().backward()
        return [t.grad for t in leaves]

    before = fa.packed_attention.launches
    got = grads(fn)
    assert fa.packed_attention.launches == before + 1  # forward only
    for g, w in zip(got, grads(plain)):
        assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) <= 1e-5


@pytest.mark.parametrize("name", ["avit", "cvit"])
def test_attention_family_on_the_card_matches_the_cpu(cuda, name):
    """f32, the same seeded weights, small widths: forward and parameter
    gradients on the card against the CPU.  AViT's axial attentions go
    through the kernel (4 launches a call here: 2 blocks, row and column);
    CViT's encoder at 6 tokens x 4 heads takes the packed branch too (2).
    1e-3: f32 matmuls summed in another order through a few layers."""
    from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
    from tante_tpu_torch.data.metadata import TanteMetadata
    from tante_tpu_torch.models import AViT, CViT
    from tante_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    md = TanteMetadata(
        dataset_name="t", n_spatial_dims=2, spatial_resolution=(32, 48),
        field_names={0: ["f"] * 4, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
        n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[16], n_fields=4)
    if name == "avit":
        cls, launches = AViT, 4
        kw = dict(in_T=4, embed_dim=32, num_heads=4, processor_blocks=2, drop_path=0.0)
    else:
        cls, launches = CViT, 2
        kw = dict(in_T=4, out_steps=2, grid_size=(8, 8), latent_dim=16, emb_dim=32, depth=2,
                  num_heads=4, dec_emb_dim=32, dec_num_heads=4)
    cpu, gpu = cls(dset_metadata=md, device="cpu", **kw), cls(dset_metadata=md, device=cuda, **kw)
    flat = seeded_jax_params(cpu, seed=3)
    load_jax_params(cpu, flat)
    load_jax_params(gpu, flat)
    x = f32_normal((2, 4, 32, 48, 4), 9, "cpu")

    def run(model, x):
        model.zero_grad(set_to_none=True)
        y = model(x)
        y.square().mean().backward()
        return y.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()
                                  if p.grad is not None}

    before = fa.packed_attention.launches
    got, got_grads = run(gpu, x.to(cuda))
    assert fa.packed_attention.launches == before + launches
    want, want_grads = run(cpu, x)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    assert set(got_grads) == set(want_grads)
    for k, g in want_grads.items():
        scale = float(g.abs().max())
        torch.testing.assert_close(got_grads[k], g, atol=1e-3 * scale + 1e-7, rtol=1e-3, msg=k)


# The persistent schedule's edges (S, heads, L, D): one sequence; fewer units
# than SMs; a unit count that is no multiple of the grid (1542 units on 132 x
# 8 warps); P = 128 as 8 x 16 and 4 x 32; D = 8 and 128; L = 1.
PACKED_EDGE_CASES = [
    (1, 6, 16, 64), (4, 6, 16, 64), (257, 6, 16, 64), (64, 8, 16, 64), (64, 4, 32, 64),
    (33, 4, 16, 8), (33, 4, 16, 128), (40, 16, 1, 32),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,heads,l,d", PACKED_EDGE_CASES)
def test_packed_attention_schedule_edges_match_plain(cuda, s, heads, l, d, causal, dtype):
    from tante_tpu_torch.ops import fused_attention as fa

    p = heads * l
    q, k, v = (f32_normal((s, p, d), 70 + i, cuda).to(dtype) for i in range(3))
    q = q * d**-0.5
    copies = fa.packed_attention.copies
    got = fa.packed_attention(q, k, v, l, causal)
    torch.cuda.synchronize()
    assert fa.packed_attention.copies == copies
    atol, rtol = packed_tolerance(dtype)
    want = fa.packed_attention_ref(q, k, v, l, causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # Two launches on one input: the same order of work, whichever warp takes a unit.
    assert torch.equal(fa.packed_attention(q, k, v, l, causal), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_packed_attention_copy_path_equals_the_contiguous_call(cuda, dtype):
    """An operand with channel stride != 1, one off a 16-byte boundary, and
    rows of D * itemsize bytes that are no multiple of 16 (D = 10, 14): the
    wrapper copies each (counted) and the output equals the call on
    contiguous operands bit for bit; the aligned views need no copy."""
    from tante_tpu_torch.ops import fused_attention as fa

    s, heads, l, d = 9, 4, 16, 32
    q, k, v = (f32_normal((s, heads * l, d), 80 + i, cuda).to(dtype) for i in range(3))
    want = fa.packed_attention(q, k, v, l, True)
    strided = k.transpose(1, 2).contiguous().transpose(1, 2)  # channel stride P
    flat = torch.zeros(k.numel() + 1, device=cuda, dtype=dtype)
    shifted = flat[1:].view(k.shape)  # base 2 or 4 bytes past the allocation's
    shifted.copy_(k)
    for other in (strided, shifted):
        copies = fa.packed_attention.copies
        got = fa.packed_attention(q, other, v, l, True)
        assert fa.packed_attention.copies == copies + 1
        assert torch.equal(got, want)
    for d in (10, 14):  # zero-padded rows
        q, k, v = (f32_normal((s, heads * l, d), 90 + i, cuda).to(dtype) for i in range(3))
        copies = fa.packed_attention.copies
        got = fa.packed_attention(q, k, v, l, False)
        torch.cuda.synchronize()
        assert fa.packed_attention.copies == copies + 3
        atol, rtol = packed_tolerance(dtype)
        want = fa.packed_attention_ref(q, k, v, l, False)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    fused = f32_normal((4, 16, 16, 6, 3 * 64), 95, cuda).to(dtype)  # AViT's row / column views
    q, k, v = fused.chunk(3, dim=-1)
    copies = fa.packed_attention.copies
    for views in ((q, k, v), tuple(t.transpose(1, 2) for t in (q, k, v))):
        fa.packed_head_attention(*views)
    assert fa.packed_attention.copies == copies


def test_packed_attention_plan_matches_its_mirror(cuda):
    """The library's plan over the envelope equals ``packed_plan``, and the
    persistent grid is the resident CTAs or the units' need."""
    from tante_tpu_torch.ops import fused_attention as fa

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.finfo(dtype).bits // 8
        for heads, l in ((1, 1), (6, 16), (8, 16), (4, 32), (2, 64), (1, 128), (16, 5)):
            for d in (8, 24, 64, 128):
                for s in (1, 256):
                    got = fa.launch_plan(s, 1, heads, l, d, dtype)
                    plan = fa.packed_plan(l, d, size, s * heads, sms)
                    assert tuple(got[f] for f in fa.PackedPlan._fields) == plan
                    assert got["ctas_per_sm"] >= 1
                    assert got["grid"] == fa.packed_grid(s * heads, sms, got["ctas_per_sm"])


# ---- the tensor-parallel halves (fused_block_apply_tp) ------------------------

def halves(p):
    return (fb.AttnHalfParams(*(getattr(p, f) for f in fb.AttnHalfParams._fields)),
            fb.MlpHalfParams(*(getattr(p, f) for f in fb.MlpHalfParams._fields)))


def assert_half_close(got, want):
    torch.testing.assert_close(got.float(), want, atol=HALF_ATOL, rtol=HALF_RTOL)
    assert torch.linalg.norm(got.float() - want) <= HALF_REL_L2 * torch.linalg.norm(want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("s,l,c,hidden,heads,causal", [
    (1536, 16, 256, 256, 8, False),   # flagship H blocks
    (512, 48, 256, 256, 8, False),    # flagship W blocks
    (6144, 4, 256, 256, 8, True),     # flagship T blocks, rearranged
    (37, 16, 256, 256, 8, True),      # ragged last tile
    (21, 3, 256, 256, 8, True),       # padded rows (63 of 64)
    (7, 48, 128, 256, 4, False),      # out-projection N = C = 128 < 256, hidden = 2C
])
def test_tp_half_kernels_match_plain(cuda, tp, s, l, c, hidden, heads, causal):
    """Each shard's halves against their plain versions; their sum over the
    shards, plus bias and residual, against the unsplit f32 block."""
    p = params(c, hidden, seed=l + c + tp, device=cuda)
    x = bf16_normal((s, l, c), seed=s + tp, device=cuda)
    attn_sum = torch.zeros(x.shape, device=cuda)
    parts = []
    before = fb.attn_half_apply.launches.copy(), fb.mlp_half_apply.launches.copy()
    for r in range(tp):
        ap, mp = halves(shard_block(p, tp, r))
        apf, mpf = halves(f32(shard_block(p, tp, r)))
        got = fb.attn_half_apply(x, ap, l, heads // tp, causal)
        torch.cuda.synchronize()
        want = fb.attn_half_ref(x.float(), apf, l, heads // tp, causal)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        assert_half_close(got, want)
        attn_sum += got.float()
        parts.append(mp)
        got = fb.mlp_half_apply(x, mp)
        torch.cuda.synchronize()
        assert_half_close(got, fb.mlp_half_ref(x.float(), mpf))
    assert (fb.attn_half_apply.launches - before[0], fb.mlp_half_apply.launches
            - before[1]) == (Counter({torch.bfloat16: tp}),) * 2
    xm = (x.float() + attn_sum.to(torch.bfloat16).float() + p.bo.float()).to(torch.bfloat16)
    mlp_sum = sum(fb.mlp_half_apply(xm, mp).float() for mp in parts)
    y = xm.float() + mlp_sum.to(torch.bfloat16).float() + p.b2.float()
    want = fb.block_ref(x.float(), f32(p), l, heads, causal)
    torch.testing.assert_close(y, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s,l,causal", [(1536, 16, False), (6144, 4, True)])
def test_tp_half_kernels_safe_softmax_match_plain(cuda, safe_softmax, s, l, causal):
    test_tp_half_kernels_match_plain(cuda, 2, s, l, 256, 256, 8, causal)


@pytest.mark.parametrize("s,l,causal", [(1536, 16, False), (6144, 4, True), (7, 48, False)])
def test_tp_half_kernels_match_plain_tp8(cuda, s, l, causal):
    """tp = 8 at the flagship width: 32-wide shards (one head of d = 32, a
    32-wide hidden shard), zero-padded to one 64-column group."""
    test_tp_half_kernels_match_plain(cuda, 8, s, l, 256, 256, 8, causal)


@pytest.mark.parametrize("s,l,causal", [(1536, 16, False), (6144, 4, True), (7, 48, False)])
def test_tp_half_kernels_match_plain_sixteen_wide(cuda, s, l, causal):
    """tp = 8 at the channel block's width (C 128, 8 heads, hidden 128):
    16-wide shards (one head of d = 16, a 16-wide hidden shard), zero-padded
    to one 64-column group (three zero heads, 48 zero hidden columns)."""
    test_tp_half_kernels_match_plain(cuda, 8, s, l, 128, 128, 8, causal)


@pytest.mark.parametrize("tp,s,l,c,hidden,heads,causal", [
    (2, 1536, 16, 256, 256, 8, False),
    (4, 6144, 4, 256, 256, 8, True),
    (8, 512, 48, 256, 256, 8, False),
    (2, 37, 16, 512, 1024, 8, True),   # C = 512: 64-row tiles; HL = 512
    (2, 10, 33, 192, 384, 6, False),   # CA = 96 (a half-padded second group), HL = 192
])
def test_tp_half_kernels_match_first_design(cuda, tp, s, l, c, hidden, heads, causal):
    """The Hopper halves against the first design's on the same shard, in
    turns (Hopper, first design, first design, Hopper): each within the
    halves' limits of the plain version and of the other, the two Hopper
    runs equal bit for bit; only the Hopper wrappers count launches."""
    p = params(c, hidden, seed=tp + l, device=cuda)
    x = bf16_normal((s, l, c), seed=l, device=cuda)
    ap, mp = halves(shard_block(p, tp, tp - 1))
    apf, mpf = halves(f32(shard_block(p, tp, tp - 1)))
    for run, first, want in (
            (lambda: fb.attn_half_apply(x, ap, l, heads // tp, causal),
             lambda: fb.block_tile_attn_half(x, ap, l, heads // tp, causal),
             fb.attn_half_ref(x.float(), apf, l, heads // tp, causal)),
            (lambda: fb.mlp_half_apply(x, mp), lambda: fb.block_tile_mlp_half(x, mp),
             fb.mlp_half_ref(x.float(), mpf))):
        before = all_launches()
        k1, b1, b2, k2 = run(), first(), first(), run()
        torch.cuda.synchronize()
        assert all_launches() - before == Counter({torch.bfloat16: 2})
        assert torch.equal(k1, k2) and torch.equal(b1, b2)
        assert_half_close(k1, want)
        assert_half_close(b1, want)
        torch.testing.assert_close(k1.float(), b1.float(), atol=HALF_ATOL, rtol=HALF_RTOL)


class _StandInGroup:
    """A process group for ``_CopyToTP.apply`` in one process."""


def test_tp_halves_relay_once_per_weight_version(cuda):
    """As ``fused_block_apply_tp`` calls them (new ``copy_to_tp`` views of
    the LayerNorm parameters every call), the halves re-lay their weights
    once per weight version."""
    from tante_tpu_torch.parallel.collectives import _CopyToTP

    p = shard_block(params(256, 256, seed=9, device=cuda), 2, 0)
    x = bf16_normal((512, 48, 256), seed=9, device=cuda)
    g = _StandInGroup()

    def call():
        ap, mp = halves(p)
        ap = ap._replace(ln1_scale=_CopyToTP.apply(ap.ln1_scale, g),
                         ln1_bias=_CopyToTP.apply(ap.ln1_bias, g))
        mp = mp._replace(ln2_scale=_CopyToTP.apply(mp.ln2_scale, g),
                         ln2_bias=_CopyToTP.apply(mp.ln2_bias, g))
        ys = fb.attn_half_apply(x, ap, 48, 4, False), fb.mlp_half_apply(x, mp)
        torch.cuda.synchronize()
        return ys

    before = fb.relaid_weights.count
    first = call()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, call()))
    assert fb.relaid_weights.count == before + 2
    with torch.no_grad():
        p.wv.mul_(2.0)
        p.w2.mul_(2.0)
    moved = call()
    assert fb.relaid_weights.count == before + 4
    apf, mpf = halves(f32(p))
    assert_half_close(moved[0], fb.attn_half_ref(x.float(), apf, 48, 4, False))
    assert_half_close(moved[1], fb.mlp_half_ref(x.float(), mpf))


def test_tp_halves_relay_once_per_version_of_f32_parameters(cuda):
    """As a Trainer's block calls them (f32 parameters cast to bf16 on every
    call by ``cast_weight``, a gradient flowing), the halves re-lay their
    weights once per optimizer step, from the new values."""
    from tante_tpu_torch.parallel.collectives import _CopyToTP

    master = [torch.nn.Parameter(t.float())
              for t in shard_block(params(256, 256, seed=10, device=cuda), 2, 0)]
    x = bf16_normal((512, 48, 256), seed=10, device=cuda)
    g = _StandInGroup()

    def call():
        p = fb.BlockParams(*(fb.cast_weight(t, torch.bfloat16) for t in master))
        ap, mp = halves(p)
        ap = ap._replace(ln1_scale=_CopyToTP.apply(ap.ln1_scale, g),
                         ln1_bias=_CopyToTP.apply(ap.ln1_bias, g))
        mp = mp._replace(ln2_scale=_CopyToTP.apply(mp.ln2_scale, g),
                         ln2_bias=_CopyToTP.apply(mp.ln2_bias, g))
        ys = fb.attn_half_apply(x, ap, 48, 4, False), fb.mlp_half_apply(x, mp)
        torch.cuda.synchronize()
        return p, ys

    before = fb.relaid_weights.count
    _, first = call()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, call()[1]))
    assert fb.relaid_weights.count == before + 2
    opt = torch.optim.SGD(master, lr=1.0)
    for t in master:
        t.grad = torch.full_like(t, 0.01)
    opt.step()
    p, moved = call()
    assert fb.relaid_weights.count == before + 4
    apf, mpf = halves(f32(p))
    assert_half_close(moved[0], fb.attn_half_ref(x.float(), apf, 48, 4, False))
    assert_half_close(moved[1], fb.mlp_half_ref(x.float(), mpf))


def test_tp_half_kernels_refuse_what_they_cannot_take(cuda):
    p = params(256, 256, seed=0, device=cuda)
    ap, mp = halves(shard_block(p, 2, 0))
    with pytest.raises(ValueError):  # f32 activations, bf16 weights
        fb.attn_half_apply(torch.zeros(4, 16, 256, device=cuda), ap, 16, 4, False)
    with pytest.raises(ValueError):  # head dim 128
        fb.attn_half_apply(bf16_normal((4, 16, 256), 0, cuda), ap, 16, 1, False)
    with pytest.raises(ValueError):  # a local width that is not a multiple of 16
        bad = fb.MlpHalfParams(mp.ln2_scale, mp.ln2_bias, mp.w1[:, :40].contiguous(),
                               mp.b1[:40].contiguous(), mp.w2[:40].contiguous())
        fb.mlp_half_apply(bf16_normal((4, 16, 256), 0, cuda), bad)


@pytest.mark.parametrize("half,shape", [("attn", (1536, 16, 256)), ("attn", (6144, 4, 256)),
                                        ("mlp", (512, 48, 256))])
def test_tp_half_function_gradients_match_plain_autograd(cuda, half, shape):
    heads, tp, l = 8, 2, shape[1]
    causal = l == 4
    ps = shard_block(params(256, 256, seed=4, device=cuda), tp, 1)
    x = bf16_normal(shape, seed=6, device=cuda)

    def grads(x, p, kernel):
        x = x.detach().requires_grad_(True)
        p = fb.BlockParams(*(t.detach().requires_grad_(True) for t in p))
        ap, mp = halves(p)
        if half == "attn":
            fn = fb.attn_half_apply if kernel else fb.attn_half_ref
            y, leaves = fn(x, ap, l, heads // tp, causal), ap
        else:
            y, leaves = (fb.mlp_half_apply if kernel else fb.mlp_half_ref)(x, mp), mp
        (y.float() ** 2).sum().backward()
        return dict(zip(("x", *leaves._fields), (x.grad, *(t.grad for t in leaves))))

    before = all_launches()
    got = grads(x, ps, kernel=True)
    assert all_launches() - before == Counter({torch.bfloat16: 1})  # forward only
    want = grads(x.float(), f32(ps), kernel=False)
    for n, g in got.items():
        scale = torch.linalg.norm(want["bq" if n == "bk" else n])
        err = float(torch.linalg.norm(g.float() - want[n]) / scale)
        assert err <= GRAD_REL, f"{half} {n}: rel L2 {err}"


# ---- the f32 halves (fused_half_sm90_f32.cu) --------------------------------------

F32_HALF_REL_L2 = 1e-6


def assert_f32_half_close(got, want):
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    assert rel <= F32_HALF_REL_L2 and err <= F32_MAX_ABS_SHARE * peak, (rel, err, peak)


@pytest.fixture(params=["fast", "safe"])
def softmax(request):
    fb.set_block_tuning(softmax=request.param)
    try:
        yield request.param
    finally:
        fb.set_block_tuning(softmax="fast")


# (s, l, c, hidden, heads, tp, causal): head dims 32 (C 256, 8 heads), 64
# (C 256, 4 heads) and 16 (C 128, 8 heads, hidden 2C) at shard widths 128, 64
# and 32 (zero-padded to one 64-column group), ragged last tiles and padded
# rows among them.
F32_HALF_CASES = [
    (1536, 16, 256, 256, 8, 2, False),   # d 32, CA 128: the flagship H blocks at tp 2
    (512, 48, 256, 256, 8, 4, False),    # d 32, CA 64: W blocks at tp 4
    (6144, 4, 256, 256, 8, 8, True),     # d 32, CA 32: T blocks at tp 8
    (37, 16, 256, 256, 4, 2, True),      # d 64, CA 128, ragged last tile
    (21, 3, 256, 256, 4, 4, False),      # d 64, CA 64, padded rows (63 of 64)
    (9, 32, 128, 256, 8, 2, False),      # d 16, CA 64, HL 128
    (7, 48, 128, 256, 8, 4, True),       # d 16, CA 32, HL 64
    (9, 32, 128, 128, 8, 8, False),      # d 16, CA 16, HL 16: the channel block at tp 8
]


@pytest.mark.parametrize("s,l,c,hidden,heads,tp,causal", F32_HALF_CASES)
def test_f32_tp_half_kernels_match_plain(cuda, no_tf32, softmax, s, l, c, hidden, heads, tp,
                                         causal):
    """Each shard's f32 halves against their f32 plain versions; their f32
    sum over the shards, plus bias and residual, against the unsplit f32
    block kernel; only f32 launches counted."""
    p = params(c, hidden, seed=l + c + tp, device=cuda, dtype=torch.float32)
    x = f32_normal((s, l, c), seed=s + tp, device=cuda)
    before = fb.attn_half_apply.launches.copy(), fb.mlp_half_apply.launches.copy()
    attn_sum, parts = torch.zeros_like(x), []
    for r in range(tp):
        ap, mp = halves(shard_block(p, tp, r))
        got = fb.attn_half_apply(x, ap, l, heads // tp, causal)
        torch.cuda.synchronize()
        assert_f32_half_close(got, fb.attn_half_ref(x, ap, l, heads // tp, causal))
        attn_sum += got
        parts.append(mp)
        got = fb.mlp_half_apply(x, mp)
        torch.cuda.synchronize()
        assert_f32_half_close(got, fb.mlp_half_ref(x, mp))
    assert (fb.attn_half_apply.launches - before[0], fb.mlp_half_apply.launches
            - before[1]) == (Counter({torch.float32: tp}),) * 2
    xm = x + (attn_sum + p.bo)
    y = xm + (sum(fb.mlp_half_apply(xm, mp) for mp in parts) + p.b2)
    unsplit = fb.fused_block_apply(x, p, l, heads, causal)
    assert float(torch.linalg.norm(y - unsplit) / torch.linalg.norm(unsplit)) <= F32_HALF_REL_L2
    assert_f32_close(y, fb.block_ref(x, p, l, heads, causal))


def test_f32_tp_halves_relay_once_per_weight_version(cuda, no_tf32):
    """f32 parameters reach the halves uncast, the LayerNorm ones as new
    ``copy_to_tp`` views every call: one re-layout per weight version, and an
    in-place update moves the result with the weights."""
    from tante_tpu_torch.parallel.collectives import _CopyToTP

    p = shard_block(params(256, 256, seed=11, device=cuda, dtype=torch.float32), 2, 1)
    x = f32_normal((512, 48, 256), seed=11, device=cuda)
    g = _StandInGroup()

    def call():
        ap, mp = halves(p)
        ap = ap._replace(ln1_scale=_CopyToTP.apply(ap.ln1_scale, g),
                         ln1_bias=_CopyToTP.apply(ap.ln1_bias, g))
        mp = mp._replace(ln2_scale=_CopyToTP.apply(mp.ln2_scale, g),
                         ln2_bias=_CopyToTP.apply(mp.ln2_bias, g))
        ys = fb.attn_half_apply(x, ap, 48, 4, False), fb.mlp_half_apply(x, mp)
        torch.cuda.synchronize()
        return ys

    before = fb.relaid_weights.count
    first = call()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, call()))
    assert fb.relaid_weights.count == before + 2
    with torch.no_grad():
        p.wk.mul_(2.0)
        p.b1.add_(0.5)
    moved = call()
    assert fb.relaid_weights.count == before + 4
    ap, mp = halves(p)
    assert_f32_half_close(moved[0], fb.attn_half_ref(x, ap, 48, 4, False))
    assert_f32_half_close(moved[1], fb.mlp_half_ref(x, mp))


def test_f32_tp_half_kernels_refuse_what_they_cannot_take(cuda):
    """No f32 tile past C = 256: the wrappers raise on the plan, and on mixed
    dtypes; nothing is launched."""
    before = fb.attn_half_apply.launches.copy(), fb.mlp_half_apply.launches.copy()
    p = params(512, 512, seed=0, device=cuda, dtype=torch.float32)
    ap, mp = halves(shard_block(p, 2, 0))
    x = f32_normal((4, 16, 512), seed=0, device=cuda)
    with pytest.raises(ValueError, match="no attn half tile plan"):
        fb.attn_half_apply(x, ap, 16, 4, False)
    with pytest.raises(ValueError, match="no mlp half tile plan"):
        fb.mlp_half_apply(x, mp)
    p = params(256, 256, seed=0, device=cuda, dtype=torch.float32)
    ap, mp = halves(shard_block(p, 2, 0))
    x = f32_normal((4, 16, 256), seed=0, device=cuda)
    with pytest.raises(ValueError):  # one bf16 weight among f32
        fb.attn_half_apply(x, ap._replace(wo=ap.wo.to(torch.bfloat16)), 16, 4, False)
    with pytest.raises(ValueError):  # bf16 activations, f32 weights
        fb.mlp_half_apply(x.to(torch.bfloat16), mp)
    assert (fb.attn_half_apply.launches, fb.mlp_half_apply.launches) == before


# --------------------------------------------------------------------------
# The long entry (csrc/fused_block_long_sm90.cu): the qkv kernel into the
# workspace, then the attention kernel over streamed key blocks and the
# block's tail, against the plain block at any L (fused_block_apply sends
# L > 64 there; fused_block_long takes L <= 64 too), bf16 at the block
# tolerance, f32 at the f32 one.
# --------------------------------------------------------------------------

LONG_LS = [48, 65, 100, 192, 256, 768, 3072]
# wq and wk of the long cases, as chip_smoke.py's LONG_QK_SCALE: scores of
# std about 2.5, a peaked softmax, so that a wrong attention (a dropped key
# block) exceeds the bf16 limit.
LONG_QK_SCALE = 2.75


def long_case(l, c, hidden, heads, dtype, device, seed=0):
    s = max(2, 3072 // l)
    p = params(c, hidden, seed=l + c + seed, device=device, dtype=dtype, qk_scale=LONG_QK_SCALE)
    if dtype == torch.float32:
        x = f32_normal((s, l, c), seed=l, device=device)
    else:
        x = bf16_normal((s, l, c), seed=l, device=device)
    return x, p


def run_long(x, p, l, heads, causal):
    before = (fb.long_qkv_fwd.launches.copy(), fb.long_attn_fwd.launches.copy())
    got = fb.fused_block_long(x, p, l, heads, causal)
    torch.cuda.synchronize()
    one = Counter({x.dtype: 1})
    assert fb.long_qkv_fwd.launches - before[0] == one
    assert fb.long_attn_fwd.launches - before[1] == one
    return got


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", LONG_LS)
def test_long_block_matches_plain(cuda, l, causal, softmax):
    x, p = long_case(l, 256, 256, 8, torch.bfloat16, cuda)
    fb.set_block_tuning(softmax=softmax)
    try:
        got = run_long(x, p, l, 8, causal)
    finally:
        fb.set_block_tuning(softmax="fast")
    want = fb.block_ref(x.float(), f32(p), l, 8, causal)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", LONG_LS)
def test_f32_long_block_matches_plain(cuda, no_tf32, l, causal, softmax):
    x, p = long_case(l, 256, 256, 8, torch.float32, cuda)
    fb.set_block_tuning(softmax=softmax)
    try:
        got = run_long(x, p, l, 8, causal)
    finally:
        fb.set_block_tuning(softmax="fast")
    assert_f32_close(got, fb.block_ref(x, p, l, 8, causal))


# (L, C, hidden, heads): the C axis's block (width 128, head dim 16), head
# dims 32 and 64, C = 512 (bf16: 64-row qkv tiles), ragged tiles.
LONG_SHAPES = [(256, 128, 128, 8), (130, 128, 256, 4), (200, 256, 256, 4), (100, 512, 512, 8),
               (65, 192, 128, 6)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,c,hidden,heads,dtype", [
    (*shape, dt) for shape in LONG_SHAPES for dt in (torch.bfloat16, torch.float32)
    if dt == torch.bfloat16 or shape[1] <= 256])  # the f32 body holds C <= 256 (refused below)
def test_long_block_shapes_match_plain(cuda, no_tf32, l, c, hidden, heads, causal, dtype):
    x, p = long_case(l, c, hidden, heads, dtype, cuda, seed=1)
    got = run_long(x, p, l, heads, causal)
    if dtype == torch.float32:
        assert_f32_close(got, fb.block_ref(x, p, l, heads, causal))
    else:
        want = fb.block_ref(x.float(), f32(p), l, heads, causal)
        torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


def test_long_block_at_the_channel_axis_shape(cuda):
    """The C block at the flagship's width: 128 wide, 256 channels, head dim
    16, 3072 sequences (one frame's tokens); plain on the first 256."""
    x, p = bf16_normal((3072, 256, 128), 3, cuda), params(128, 128, 3, cuda,
                                                          qk_scale=LONG_QK_SCALE)
    got = run_long(x, p, 256, 8, False)
    want = fb.block_ref(x[:256].float(), f32(p), 256, 8, False)
    torch.testing.assert_close(got[:256].float(), want, atol=ATOL, rtol=RTOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_apply_sends_long_sequences_to_the_long_entry(cuda, no_tf32, dtype):
    x, p = long_case(192, 256, 256, 8, dtype, cuda, seed=2)
    before = fb.fused_block_apply.launches.copy()
    a = fb.fused_block_apply(x, p, 192, 8, False)
    assert fb.fused_block_apply.launches == before  # not the single-block kernel
    torch.testing.assert_close(a, run_long(x, p, 192, 8, False), atol=0, rtol=0)


# (L, S at one and at two waves of 128-row tiles on 132 SMs) where the
# launch mixes the two item sizes: tiles past the first wave as pair items
# (S 140 / 47), and every tile one item (S 264 / 88).
@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,s", [(100, 140), (100, 264), (257, 47), (257, 88), (65, 140)])
def test_long_block_items_and_pair_items_match_plain(cuda, l, s, causal, softmax):
    """bf16 at the flagship width where a launch runs 128-row items and, past
    the grid's last whole wave, 64-row pair items (``long_attn_work``):
    ragged and causal, both softmax forms; two launches bit-equal."""
    p = params(256, 256, seed=l + s, device=cuda, qk_scale=LONG_QK_SCALE)
    x = bf16_normal((s, l, 256), seed=l + s, device=cuda)
    work = fb.long_attn_work(x, fb.long_plan(256, 256, 8), 256)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert work["big"] == fb.long_big_tiles(fb.long_plan(256, 256, 8), work["tiles"], sms,
                                            torch.bfloat16)
    fb.set_block_tuning(softmax=softmax)
    try:
        got = run_long(x, p, l, 8, causal)
        assert torch.equal(got, fb.fused_block_long(x, p, l, 8, causal))
    finally:
        fb.set_block_tuning(softmax="fast")
    want = fb.block_ref(x.float(), f32(p), l, 8, causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


def test_long_attn_work_matches_the_mirror(cuda):
    """The launch's tiles, big tiles and items (the kernel library's
    ``tante_block_long_attn_items``) against ``long_big_tiles`` and
    ``long_item_map`` at the flagship's long shapes, both dtypes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for s, l, c in [(32, 768, 256), (128, 192, 256), (8, 3072, 256), (24576, 256, 128),
                    (47, 257, 256)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty((s, l, c), device=cuda, dtype=dtype)
            plan = fb.long_plan(c, c, 8, dtype)
            work = fb.long_attn_work(x, plan, c)
            assert work["tiles"] == s * -(-l // plan.items)
            assert work["big"] == fb.long_big_tiles(plan, work["tiles"], sms, dtype)
            assert work["items"] == len(fb.long_item_map(plan, s, l, work["big"]))
            assert work["grid"] == min(work["items"], sms)


def test_long_plan_matches_the_kernels_mirror(cuda):
    import ctypes

    from tante_tpu_torch.ops import _build

    lib = _build.load("fused_block_long_sm90")
    for l, c, hidden, heads in [(768, 256, 256, 8), (256, 128, 128, 8), (100, 512, 1024, 8),
                                (65, 192, 128, 6)]:
        for dtype in (torch.bfloat16, torch.float32):
            plan = fb.long_plan(c, hidden, heads, dtype)
            if plan is None:
                continue
            out = (ctypes.c_longlong * 2)()
            ints = plan.ints()
            lib.tante_block_long_smem((ctypes.c_int * len(ints))(*ints), c, hidden,
                                      int(dtype == torch.float32), out)
            assert tuple(out) == fb.long_smem(plan, c, hidden, dtype), (l, c, hidden, dtype)


def test_long_block_refuses_what_it_cannot_take(cuda):
    x, p = long_case(100, 256, 256, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="CUDA"):  # a CPU tensor handed to the launch
        fb._launch_long(x.cpu(), fb.BlockParams(*(t.cpu() for t in p)), 100, 8, False)
    with pytest.raises(ValueError):  # head dim 8
        fb.fused_block_long(x, p, 100, 32, False)
    p512 = params(512, 512, 0, cuda, torch.float32)
    with pytest.raises(ValueError, match="no long-entry plan"):  # f32 holds C <= 256
        fb.fused_block_long(f32_normal((2, 100, 512), 0, cuda), p512, 100, 8, False)
    with pytest.raises(ValueError):  # mixed dtypes
        fb.fused_block_long(x.float(), p, 100, 8, False)


def test_long_block_gradients_match_plain_autograd(cuda):
    """The Function's backward recomputes the plain block (bf16) and pulls
    the cotangent through it, as at L <= 64."""
    x, p = long_case(100, 256, 256, 8, torch.bfloat16, cuda)
    x = x[:4].contiguous()
    xs = x.clone().requires_grad_(True)
    ps = fb.BlockParams(*(t.clone().requires_grad_(True) for t in p))
    (fb.fused_block_long(xs, ps, 100, 8, True).float() ** 2).sum().backward()
    xf = x.float().requires_grad_(True)
    pf = fb.BlockParams(*(t.float().requires_grad_(True) for t in p))
    (fb.block_ref(xf, pf, 100, 8, True) ** 2).sum().backward()
    for name, a, b in [("x", xs, xf), *zip(fb.BlockParams._fields, ps, pf)]:
        if name == "bk":
            continue
        rel = float(torch.linalg.norm(a.grad.float() - b.grad) / torch.linalg.norm(b.grad))
        assert rel <= GRAD_REL, (name, rel)


# --------------------------------------------------------------------------
# The tensor-parallel attention half at L > 64 (csrc/fused_half_long_sm90.cu):
# its qkv kernel into the shard's workspace, then its attention kernel over
# streamed key blocks and the out-projection partial, against the plain half
# (attn_half_ref) per shard; the shards recombined against the long block.
# --------------------------------------------------------------------------

# (s, l, c, heads, tp, causal): the flagship's L (768, C 256, d 32) and C
# block (L 256, 128 wide, d 16: a 64-wide shard at tp 2, a 32-wide one
# padded to a group at tp 4), causal L 100, a ragged last tile (65), head
# dim 64 and C 512 (bf16: 64-row qkv tiles).
LONG_HALF_CASES = [
    (4, 768, 256, 8, 2, False),
    (96, 256, 128, 8, 2, False),
    (96, 256, 128, 8, 4, False),
    (24, 100, 256, 8, 2, True),
    (24, 65, 256, 4, 4, True),
    (12, 130, 512, 8, 2, False),
    (6, 257, 256, 8, 2, True),     # a last tile of one row
    (96, 256, 128, 8, 8, False),   # the C block at tp 8: 16-wide shards, one head of 16
]


def long_half_shards(s, l, c, heads, tp, dtype, device, seed=0):
    p = params(c, c, seed=l + c + tp + seed, device=device, dtype=dtype, qk_scale=LONG_QK_SCALE)
    x = (f32_normal if dtype == torch.float32 else bf16_normal)((s, l, c), l + seed, device)
    return x, p, [halves(shard_block(p, tp, r)) for r in range(tp)]


def run_long_half(x, ap, l, heads, causal):
    before = (fb.half_long_qkv_fwd.launches.copy(), fb.half_long_attn_fwd.launches.copy(),
              fb.attn_half_apply.launches.copy())
    got = fb.attn_half_apply(x, ap, l, heads, causal)
    torch.cuda.synchronize()
    one = Counter({x.dtype: 1})
    assert fb.half_long_qkv_fwd.launches - before[0] == one
    assert fb.half_long_attn_fwd.launches - before[1] == one
    assert fb.attn_half_apply.launches == before[2]  # not the short half's kernel
    return got


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("s,l,c,heads,tp,causal,dtype", [
    (*case, dt) for case in LONG_HALF_CASES for dt in (torch.bfloat16, torch.float32)
    if dt == torch.bfloat16 or case[2] <= 256])  # the f32 body holds C <= 256 (refused below)
def test_long_half_matches_plain(cuda, no_tf32, s, l, c, heads, tp, causal, dtype, softmax):
    """Every shard's partial against the plain half (bf16: the f32 plain half
    from the same bf16 inputs, the halves' limits; f32: the long block's f32
    limits, as wq / wk are as wide: the peaked softmax put the partial at
    1.4e-6 relative L2 at L 768 on an NVIDIA H100 80GB HBM3 at 700 W), one
    launch of each kernel a call, two launches bit-equal."""
    x, p, shards = long_half_shards(s, l, c, heads, tp, dtype, cuda)
    fb.set_block_tuning(softmax=softmax)
    try:
        for ap, _ in shards:
            got = run_long_half(x, ap, l, heads // tp, causal)
            assert torch.equal(got, fb.attn_half_apply(x, ap, l, heads // tp, causal))
            if dtype == torch.float32:
                assert_f32_close(got, fb.attn_half_ref(x, ap, l, heads // tp, causal))
            else:
                apf = fb.AttnHalfParams(*(t.float() for t in ap))
                assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
                assert_half_close(got, fb.attn_half_ref(x.float(), apf, l, heads // tp, causal))
    finally:
        fb.set_block_tuning(softmax="fast")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("s,l,c,heads,tp,causal", [*LONG_HALF_CASES[:4], LONG_HALF_CASES[-1]])
def test_long_half_shards_recombine_into_the_long_block(cuda, no_tf32, s, l, c, heads, tp,
                                                        causal, dtype):
    """The shards' partials summed, + bo and residual, then the MLP halves
    summed, + b2 and residual, as fused_block_apply_tp adds them, against
    the unsplit long block kernel (fused_block_long) and the plain block."""
    x, p, shards = long_half_shards(s, l, c, heads, tp, dtype, cuda, seed=1)
    attn = torch.stack([fb.attn_half_apply(x, ap, l, heads // tp, causal)
                        for ap, _ in shards]).float().sum(0)
    xm = x + (attn.to(dtype) + p.bo).to(dtype)
    mlp = torch.stack([fb.mlp_half_apply(xm, mp) for _, mp in shards]).float().sum(0)
    y = xm + (mlp.to(dtype) + p.b2).to(dtype)
    unsplit = fb.fused_block_long(x, p, l, heads, causal)
    if dtype == torch.float32:
        assert_f32_close(y, unsplit)
        assert_f32_close(y, fb.block_ref(x, p, l, heads, causal))
    else:
        want = fb.block_ref(x.float(), f32(p), l, heads, causal)
        torch.testing.assert_close(y.float(), want, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(y.float(), unsplit.float(), atol=ATOL, rtol=RTOL)


def test_long_half_gradients_match_plain_autograd(cuda):
    """The Function's backward recomputes the plain half (bf16) and pulls the
    cotangent through it, as at L <= 64."""
    heads, tp, l = 8, 2, 100
    ps = shard_block(params(256, 256, seed=4, device=cuda, qk_scale=LONG_QK_SCALE), tp, 1)
    ap, _ = halves(ps)
    x = bf16_normal((64, l, 256), seed=6, device=cuda)

    def grads(x, ap, kernel):
        x = x.detach().requires_grad_(True)
        leaves = fb.AttnHalfParams(*(t.detach().requires_grad_(True) for t in ap))
        fn = fb.attn_half_apply if kernel else fb.attn_half_ref
        (fn(x, leaves, l, heads // tp, True).float() ** 2).sum().backward()
        return dict(zip(("x", *leaves._fields), (x.grad, *(t.grad for t in leaves))))

    before = all_launches()
    got = grads(x, ap, kernel=True)
    assert all_launches() - before == Counter({torch.bfloat16: 2})  # the two forward kernels
    want = grads(x.float(), fb.AttnHalfParams(*(t.float() for t in ap)), kernel=False)
    for n, g in got.items():
        scale = torch.linalg.norm(want["bq" if n == "bk" else n])
        err = float(torch.linalg.norm(g.float() - want[n]) / scale)
        assert err <= GRAD_REL, f"{n}: rel L2 {err}"


def test_long_half_plan_matches_the_kernels_mirror(cuda):
    import ctypes

    from tante_tpu_torch.ops import _build

    lib = _build.load("fused_half_long_sm90")
    for c, local, heads in [(256, 128, 4), (256, 64, 2), (128, 64, 4), (128, 32, 2),
                            (512, 256, 4), (192, 96, 3), (256, 256, 4), (128, 16, 1)]:
        for dtype in (torch.bfloat16, torch.float32):
            plan = fb.half_long_plan(c, local, heads, dtype)
            if plan is None:
                continue
            out = (ctypes.c_longlong * 2)()
            ints = plan.ints()
            lib.tante_attn_half_long_smem((ctypes.c_int * len(ints))(*ints), c, local,
                                          int(dtype == torch.float32), out)
            assert tuple(out) == fb.half_long_smem(plan, c, dtype), (c, local, dtype)
            assert max(out) <= fb.SMEM_OPTIN


# (l, s, c, heads, tp): launches whose 128-row bf16 tiles leave a ragged last
# wave on the grid, so the tiles past the first wave run as 64-row pair items
# (S 140 / 47 / 1080 at 132 SMs), and one whose every tile is one item (S 264).
@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,s,c,heads,tp", [(100, 140, 256, 8, 2), (100, 264, 256, 8, 2),
                                            (257, 47, 256, 8, 2), (65, 140, 256, 8, 4),
                                            (256, 1080, 128, 8, 8)])
def test_long_half_items_and_pair_items_match_plain(cuda, l, s, c, heads, tp, causal, softmax):
    """bf16 shard 0 where a launch runs 128-row items and, past the grid's
    last whole wave, pair items (``half_long_attn_work`` against its mirror):
    ragged and causal, both softmax forms, the 16-wide shard of tp 8; two
    launches bit-equal; the half's limits against the f32 plain half."""
    x, p, shards = long_half_shards(s, l, c, heads, tp, torch.bfloat16, cuda, seed=2)
    ap, _ = shards[0]
    plan = fb.half_long_plan(c, c // tp, heads // tp)
    work = fb.half_long_attn_work(x, plan, l, c // tp)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert work["big"] == fb.long_big_tiles(plan, work["tiles"], sms, torch.bfloat16)
    fb.set_block_tuning(softmax=softmax)
    try:
        got = run_long_half(x, ap, l, heads // tp, causal)
        assert torch.equal(got, fb.attn_half_apply(x, ap, l, heads // tp, causal))
    finally:
        fb.set_block_tuning(softmax="fast")
    apf = fb.AttnHalfParams(*(t.float() for t in ap))
    assert torch.isfinite(got).all()
    assert_half_close(got, fb.attn_half_ref(x.float(), apf, l, heads // tp, causal))


def test_long_half_attn_work_matches_the_mirror(cuda):
    """The attention kernel's tiles, big tiles, items and grid (the kernel
    library's ``tante_attn_half_long_attn_items``) against
    ``long_big_tiles`` and ``long_item_map`` of the half's plan at the
    flagship's long shapes at tp 2, 4 and 8, both dtypes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for s, l, c in [(32, 768, 256), (128, 192, 256), (8, 3072, 256), (24576, 256, 128),
                    (47, 257, 256)]:
        for tp in (2, 4, 8):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.empty((s, l, c), device=cuda, dtype=dtype)
                plan = fb.half_long_plan(c, c // tp, 8 // tp, dtype)
                work = fb.half_long_attn_work(x, plan, l, c // tp)
                assert work["tiles"] == s * -(-l // plan.items)
                assert work["big"] == fb.long_big_tiles(plan, work["tiles"], sms, dtype)
                assert work["items"] == len(fb.long_item_map(plan, s, l, work["big"]))
                assert work["grid"] == min(work["items"], sms)


def test_long_half_refuses_what_it_cannot_take(cuda):
    x, p, shards = long_half_shards(4, 100, 256, 8, 2, torch.bfloat16, cuda)
    ap, _ = shards[0]
    with pytest.raises(ValueError, match="CUDA"):  # a CPU tensor handed to the launch
        fb._launch_half_long(x.cpu(), fb.AttnHalfParams(*(t.cpu() for t in ap)), 100, 4, False)
    with pytest.raises(ValueError):  # mixed dtypes
        fb.attn_half_apply(x.float(), ap, 100, 4, False)
    p512 = params(512, 512, 0, cuda, torch.float32)
    with pytest.raises(ValueError, match="no long attention half plan"):  # f32 holds C <= 256
        fb.attn_half_apply(f32_normal((2, 100, 512), 0, cuda), halves(shard_block(p512, 2, 0))[0],
                           100, 4, False)



# --------------------------------------------------------------------------
# The qkv kernels alone (long_sm90.cuh's qkv body: the long block's qkv entry
# and the long half's qkv kernel, bf16 and f32): each launch's workspace
# against the order of work of test_torch_long_block.py:long_qkv (LN1 with
# one-pass f32 moments, rounded to the activation dtype; q from wq, bq
# prescaled by d^-0.5 log2 e and rounded; k, v; + bias), written into a
# NaN-filled buffer with a NaN guard past its end; two launches bit-equal.
# --------------------------------------------------------------------------

# (S, L, C, heads): the flagship's L, X, A blocks (C 256, head dim 32) and C
# block (256 channels, 128 wide, head dim 16: 24,576 sequences, checked on
# the first QKV_CHECK_SEQS); ragged L (a tile across sequence ends, a last
# tile of one row), C 512 (bf16: 64-row tiles), head dims 16 and 64.
QKV_CASES = [(32, 768, 256, 8), (128, 192, 256, 8), (8, 3072, 256, 8), (24576, 256, 128, 8),
             (7, 100, 256, 8), (5, 257, 256, 16), (6, 130, 512, 8), (9, 200, 256, 4)]
QKV_CHECK_SEQS = 256


@pytest.mark.parametrize("s,l,c,heads,dtype", [
    (*case, dt) for case in QKV_CASES for dt in (torch.bfloat16, torch.float32)
    if dt == torch.bfloat16 or case[2] <= 256])  # the f32 body holds C <= 256
def test_long_qkv_workspace_matches_its_order_of_work(cuda, no_tf32, s, l, c, heads, dtype):
    """The long block's qkv entry (64- and 128-row tiles, resident weights at
    the C block in bf16, a slab ring elsewhere) into a NaN-filled buffer:
    every element written and none past it, two launches bit-equal, the
    wrapper's launch equal; the first sequences against ``qkv_reference``
    (bf16 within one bf16 ulp and the order's bound, f32 within the long
    block's f32 limits)."""
    p = params(c, c, seed=s + l + c, device=cuda, dtype=dtype, qk_scale=LONG_QK_SCALE)
    x = (f32_normal if dtype == torch.float32 else bf16_normal)((s, l, c), s + l, cuda)
    plan = fb.long_plan(c, c, heads, dtype)
    w = fb.sm90_weights(p, heads, plan)
    lib = fb._long_lib(x)
    entry = (lib.tante_block_long_qkv_sm90_f32_fwd if dtype == torch.float32
             else lib.tante_block_long_qkv_sm90_fwd)
    shape = (3, s, c // 64, l, 64)
    ws, guard = qkv_launch(entry, x, w, plan, s, l, c, c, shape)
    again, _ = qkv_launch(entry, x, w, plan, s, l, c, c, shape)
    assert torch.equal(ws, again)
    n = min(s, QKV_CHECK_SEQS)
    ref, bound = qkv_reference(x[:n], p.ln1_scale, p.ln1_bias, *qkv_operands(p, heads, c), c,
                               mm3)
    ok, agree = qkv_agree(ws, guard, ref, bound, n)
    assert ok, agree
    assert torch.equal(ws, fb.long_qkv_fwd(x, w, plan, l))  # the wrapper's launch


# (S, L, C, heads, tp): the C block at tp 2 (a 64-wide shard) and tp 8
# (16-wide shards, one head of 16 padded to a group), L at tp 2 (128 wide),
# a ragged L at tp 4.
QKV_HALF_CASES = [(24576, 256, 128, 8, 2), (24576, 256, 128, 8, 8), (32, 768, 256, 8, 2),
                  (7, 100, 256, 8, 4)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("s,l,c,heads,tp", QKV_HALF_CASES)
def test_long_half_qkv_workspace_matches_its_order_of_work(cuda, no_tf32, s, l, c, heads, tp,
                                                           dtype):
    """The long half's qkv kernel on the first and last shard (resident
    weights at the C block's shards, a ring at C 256), as the block's
    entry: NaN sentinel and guard, two launches and the wrapper's equal,
    against ``qkv_reference`` with the padded columns exactly 0."""
    p = params(c, c, seed=s + l + tp, device=cuda, dtype=dtype, qk_scale=LONG_QK_SCALE)
    x = (f32_normal if dtype == torch.float32 else bf16_normal)((s, l, c), s + l, cuda)
    lib = fb._half_long_lib(x)
    entry = (lib.tante_attn_half_long_qkv_sm90_f32_fwd if dtype == torch.float32
             else lib.tante_attn_half_long_qkv_sm90_fwd)
    n = min(s, QKV_CHECK_SEQS)
    for r in sorted({0, tp - 1}):
        ap = halves(shard_block(p, tp, r))[0]
        ca, lh = ap.wq.shape[-1], heads // tp
        plan = fb.half_long_plan(c, ca, lh, dtype)
        w = fb.half_long_weights(ap, lh, plan)
        shape = (3, s, plan.width // 64, l, 64)
        ws, guard = qkv_launch(entry, x, w, plan, s, l, c, ca, shape)
        again, _ = qkv_launch(entry, x, w, plan, s, l, c, ca, shape)
        assert torch.equal(ws, again)
        ref, bound = qkv_reference(x[:n], ap.ln1_scale, ap.ln1_bias,
                                   *qkv_operands(ap, lh, plan.width), plan.width, mm3)
        ok, agree = qkv_agree(ws, guard, ref, bound, n)
        assert ok, agree
        assert torch.equal(ws, fb.half_long_qkv_fwd(x, w, plan, l, ca))
