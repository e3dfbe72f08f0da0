"""The tensor-parallel attention half at L > 64 (the long half), on the CPU.

``attn_half_apply`` sends L > 64 to ``attn_half_long``: on the card two
kernels (``ops/csrc/fused_half_long_sm90.cu``: LN1 and the shard's q|k|v
into a workspace, then the long block's attention design over the shard's
head groups, a persistent grid of work items of 128 query rows in bf16 (64-row
pair items past the grid's last whole wave) and 64 in f32, the keys streamed
in blocks of 64, then the out-projection partial), on the CPU the plain half
``attn_half_ref``.  Held against the JAX package's ``_xla_attn_half`` on
numpy-seeded inputs:

- ``attn_half_ref`` at L 65-3072, causal and not, tp 2, 4 and 8 (at C = 128
  with 8 heads, tp 4 is a 32-wide shard and tp 8 a 16-wide one, one head of
  16, which the kernels pad to one 64-column group), f32 within 1e-5;
- a CPU model of the kernels' order of work (``long_half``: the long
  block's pieces from ``test_torch_long_block.py`` on the zero-padded shard,
  ``item_attention`` over the half plan's items, 3xTF32 products in f32, cut
  at the out-projection, the partial rounded once): f32 within the card's
  f32 limits (relative L2 <= 1e-5, max abs <= 1e-4 max |ref|), bf16 within
  the halves' bf16 limits of JAX's f32 half on the same bf16 inputs (1.5e-2
  + 2e-2 |ref| and relative L2 <= 2e-2, ``chip_smoke.py``), with every tile
  one item and with pair items; the padded heads' output exactly 0;
- with wq and wk ``chip_smoke.LONG_QK_SCALE`` wider, the bf16 limit sees a
  wrong attention (``chip_smoke.dropped_keys_half_ref``, the last key block
  dropped, fails it);
- the plan against ``SMEM_OPTIN`` at every flagship long shape for tp 2, 4
  and 8 in both dtypes (the C block at tp 8 a 16-wide shard); the item map
  covers every query once; the launch's pair items at the flagship and the
  workspace bytes the attention kernel reads; the plain half's chunked
  attention; a CPU tensor takes the plain half and launches nothing.
"""

import functools

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import block_params
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.parallel.sharding import shard_block
from test_torch_long_block import item_attention, long_qkv, rounder

C, HEADS = 128, 8         # the channel block's width and heads: head dim 16
REL_L2, MAX_ABS_SHARE = 1e-5, 1e-4
HALF_ATOL, HALF_RTOL, HALF_REL_L2 = (chip_smoke.HALF_ATOL, chip_smoke.HALF_RTOL,
                                     chip_smoke.HALF_REL_L2_TOL)
ROWS = {65: 3, 100: 3, 256: 2, 3072: 1}  # sequences per case


def long_half(x, p, heads, causal, softmax, big=None):
    """The long half's order of work on (S, L, C) rows in x's dtype, on the
    shard ``p`` (``heads`` local heads) zero-padded to whole 64-column
    groups as the kernels' re-laid weights are: q|k|v of every group, the
    attention over ``half_long_plan``'s items (``big`` tiles one item each,
    all by default; the others two pair items), then bf16(attn wo) with no
    bias."""
    ca = p.wq.shape[-1]
    pad = -ca % 64
    d = ca // heads
    cols = {f: F.pad(getattr(p, f), (0, pad)) for f in ("wq", "bq", "wk", "bk", "wv", "bv")}
    pp = p._replace(**cols, wo=F.pad(p.wo, (0, 0, 0, pad)))
    plan = tblock.half_long_plan(x.shape[-1], ca, heads, x.dtype)
    items = tblock.long_item_map(plan, x.shape[0], x.shape[1], big)
    attn = item_attention(*long_qkv(x, pp, (ca + pad) // d), causal, softmax, x.dtype, items,
                          plan.items)
    assert not attn[..., ca:].any()  # the padded heads' output is exactly 0
    return rounder(x.dtype)(attn @ pp.wo.float())


def shard(p, tp, r, dtype=torch.float32):
    """Shard ``r`` of ``tp`` of the block ``p`` (numpy), as its attention half."""
    ps = shard_block(tblock.BlockParams(*(torch.from_numpy(np.array(a)) for a in p)), tp, r)
    return tblock.AttnHalfParams(*(getattr(ps, f).to(dtype) for f in tblock.AttnHalfParams._fields))


def jax_half(x, ap, l, heads, causal):
    """JAX's plain attention half (f32) on the torch shard ``ap``."""
    ja = jblock.AttnHalfParams(*(jnp.asarray(t.float().numpy()) for t in ap))
    return np.asarray(jblock._xla_attn_half(jnp.asarray(x), ja, l, heads, causal))


@functools.lru_cache(maxsize=None)
def case(l, causal, tp):
    """(x, the block's params) as numpy, shard 0 of tp, and JAX's half on it."""
    p = block_params(C, C, seed=l + causal + tp)
    x = np.random.default_rng(l + tp).normal(size=(ROWS[l], l, C)).astype(np.float32)
    ap = shard(p, tp, 0)
    return x, ap, jax_half(x, ap, l, HEADS // tp, causal)


def assert_f32_close(got, want):
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= REL_L2, rel
    assert np.abs(got - want).max() <= MAX_ABS_SHARE * np.abs(want).max()


def assert_half_close(got, want):
    err, limit = np.abs(got - want), HALF_ATOL + HALF_RTOL * np.abs(want)
    assert np.all(err <= limit), float((err / limit).max())
    assert np.linalg.norm(got - want) <= HALF_REL_L2 * np.linalg.norm(want)


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [65, 100, 256, 3072])
def test_plain_half_matches_jax_at_long_sequences(l, causal, tp):
    x, ap, want = case(l, causal, tp)
    got = tblock.attn_half_ref(torch.from_numpy(x), ap, l, HEADS // tp, causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [65, 100, 256, 3072])
def test_streamed_half_f32_matches_jax(l, causal, tp, softmax):
    x, ap, want = case(l, causal, tp)
    got = long_half(torch.from_numpy(x), ap, HEADS // tp, causal, softmax).numpy()
    assert_f32_close(got, want)


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [65, 100, 256, 3072])
def test_streamed_half_bf16_within_the_half_limits(l, causal, tp, softmax):
    """The bf16 model against JAX's f32 half on the same bf16 inputs, as
    ``chip_smoke.py``'s tp_kernel_long holds the kernel."""
    x, ap, _ = case(l, causal, tp)
    xb = torch.from_numpy(x).bfloat16()
    apb = tblock.AttnHalfParams(*(t.bfloat16() for t in ap))
    want = jax_half(xb.float().numpy(), apb, l, HEADS // tp, causal)
    got = long_half(xb, apb, HEADS // tp, causal, softmax)
    assert got.abs().max() > 0
    assert_half_close(got.numpy(), want)


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("tp", [2, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [65, 100, 256, 3072])
def test_pair_items_half_bf16_within_the_half_limits(l, causal, tp, softmax):
    """Pair items (no tile one item: every tile two 64-row items whose
    warpgroups sum the even and the odd key blocks apart) and a mix (the
    first tile one item) against JAX's f32 half on the same bf16 inputs."""
    x, ap, _ = case(l, causal, tp)
    xb = torch.from_numpy(x).bfloat16()
    apb = tblock.AttnHalfParams(*(t.bfloat16() for t in ap))
    want = jax_half(xb.float().numpy(), apb, l, HEADS // tp, causal)
    for big in (0, 1):
        assert_half_close(long_half(xb, apb, HEADS // tp, causal, softmax, big).numpy(), want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("l", [100, 256, 768])
def test_half_bf16_limit_sees_a_dropped_key_block(l, tp):
    """With wq and wk ``chip_smoke.LONG_QK_SCALE`` wider (scores of std about
    2.5), the streamed bf16 half stays within the halves' bf16 limit of
    JAX's f32 half, and ``chip_smoke.dropped_keys_half_ref``, the plain half
    without the last key block the kernel streams, does not: the limit sees
    a wrong attention."""
    p = block_params(C, C, seed=l + tp)
    p = p._replace(wq=chip_smoke.LONG_QK_SCALE * p.wq, wk=chip_smoke.LONG_QK_SCALE * p.wk)
    apb = shard(p, tp, 0, torch.bfloat16)
    apf = tblock.AttnHalfParams(*(t.float() for t in apb))
    x = np.random.default_rng(l).normal(size=(2, l, C)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    want = jax_half(xb.float().numpy(), apb, l, HEADS // tp, False)
    assert_half_close(long_half(xb, apb, HEADS // tp, False, "fast").numpy(), want)
    cut = tblock.LONG_KEY_BLOCK * ((l - 1) // tblock.LONG_KEY_BLOCK)
    wrong = chip_smoke.dropped_keys_half_ref(xb.float(), apf, l, HEADS // tp, False, cut).numpy()
    assert np.any(np.abs(wrong - want) > HALF_ATOL + HALF_RTOL * np.abs(want))


# Flagship long shapes (8 heads, MLP ratio 1): L, X, A at C 256; C at L 256,
# width 128 (head dim 16).
FLAGSHIP = {"L": (768, 256), "X": (192, 256), "A": (3072, 256), "C": (256, 128)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("axis", sorted(FLAGSHIP))
def test_every_flagship_long_shard_has_a_plan_that_fits(axis, tp, dtype):
    """Every shard at tp 2, 4 and 8: tp 8 at C 256 a 32-wide shard, the C
    block at tp 8 a 16-wide one (one head of 16), each padded to one group;
    the halves' checks take both."""
    _, c = FLAGSHIP[axis]
    local, heads = c // tp, 8 // tp
    plan = tblock.half_long_plan(c, local, heads, dtype)
    tblock._check_half_x(torch.zeros((1, 2, c), dtype=dtype), c, local)
    assert tblock.half_plan("mlp", 1, c, local, dtype).width == max(64, local)
    qkv, attn = tblock.half_long_smem(plan, c, dtype)
    assert qkv <= tblock.SMEM_OPTIN and attn <= tblock.SMEM_OPTIN
    assert plan.width == -(-local // 64) * 64 and plan.np[0] == tblock.SM90_QKV_N
    assert plan.rows == (64 if dtype == torch.float32 else 128)
    assert plan.qkv_stages in (0, 4) and 3 <= plan.qkv_parts <= tblock.LONG_QKV_MAX_PARTS
    assert 2 <= plan.stages <= 4
    assert plan.f32 == (dtype == torch.float32) and len(plan.ints()) == 11
    # The qkv weights resident at the C block's shards (one group: 48 KB of
    # bf16 slabs, 96 KB of f32), streamed through a ring of 4 at C 256 (two
    # or more groups; one group fits nowhere but at C 128).
    assert plan.qkv_resident == (c == 128)
    # The attention kernel: the block's item rows (bf16 two warpgroups of 64,
    # f32 64), the deepest rings, two q slots in bf16; its tail tiles apart.
    assert plan.items == (64 if dtype == torch.float32 else 128) and plan.overlap == 0
    assert plan.kv_stages == 4 and plan.stages == 4
    assert plan.q_slots == (1 if dtype == torch.float32 else 2)
    # The qkv kernel is the long block's: the same layout and bytes at the
    # same rows and width.
    assert (plan.rows, plan.qkv_stages, plan.qkv_parts, plan.qkv_split) == \
        tblock.long_qkv_layout(c, plan.width, dtype)
    assert qkv == tblock._long_qkv_smem(plan.rows, plan.qkv_stages, plan.qkv_parts, c,
                                        plan.width, dtype, plan.qkv_split)
    if plan.width == c:  # the block's own qkv entry at this width
        block = tblock.long_plan(c, c, 8, dtype)
        assert qkv == tblock.long_smem(block, c, c, dtype)[0]


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [65, 192, 256, 257, 768, 3072])
def test_item_map_covers_every_query_once(l, dtype, tp):
    """The half's items (``long_item_map`` of its plan, the attention
    kernel's ``item_at``): every (sequence, query) in exactly one item, at
    ragged and whole last tiles, with every tile one item, none, and some
    (bf16 pair items; f32 launches none); no item crosses a sequence; empty
    items only as the second half of a ragged tile's pair."""
    s = 3
    plan = tblock.half_long_plan(C, C // tp, HEADS // tp, dtype)
    tiles = s * -(-l // plan.items)
    for big in sorted({tiles, 0, tiles // 2, 1}) if dtype == torch.bfloat16 else (tiles,):
        seen = np.zeros((s, l), dtype=np.int64)
        for seq, q0, rows, valid in tblock.long_item_map(plan, s, l, big):
            assert rows in (plan.items, 64) and 0 <= seq < s
            if valid <= 0:
                assert rows == 64 and q0 >= l and q0 % plan.items == 64
                continue
            assert q0 + valid <= l and valid <= rows
            seen[seq, q0:q0 + valid] += 1
        assert (seen == 1).all()


def test_pair_items_and_reads_at_the_flagship():
    """The launch's choice (``long_big_tiles``, the mirror of
    ``long_sm90.cuh:pair_items``) for the half at tp 2 on an H100's 132 SMs:
    A and L end on 60 tiles past the first wave (run as 120 pair items), X's
    124 stays whole, the C block's 48 past 372 waves go as pairs, f32 has
    none.  The C block's workspace reads: 49,152 items of 16 KB of q and
    64 KB of k|v (about 3.9 GB, against 7.1 GB for one 64-query tile a
    CTA), beside the 2.4 GB the workspace holds."""
    bf16, f32 = torch.bfloat16, torch.float32
    a = tblock.half_long_plan(256, 128, 4, bf16)
    assert tblock.long_big_tiles(a, 8 * 24, 132, bf16) == 132            # A
    assert tblock.long_big_tiles(a, 32 * 6, 132, bf16) == 132            # L
    assert tblock.long_big_tiles(a, 128 * 2, 132, bf16) == 256           # X
    c = tblock.half_long_plan(128, 64, 4, bf16)
    assert tblock.long_big_tiles(c, 24576 * 2, 132, bf16) == 372 * 132
    af = tblock.half_long_plan(256, 128, 4, f32)
    assert tblock.long_big_tiles(af, 8 * 48, 132, f32) == 8 * 48
    whole = tblock.long_attn_reads(c, 24576, 256, c.width, False, False, bf16)
    assert whole["items"] == 49152
    assert whole["bytes_read"] == 49152 * (16384 + 65536)
    assert whole["unique_bytes"] == 3 * 24576 * 256 * 64 * 2
    pairs = tblock.long_attn_reads(c, 24576, 256, c.width, False, False, bf16, 372 * 132)
    assert pairs["items"] == 372 * 132 + 96
    assert pairs["bytes_read"] - whole["bytes_read"] == 48 * 65536  # a pair tile's k|v twice


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 128, 192, 256, 320, 384, 448, 512])
def test_every_envelope_shard_has_a_plan_that_fits(c, dtype):
    """Every shard width of the envelope (a multiple of 16 up to C, padded
    to 64-column groups; f32 C <= 256): both kernels within ``SMEM_OPTIN``,
    the qkv kernel on the block's layout at the padded width (the same as
    the block's own qkv entry where that width is C)."""
    if dtype == torch.float32 and c > tblock.SM90_F32_MAX_C:
        assert tblock.half_long_plan(c, c // 2, c // 32, dtype) is None
        return
    for local in range(16, c + 1, 16):
        plan = tblock.half_long_plan(c, local, local // 16, dtype)  # heads of 16
        assert plan is not None and plan.width == -(-local // 64) * 64
        assert max(tblock.half_long_smem(plan, c, dtype)) <= tblock.SMEM_OPTIN
        layout = (plan.rows, plan.qkv_stages, plan.qkv_parts, plan.qkv_split)
        assert layout == tblock.long_qkv_layout(c, plan.width, dtype)
        if plan.width == c:
            block = tblock.long_plan(c, c, c // 64, dtype)
            assert (block.rows, block.qkv_stages, block.qkv_parts, block.qkv_split) == layout


def test_plan_envelope():
    assert tblock.half_long_plan(512, 256, 4, torch.float32) is None   # f32 C <= 256
    assert tblock.half_long_plan(256, 96, 12, torch.bfloat16) is None  # head dim 8
    assert tblock.half_long_plan(256, 48, 3, torch.bfloat16).width == 64  # 3 heads of 16, padded
    with pytest.raises(ValueError, match="multiple of 16"):             # no head of 16 fits
        tblock._check_half_x(torch.zeros((1, 2, 256)), 256, 40)
    assert tblock.half_long_plan(256, 512, 8, torch.bfloat16) is None  # wider than C
    big = tblock.half_long_plan(512, 256, 4, torch.bfloat16)
    assert big.rows == 64 and max(tblock.half_long_smem(big, 512, torch.bfloat16)) <= \
        tblock.SMEM_OPTIN
    assert tblock.half_long_plan(192, 96, 3, torch.bfloat16).width == 128  # padded


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_half_chunks_agree_with_one_chunk(monkeypatch, causal, dtype):
    """``attn_half_ref`` over chunks of sequences (here 2 a chunk, 4 chunks)
    against one chunk of all seven: the sequences are independent."""
    ap = shard(block_params(C, C, seed=4), 2, 1, dtype)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(7, 80, C)).astype(np.float32))
    x = x.to(dtype)
    whole = tblock.attn_half_ref(x, ap, 80, HEADS // 2, causal)
    monkeypatch.setattr(tblock, "REF_SCORE_BYTES", 2 * (HEADS // 2) * 80 * 80 * 4)
    chunked = tblock.attn_half_ref(x, ap, 80, HEADS // 2, causal)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(chunked, whole, atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_half_and_launch_nothing():
    ap = shard(block_params(C, C, seed=6), 2, 0)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 100, C)).astype(np.float32))
    tblock.reset_launches()
    want = tblock.attn_half_ref(x, ap, 100, HEADS // 2, True)
    torch.testing.assert_close(tblock.attn_half_apply(x, ap, 100, HEADS // 2, True), want)
    torch.testing.assert_close(tblock.attn_half_long(x, ap, 100, HEADS // 2, True), want)
    assert not any(fn.launches for fn in tblock.WRAPPERS)
    with pytest.raises(ValueError, match="CUDA"):
        tblock._launch_half_long(x, ap, 100, HEADS // 2, True)
    plan = tblock.half_long_plan(C, C // 2, HEADS // 2)
    with pytest.raises(ValueError, match="CUDA"):  # each kernel's launcher alike
        tblock.half_long_qkv_fwd(x, None, plan, 100, C // 2)
    with pytest.raises(ValueError, match="CUDA"):
        tblock.half_long_attn_fwd(x, x, None, plan, 100, C // 2, HEADS // 2, True)
