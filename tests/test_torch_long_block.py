"""The long block entry's arithmetic and Python side, on the CPU.

The long entry (``ops/csrc/fused_block_long_sm90.cu``) runs a block at any
sequence length as two kernels: q|k|v of token tiles into a workspace, then
an attention entry on a persistent grid whose work items are (sequence,
R query rows): R = 128 in bf16 (two warpgroups of 64 rows), 64 in f32, and
in bf16 the tiles past the grid's last whole wave as two 64-row "pair"
items each, whose warpgroups take the even and the odd key blocks and add
their sums.  ``long_block`` below is that order of work in PyTorch
(``fused_block.long_item_map``'s items): the "fast" softmax key block by
key block (``exp2(min(s, 60 log2 e))`` of the admitted keys, the f32
denominator summed per block, the unnormalised weights rounded to the
activation dtype before the AV product, the result scaled by
``1 / (sum + 1e-30)`` after it), the "safe" softmax in two passes (each
row's maximum over all its keys, then ``exp2(s - max)``), causal masks, the
activation dtype's rounding points (bf16: q/k/v, the weights, the attention
output, the fc1 output and both residual sums), and in f32 the scores and
the AV product as 3xTF32 (``_torch_tf32.mm3``).  It is held against the JAX
package's block (``_xla_block``, what JAX runs off the TPU) on the same
numpy-seeded inputs: f32 within the card's f32 tolerance (``chip_smoke.py``:
relative L2 <= 1e-5, max abs <= 1e-4 max |ref|); bf16 against JAX's bf16
block within the card's bf16 kernel tolerance (5e-2 abs + 2e-2 rel: both
round to bf16, at places that differ).  ``test_torch_long_half.py`` models
the long half's attention kernel, which runs the same design, on
``item_attention``.

With wq and wk widened as ``chip_smoke.py`` seeds them for the card, the
bf16 limit sees a wrong attention (its control, the last key block
dropped).  Then the item map (every query of every sequence in exactly one
item), the plan's envelope and its fit at every flagship shape, the fusion
gates, the plain block's chunked attention, and what the wrappers do with a
CPU tensor."""

import functools

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import block_params, to_torch
from _torch_tf32 import mm3
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.ops.activations import gelu_tanh_f32

C, HEADS = 64, 4          # a short width: head dim 16, the C block's
REL_L2, MAX_ABS_SHARE = 1e-5, 1e-4
BF16_ATOL, BF16_RTOL = 5e-2, 2e-2
LOG2E = 1.4426950408889634
ROWS = {65: 3, 100: 3, 256: 2, 3072: 1}  # sequences per case


def rounder(dt):
    """Round to the activation dtype ``dt``, back to f32 for the sums."""
    return lambda t: t.to(dt).float()


def long_qkv(x, p, heads):
    """The qkv kernel's order of work: LN1 and q (prescaled by d^-0.5 log2 e
    in the weights), k, v of the attention width ``wq.shape[-1]`` (the
    block's C, or a tp shard's), rounded to x's dtype; each (S, heads, L, d)."""
    r, f = rounder(x.dtype), (lambda t: t.float())
    s, l, _ = x.shape
    d = p.wq.shape[-1] // heads
    qs = d**-0.5 * LOG2E
    xn = r(tblock.ln(x, p.ln1_scale, p.ln1_bias))
    q = r(xn @ r(p.wq * qs) + r(p.bq * qs))
    k = r(xn @ f(p.wk) + f(p.bk))
    v = r(xn @ f(p.wv) + f(p.bv))
    return tuple(t.reshape(s, l, heads, d).transpose(1, 2) for t in (q, k, v))


def item_attention(q, k, v, causal, softmax, dt, items, tile_rows, kb=tblock.LONG_KEY_BLOCK):
    """The attention entry's order of work on (S, heads, L, d) q/k/v over
    ``items`` (``long_item_map`` of ``tile_rows``-row tiles): per item its
    query rows against the key blocks its queries admit, the sums of a pair
    item's (a half tile's) even and odd blocks added at the end; f32
    products as 3xTF32.  (S, L, heads * d) in ``dt``."""
    r = rounder(dt)
    s, heads, l, d = q.shape
    mm = mm3 if dt == torch.float32 else (lambda a, b: a @ b)
    out = torch.zeros(s, heads, l, d)
    for seq, q0, rows, valid in items:
        if valid <= 0:
            continue
        qi = torch.arange(q0, q0 + valid)[:, None]
        kend = q0 + valid if causal else l
        blocks = list(range(0, kend, kb))
        pair = rows < tile_rows

        def scores(k0):
            kk = k[seq, :, k0:k0 + kb]
            sc = torch.stack([mm(q[seq, h, q0:q0 + valid], kk[h].T) for h in range(heads)])
            keys = torch.arange(k0, k0 + kk.shape[1])[None, :]
            ok = keys <= qi if causal else torch.ones(valid, keys.shape[1], dtype=torch.bool)
            return sc, ok

        mx = torch.full((heads, valid, 1), -1e30)
        if softmax == "safe":
            for k0 in blocks:
                sc, ok = scores(k0)
                mx = torch.maximum(mx, sc.masked_fill(~ok, -1e30).amax(-1, keepdim=True))
        o = [torch.zeros(heads, valid, d), torch.zeros(heads, valid, d)]
        den = [torch.zeros(heads, valid, 1), torch.zeros(heads, valid, 1)]
        for b, k0 in enumerate(blocks):
            sc, ok = scores(k0)
            e = torch.exp2(sc - mx if softmax == "safe" else torch.clamp(sc, max=60 * LOG2E))
            e = torch.where(ok, e, torch.zeros(()))
            w = b % 2 if pair else 0  # the warpgroup that weighs block b
            den[w] = den[w] + e.sum(-1, keepdim=True)
            vv = v[seq, :, k0:k0 + kb]
            o[w] = o[w] + torch.stack([mm(r(e[h]), vv[h]) for h in range(heads)])
        out[seq, :, q0:q0 + valid] = r((o[0] + o[1]) * (1.0 / ((den[0] + den[1]) + 1e-30)))
    return out.transpose(1, 2).reshape(s, l, heads * d)


def long_block(x, p, l, heads, causal, softmax, kb=tblock.LONG_KEY_BLOCK, big=None):
    """The long entry's order of work on (S, L, C) rows in x's dtype: the
    plan's items (``big`` tiles one item each, all by default; the others
    two pair items)."""
    dt = x.dtype
    r, f = rounder(dt), (lambda t: t.float())
    plan = tblock.long_plan(x.shape[-1], p.w1.shape[-1], heads, dt)
    items = tblock.long_item_map(plan, x.shape[0], l, big)
    attn = item_attention(*long_qkv(x, p, heads), causal, softmax, dt, items, plan.items, kb)
    xm = r(f(x) + r(attn @ f(p.wo) + f(p.bo)))
    yn = r(tblock.ln(xm.to(dt), p.ln2_scale, p.ln2_bias))
    h = r(gelu_tanh_f32(yn @ f(p.w1) + f(p.b1)))
    return r(xm + r(h @ f(p.w2) + f(p.b2)))


@functools.lru_cache(maxsize=None)
def case(l, causal, bf16):
    """(x, params) as numpy, and JAX's block on them (bf16: JAX's bf16 block)."""
    p = block_params(C, C, seed=l + causal)
    x = np.random.default_rng(l).normal(size=(ROWS[l], l, C)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = jblock._xla_block(jnp.asarray(x, jdt), jblock.BlockParams(
        *(jnp.asarray(a, jdt) for a in p)), l, HEADS, causal)
    return x, p, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [65, 100, 256, 3072])
def test_streamed_block_f32_matches_jax(l, causal, softmax):
    x, p, want = case(l, causal, False)
    got = long_block(torch.from_numpy(x), to_torch(p), l, HEADS, causal, softmax).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= REL_L2
    assert np.abs(got - want).max() <= MAX_ABS_SHARE * np.abs(want).max()


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [65, 100, 256, 3072])
def test_streamed_block_bf16_matches_jax_bf16(l, causal, softmax):
    x, p, want = case(l, causal, True)
    xb = torch.from_numpy(x).bfloat16()
    pb = tblock.BlockParams(*(t.bfloat16() for t in to_torch(p)))
    got = long_block(xb, pb, l, HEADS, causal, softmax).numpy()
    assert np.all(np.abs(got - want) <= BF16_ATOL + BF16_RTOL * np.abs(want))


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("l", [100, 256, 768])
def test_bf16_limit_sees_a_dropped_key_block_under_a_peaked_softmax(l, softmax):
    """With wq and wk ``chip_smoke.LONG_QK_SCALE`` times wider (scores of
    std about 2.5), the streamed bf16 block stays within the bf16 limit of
    JAX's f32 block, and ``chip_smoke.dropped_keys_ref``, the plain block
    without the last key block the kernel streams, does not: the limit
    sees a wrong attention."""
    p = block_params(C, C, seed=l)
    p = p._replace(wq=chip_smoke.LONG_QK_SCALE * p.wq, wk=chip_smoke.LONG_QK_SCALE * p.wk)
    x = np.random.default_rng(l).normal(size=(2, l, C)).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).bfloat16().float())  # both sides see bf16 inputs
    pb = tblock.BlockParams(*(t.bfloat16() for t in to_torch(p)))
    pf = tblock.BlockParams(*(t.float() for t in pb))
    want = np.asarray(jblock._xla_block(jnp.asarray(x), jblock.BlockParams(
        *(jnp.asarray(t.numpy()) for t in pf)), l, HEADS, False))
    limit = BF16_ATOL + BF16_RTOL * np.abs(want)
    got = long_block(torch.from_numpy(x).bfloat16(), pb, l, HEADS, False, softmax)
    assert np.all(np.abs(got.float().numpy() - want) <= limit)
    cut = tblock.LONG_KEY_BLOCK * ((l - 1) // tblock.LONG_KEY_BLOCK)
    wrong = chip_smoke.dropped_keys_ref(torch.from_numpy(x), pf, l, HEADS, False, cut).numpy()
    assert np.any(np.abs(wrong - want) > limit)


@pytest.mark.parametrize("softmax", ["fast", "safe"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [65, 100, 256, 3072])
def test_pair_items_bf16_match_jax_bf16(l, causal, softmax):
    """Pair items (no tile one item: every tile two 64-row items whose
    warpgroups sum the even and the odd key blocks apart) and a mix (the
    first tile one item) against JAX's bf16 block at the bf16 kernel
    tolerance."""
    x, p, want = case(l, causal, True)
    xb = torch.from_numpy(x).bfloat16()
    pb = tblock.BlockParams(*(t.bfloat16() for t in to_torch(p)))
    for big in (0, 1):
        got = long_block(xb, pb, l, HEADS, causal, softmax, big=big).numpy()
        assert np.all(np.abs(got - want) <= BF16_ATOL + BF16_RTOL * np.abs(want))


def test_pair_items_only_reorder_the_f32_sums():
    """In f32 (the model's 3xTF32 products) a pair item's two partial sums
    give the whole items' block within f32 rounding."""
    x, p, _ = case(256, False, False)
    xt, pt = torch.from_numpy(x), to_torch(p)
    qkv = long_qkv(xt, pt, HEADS)
    for softmax in ("fast", "safe"):
        whole = item_attention(*qkv, False, softmax, torch.float32,
                               tblock.long_item_map(tblock.long_plan(C, C, HEADS, torch.bfloat16),
                                                    2, 256), 128)
        pairs = item_attention(*qkv, False, softmax, torch.float32,
                               tblock.long_item_map(tblock.long_plan(C, C, HEADS, torch.bfloat16),
                                                    2, 256, big=0), 128)
        torch.testing.assert_close(pairs, whole, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [65, 192, 256, 257, 768, 3072])
def test_item_map_covers_every_query_once(l, dtype):
    """Every (sequence, query) in exactly one item, at ragged and whole last
    tiles, with every tile one item, none, and some (the grid's last wave as
    pair items); no item crosses a sequence; empty items only as the second
    half of a ragged tile's pair."""
    s = 3
    plan = tblock.long_plan(C, C, HEADS, dtype)
    tiles = s * -(-l // plan.items)
    for big in sorted({tiles, 0, tiles // 2, 1}):
        if dtype == torch.float32 and big != tiles:
            continue  # f32 launches no pair items
        seen = np.zeros((s, l), dtype=np.int64)
        for seq, q0, rows, valid in tblock.long_item_map(plan, s, l, big):
            assert rows in (plan.items, 64) and 0 <= seq < s
            if valid <= 0:
                assert rows == 64 and q0 >= l and q0 % plan.items == 64
                continue
            assert q0 + valid <= l and valid <= rows
            seen[seq, q0:q0 + valid] += 1
        assert (seen == 1).all()


def test_pair_items_fill_the_grid_s_last_wave():
    """The launch's choice (``long_big_tiles``, the mirror of
    ``fused_block_long_sm90.cu:pair_items``) at the flagship on an H100's 132
    SMs: A and L end on 60 tiles past the first wave (120 pair items, 1.6
    waves' time against 2), X's 124 (248 pair items: 2.2 against 2) stays
    whole, C's 48 past 372 waves go as pairs, f32 has none; the workspace
    reads count a pair tile's k|v twice."""
    plan = tblock.long_plan(256, 256, 8, torch.bfloat16)
    bf16 = torch.bfloat16
    assert tblock.long_big_tiles(plan, 8 * 24, 132, bf16) == 132           # A
    assert tblock.long_big_tiles(plan, 32 * 6, 132, bf16) == 132           # L
    assert tblock.long_big_tiles(plan, 128 * 2, 132, bf16) == 256          # X
    plan_c = tblock.long_plan(128, 128, 8, bf16)
    assert tblock.long_big_tiles(plan_c, 24576 * 2, 132, bf16) == 372 * 132
    assert tblock.long_big_tiles(plan, 40, 132, bf16) == 0                 # under a wave
    f32 = tblock.long_plan(256, 256, 8, torch.float32)
    assert tblock.long_big_tiles(f32, 384, 132, torch.float32) == 384
    a_whole = tblock.long_attn_reads(plan, 8, 3072, 256, False, False, torch.bfloat16)
    a_pairs = tblock.long_attn_reads(plan, 8, 3072, 256, False, False, torch.bfloat16, 132)
    assert (a_whole["items"], a_pairs["items"]) == (192, 132 + 120)
    kv_tile = 4 * 48 * 64 * 128 * 2  # 4 groups, 48 blocks of 64 keys x 128 values
    assert a_pairs["bytes_read"] - a_whole["bytes_read"] == 60 * kv_tile
    assert a_whole["unique_bytes"] == 3 * 8 * 3072 * 256 * 2


def test_streaming_is_the_softmax_of_all_keys_at_once():
    """Key blocks of 64 and one block of all keys give the same f32 block:
    the streamed sums only reorder."""
    x, p, _ = case(256, True, False)
    xt, pt = torch.from_numpy(x), to_torch(p)
    for softmax in ("fast", "safe"):
        a = long_block(xt, pt, 256, HEADS, True, softmax)
        b = long_block(xt, pt, 256, HEADS, True, softmax, kb=256)
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# Flagship long shapes (8 heads, MLP ratio 1): L, X, A at C 256; C at L 256,
# width 128 (head dim 16).
FLAGSHIP = {"L": (768, 256), "X": (192, 256), "A": (3072, 256), "C": (256, 128)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("axis", sorted(FLAGSHIP))
def test_every_flagship_long_shape_has_a_plan_that_fits(axis, dtype):
    """Both entries within ``SMEM_OPTIN``; bf16 items of 128 rows with the
    tail's tiles apart from the q slots and the ring (so the next item's
    copies run under a tail, and pair items have their exchange area), x'
    kept in shared memory at the C block (f32: beside a k|v ring of 2); at
    least three weight stages, and three k|v stages elsewhere."""
    _, c = FLAGSHIP[axis]
    plan = tblock.long_plan(c, c, 8, dtype)
    assert plan is not None
    qkv, attn = tblock.long_smem(plan, c, c, dtype)
    assert qkv <= tblock.SMEM_OPTIN and attn <= tblock.SMEM_OPTIN
    assert plan.np[0] == tblock.SM90_QKV_N
    assert plan.rows == (64 if dtype == torch.float32 else 128)
    # The qkv entry: its weights resident at the bf16 C block (96 KB of
    # slabs); in f32 at C 128 LN1's output split in TF32 hi / lo beside a
    # ring of 6; else a ring of 4; at least three staging buffers.
    f32 = dtype == torch.float32
    assert plan.qkv_resident == (not f32 and c == 128)
    assert plan.qkv_split == (f32 and c == 128)
    assert plan.qkv_stages == (0 if plan.qkv_resident else 6 if plan.qkv_split else 4)
    assert 3 <= plan.qkv_parts <= tblock.LONG_QKV_MAX_PARTS
    assert 3 <= plan.stages <= 4 and 2 <= plan.kv_stages <= 4
    assert plan.items == (64 if dtype == torch.float32 else 128)
    assert plan.q_slots == 1 or dtype == torch.bfloat16
    assert plan.overlap == (dtype == torch.float32 and c == 256)
    assert plan.keep == (c == 128)  # bf16: one out-projection pass; f32: room beside the ring
    assert plan.kv_stages >= (2 if plan.keep and dtype == torch.float32 else 3)
    assert len(plan.ints()) == 14


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 128, 192, 256, 320, 384, 448, 512])
def test_every_envelope_width_has_a_qkv_layout_that_fits(c, dtype):
    """The qkv layout (``long_qkv_layout``, the mirror of ``long_sm90.cuh:
    layout_qkv``) at every C of the envelope (f32 to 256) and every
    attention width a multiple of 64 up to C: within ``SMEM_OPTIN`` with at
    least three staging buffers; the weights resident exactly where all
    width/64 groups' slabs fit beside the x slot, the LN1 tile and three
    buffers, else the deepest ring that fits; LN1's output split (f32, C <=
    128) wherever it fits beside that weights mode or a ring; the block's
    plan takes the layout at width C, and both of its entries fit for hidden
    C and 2C."""
    if dtype == torch.float32 and c > tblock.SM90_F32_MAX_C:
        assert tblock.long_plan(c, c, c // 64, dtype) is None
        return
    fits = lambda *a: tblock._long_qkv_smem(*a) <= tblock.SMEM_OPTIN  # noqa: E731
    for width in range(64, c + 1, 64):
        rows, stages, parts, split = tblock.long_qkv_layout(c, width, dtype)
        assert rows == (64 if dtype == torch.float32 or c > 256 else 128)
        assert 3 <= parts <= tblock.LONG_QKV_MAX_PARTS
        assert stages == 0 or 2 <= stages <= tblock.LONG_QKV_MAX_STAGES
        assert split in (0, 1) and (not split or (dtype == torch.float32 and c <= 128))
        assert fits(rows, stages, parts, c, width, dtype, split)
        resident_fits = fits(rows, 0, 3, c, width, dtype)
        assert (stages == 0) == resident_fits
        if stages:
            assert not any(fits(rows, st, 3, c, width, dtype, split)
                           for st in range(stages + 1, tblock.LONG_QKV_MAX_STAGES + 1))
            if dtype == torch.float32 and c <= 128:
                assert split == any(fits(rows, st, 3, c, width, dtype, 1)
                                    for st in range(2, tblock.LONG_QKV_MAX_STAGES + 1))
        more = parts + 1
        assert more > tblock.LONG_QKV_MAX_PARTS or not fits(rows, stages, more, c, width, dtype,
                                                            split)
    for hidden in (c, 2 * c):
        plan = tblock.long_plan(c, hidden, c // 64, dtype)
        assert plan is not None
        assert (plan.rows, plan.qkv_stages, plan.qkv_parts, plan.qkv_split) == \
            tblock.long_qkv_layout(c, c, dtype)
        assert max(tblock.long_smem(plan, c, hidden, dtype)) <= tblock.SMEM_OPTIN


def qkv_cover(s, l, rows, width, dtype):
    """Each workspace row (part, sequence, group, position) the runs of
    ``long_qkv_runs`` store, counted; the runs checked for alignment."""
    e = 4 if dtype == torch.float32 else 2
    groups = width // 64
    seen = np.zeros((3, s, groups, l), dtype=np.int64)
    for tile, p, gi, seq, pos, n, dst, src, nbytes in tblock.long_qkv_runs(s, l, rows, width,
                                                                             dtype):
        assert n >= 1 and pos + n <= l
        assert dst % 16 == 0 and src % 16 == 0 and nbytes % 16 == 0 and nbytes == n * 64 * e
        assert src + nbytes <= rows * 64 * e  # inside the part's staging buffer
        assert tile * rows + src // (64 * e) == seq * l + pos  # the run's first token
        assert dst == (((p * s + seq) * groups + gi) * l + pos) * 64 * e
        seen[p, seq, gi, pos:pos + n] += 1
    return seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("l", [1, 100, 192, 256, 257, 768, 3072])
def test_qkv_store_runs_cover_the_workspace_once(l, rows, dtype):
    """The qkv kernels' bulk stores (``long_qkv_runs``): every workspace
    row of every part, sequence and group in exactly one run, each run
    16-byte aligned and sized, within its staging buffer, never across a
    sequence's end; token counts that are and are not a multiple of the
    tile's rows, one and two head groups."""
    for s, width in ((3, 64), (5, 128)):
        if l == 3072 and s == 5:
            s = 2
        seen = qkv_cover(s, l, rows, width, dtype)
        assert (seen == 1).all(), (s, l, rows, width)


def test_qkv_store_runs_split_only_at_a_sequence_end():
    """A tile inside one sequence is one run per part and group (the C
    block: L 256, 128-row tiles); a tile that crosses sequence ends makes
    one run per sequence it touches (X at L 192: 128-row tiles cross every
    other sequence's end; L 1: one run a row)."""
    runs = tblock.long_qkv_runs(4, 256, 128, 128, torch.bfloat16)
    assert len(runs) == 8 * 2 * 3 and all(r[5] == 128 for r in runs)
    runs = tblock.long_qkv_runs(2, 192, 128, 64, torch.bfloat16)
    per_tile = {}
    for r in runs:
        per_tile[r[0]] = per_tile.get(r[0], 0) + 1
    assert per_tile == {0: 3, 1: 3 * 2, 2: 3}  # rows 128-255 cross the end at 192
    assert len(tblock.long_qkv_runs(1, 1, 128, 64, torch.float32)) == 3


def test_plan_envelope():
    assert tblock.long_plan(512, 512, 8, torch.float32) is None     # f32 C <= 256
    assert tblock.long_plan(64, 64, 8, torch.bfloat16) is None      # head dim 8
    assert tblock.long_plan(256, 768, 8, torch.bfloat16) is None    # hidden > 2C
    assert tblock.long_plan(512, 1024, 8, torch.bfloat16) is not None
    assert tblock.long_plan(256, 256, 8, torch.float32) is not None
    big = tblock.long_plan(512, 1024, 8, torch.bfloat16)
    assert max(tblock.long_smem(big, 512, 1024, torch.bfloat16)) <= tblock.SMEM_OPTIN
    # The plan holds at every L; the wrapper's own check refuses L < 1.
    p = tblock.BlockParams(*(t.clone() for t in to_torch(block_params(C, C, seed=3))))
    with pytest.raises(ValueError, match="L=0"):
        tblock._check_block_args(torch.zeros((2, 0, C)), p, 0, HEADS, max_l=None)
    tblock._check_block_args(torch.zeros((2, 3072, C)), p, 3072, HEADS, max_l=None)


def test_fusion_gates_refuse_c_and_long_axes():
    dims = (4, 16, 48)
    for axes in ("L", "THWL", "CH", "THWC", "XA"):
        assert not tblock.group_fusable(axes, dims, 256, 8)
        assert not tblock.chain_fusable(axes, dims, 256, 8)
    assert tblock.chain_fusable("THW", dims, 256, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_block_chunks_agree_with_one_chunk(monkeypatch, causal, dtype):
    """``block_ref`` over chunks of sequences (here 2 a chunk, 4 chunks)
    against one chunk of all seven: the sequences are independent."""
    p = tblock.BlockParams(*(t.to(dtype) for t in to_torch(block_params(C, C, seed=4))))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(7, 80, C)).astype(np.float32))
    x = x.to(dtype)
    whole = tblock.block_ref(x, p, 80, HEADS, causal)
    monkeypatch.setattr(tblock, "REF_SCORE_BYTES", 2 * HEADS * 80 * 80 * 4)
    chunked = tblock.block_ref(x, p, 80, HEADS, causal)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(chunked, whole, atol=tol, rtol=tol)


def test_plain_block_chunk_size_bounds_the_scores():
    """At the flagship C block's shape (8 heads, L 256) a chunk holds 512
    sequences: 1 GiB of f32 scores."""
    per = tblock.REF_SCORE_BYTES // (8 * 256 * 256 * 4)
    assert per == 512


def test_cpu_tensors_take_the_plain_block_and_launch_nothing():
    p = to_torch(block_params(C, C, seed=6))
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 100, C)).astype(np.float32))
    tblock.reset_launches()
    want = tblock.block_ref(x, p, 100, HEADS, False)
    torch.testing.assert_close(tblock.fused_block_apply(x, p, 100, HEADS, False), want)
    torch.testing.assert_close(tblock.fused_block_long(x, p, 100, HEADS, False), want)
    assert not tblock.long_qkv_fwd.launches and not tblock.long_attn_fwd.launches
    assert not tblock.fused_block_apply.launches
    with pytest.raises(ValueError, match="CUDA"):
        tblock._launch_long(x, p, 100, HEADS, False)
    plan = tblock.long_plan(C, C, HEADS)
    with pytest.raises(ValueError, match="CUDA"):  # each kernel's launcher alike
        tblock.long_qkv_fwd(x, None, plan, 100)
    with pytest.raises(ValueError, match="CUDA"):
        tblock.long_attn_fwd(x, x, None, plan, 100, HEADS, False)
