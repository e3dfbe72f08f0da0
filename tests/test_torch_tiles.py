"""The Python side of the Hopper kernels, on the CPU: the block kernel's
weight re-layout and tile plan (``ops/fused_block.py``: ``arrange_weight``,
``sm90_plan``, ``sm90_weights``), the mode-mixing kernel's tile plan
(``ops/fused_spectral.py``: ``tile_plan``), and the
"safe" softmax switch (``set_block_tuning``) against the JAX package's.

The re-laid weight is read back here the way the kernel's wgmma
descriptors read it (core matrix (n/8, k/8) of a slab at ((n/8) * 4 + k/8)
* 64 elements, a pass's slabs in K order): the matmul over what the kernel
would see must equal the matmul over the original weight exactly.  The
safe-softmax model test compares f32 on the CPU at the block tests' 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import B, flatten, unarrange_weight
from tante_tpu.models.attn_backbone import AttnBackbone as JaxBackbone
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.models.attn_backbone import AttnBackbone
from tante_tpu_torch.ops import fused_block as tblock
from tante_tpu_torch.ops import fused_spectral as fs

import jax

ATOL = RTOL = 1e-5


def tile_rows(n_seqs: int, l: int, plan) -> list:
    """The rows of (S*L) each CTA's tile covers, in launch order (the
    kernel's ``seq0 = blockIdx.x * seqs``)."""
    per = plan.seqs * l
    return [range(i * per, min((i + 1) * per, n_seqs * l)) for i in range(-(-n_seqs // plan.seqs))]


def tile_cover(b: int, m: int, co: int, tile: tuple) -> torch.Tensor:
    """How many threads own each output element (B, M, Cout): the mode-mixing
    kernel's index arithmetic (``spectral_matmul.cu``: ``m0``, ``o0``,
    ``b0``), on the CPU."""
    lo, bt, _ = tile
    mt, ot, nb = fs.kernel_grid(b, m, co, tile)
    count = torch.zeros(b, m, co, dtype=torch.int32)
    for x in range(mt * ot):
        for y in range(nb):
            for lane in range(32):
                m0 = ((x % mt) * (32 // lo) + lane // lo) * 2
                o0 = ((x // mt) * lo + lane % lo) * fs.OUT_PER_THREAD
                count[y * bt:(y + 1) * bt, m0:min(m0 + 2, m), o0:o0 + fs.OUT_PER_THREAD] += 1
    return count


def kernel_view(slabs: torch.Tensor, k: int, n: int, np_: int) -> torch.Tensor:
    """The (K, N) weight as the kernel's wgmma B operands see it: for each
    pass, each 32-row slab, each 64-column unit and each 16-deep step, the
    64 x 16 block read through the descriptor arithmetic."""
    out = torch.full((k, n), float("nan"), dtype=slabs.dtype)
    slab_elems = 32 * np_
    for p in range(n // np_):
        for kc in range(k // 32):
            slab = slabs[(p * (k // 32) + kc) * slab_elems:][:slab_elems]
            for unit in range(np_ // 64):
                for ks in range(2):
                    start = ((unit * 8) * 4 + ks * 2) * 64
                    for nn in range(64):
                        for kk in range(16):
                            # LBO: 64 elements between the two K halves of a
                            # step; SBO: 256 between groups of 8 columns.
                            off = start + (nn // 8) * 256 + (kk // 8) * 64 + (nn % 8) * 8 + kk % 8
                            out[kc * 32 + ks * 16 + kk, p * np_ + unit * 64 + nn] = slab[off]
    return out


@pytest.mark.parametrize("k,n,np_", [(64, 192, 192), (128, 256, 256), (256, 512, 256),
                                     (64, 384, 192), (128, 128, 128), (192, 320, 64)])
def test_weight_relayout_round_trips_exactly(k, n, np_):
    w = torch.from_numpy(np.random.default_rng(k + n).normal(size=(k, n)).astype(np.float32))
    flat = tblock.arrange_weight(w.to(torch.bfloat16), np_)
    assert flat.shape == (k * n,)
    assert torch.equal(unarrange_weight(flat, k, n, np_), w.to(torch.bfloat16))


@pytest.mark.parametrize("k,n,np_", [(64, 192, 192), (128, 128, 64)])
def test_matmul_over_the_relaid_weight_equals_the_original(k, n, np_):
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(8, k)).astype(np.float32))
    seen = kernel_view(tblock.arrange_weight(w, np_), k, n, np_)
    assert torch.equal(a @ seen, a @ w)


def test_qkv_groups_hold_each_head_groups_columns():
    p = tblock.BlockParams(*(torch.from_numpy(np.asarray(t)) for t in _block(128, 256, 3)))
    heads, d = 8, 16
    ws, bs = tblock.qkv_groups(p, heads)
    qs = d**-0.5 * tblock.LOG2E
    assert len(ws) == 2 and bs.shape == (2 * 192,)
    for g, w in enumerate(ws):
        cols = slice(64 * g, 64 * g + 64)
        torch.testing.assert_close(w[:, :64], p.wq[:, cols] * qs, rtol=0, atol=0)
        assert torch.equal(w[:, 64:128], p.wk[:, cols]) and torch.equal(w[:, 128:], p.wv[:, cols])
        torch.testing.assert_close(bs[192 * g:192 * g + 64], p.bq[cols] * qs, rtol=0, atol=0)
        assert torch.equal(bs[192 * g + 128:192 * g + 192], p.bv[cols])


def _block(c, hidden, seed):
    from _torch_parity import block_params

    return block_params(c, hidden, seed)


def test_relaid_weights_are_made_once_per_weight_version():
    p = tblock.BlockParams(*(torch.from_numpy(np.asarray(t)).to(torch.bfloat16)
                             for t in _block(64, 64, 1)))
    plan = tblock.sm90_plan(16, 64, 64)
    first = tblock.sm90_weights(p, 4, plan)
    assert tblock.sm90_weights(p, 4, plan) is first
    with torch.no_grad():
        p.w1.mul_(2.0)  # an optimizer step updates in place: a new version
    second = tblock.sm90_weights(p, 4, plan)
    assert second is not first
    assert torch.equal(unarrange_weight(second.slabs[-2 * 64 * 64:-64 * 64], 64, 64, 64),
                       p.w1)
    p.w2.data = p.w2.data * 3.0  # new storage, same tensor and version (as Module.to does)
    third = tblock.sm90_weights(p, 4, plan)
    assert third is not second
    assert torch.equal(unarrange_weight(third.slabs[-64 * 64:], 64, 64, 64), p.w2)


def test_relaid_weights_of_a_bf16_block_over_f32_parameters_are_made_once_per_step():
    """A Trainer's block keeps f32 parameters and casts them to its bf16
    compute dtype on every call: the re-layout is cached under the
    parameters (``cast_weight``), so it is made once per optimizer step."""
    from tante_tpu_torch.models.common import FusedTransformerBlock

    block = FusedTransformerBlock(64, 4, mlp_ratio=1.0, dropout=0.0, dtype=torch.bfloat16,
                                  gen=torch.Generator().manual_seed(0))
    plan = tblock.sm90_plan(16, 64, 64)
    first_p = block.block_params()
    first = tblock.sm90_weights(first_p, 4, plan)
    again_p = block.block_params()
    assert again_p.w1 is not first_p.w1 and again_p.w1.dtype == torch.bfloat16
    assert tblock.sm90_weights(again_p, 4, plan) is first
    opt = torch.optim.SGD(block.parameters(), lr=0.1)
    block.w1.grad = torch.ones_like(block.w1)
    opt.step()  # in place on the f32 parameter: a new version
    p = block.block_params()
    second = tblock.sm90_weights(p, 4, plan)
    assert second is not first
    assert torch.equal(unarrange_weight(second.slabs[-2 * 64 * 64:-64 * 64], 64, 64, 64), p.w1)
    assert tblock.sm90_weights(block.block_params(), 4, plan) is second


@pytest.mark.parametrize("n_seqs,l", [(1536, 16), (512, 48), (6144, 4), (7, 48), (21, 3),
                                      (40, 8), (3, 64), (10, 33)])
def test_block_tiles_cover_every_row_once(n_seqs, l):
    plan = tblock.sm90_plan(l, 256, 256)
    tiles = tile_rows(n_seqs, l, plan)
    rows = [r for t in tiles for r in t]
    assert rows == list(range(n_seqs * l))
    for t in tiles:  # whole sequences, within the tile's rows
        assert len(t) <= plan.rows and t.start % l == 0 and len(t) % l == 0
    if (n_seqs, l) in [(1536, 16), (512, 48), (6144, 4)]:  # the flagship: 128-row tiles
        assert plan.rows == 128 and len(tiles) in (192, 256)


def test_block_plan_keeps_the_whole_envelope_and_refuses_outside_it():
    for c in range(64, 513, 64):
        for hidden in range(64, 2 * c + 1, 64):
            for l in (1, 3, 4, 16, 48, 64):
                plan = tblock.sm90_plan(l, c, hidden)
                assert plan is not None, (l, c, hidden)
                assert tblock.sm90_smem(plan.rows, c, hidden, plan.np, plan.stages) <= \
                    tblock.SMEM_OPTIN
                assert plan.rows >= l and plan.stages >= 2
    for l, c, hidden in [(65, 256, 256), (16, 576, 576), (16, 96, 96), (16, 256, 576),
                         (16, 256, 200), (0, 256, 256)]:
        assert tblock.sm90_plan(l, c, hidden) is None, (l, c, hidden)


SPECTRAL_SHAPES = [  # (B, modes, Cin, Cout): the main paths' and ragged ones
    (16, 1024, 4, 32), (16, 64, 64, 128), (16, 64, 128, 64), (16, 1024, 32, 4),
    (4, 220, 48, 48), (64, 1024, 4, 32), (1, 7, 4, 4), (3, 65, 38, 48), (3, 15, 128, 38),
    (9, 60, 48, 128), (1, 33, 1, 1), (4, 20, 304, 152),
]


@pytest.mark.parametrize("b,m,ci,co", SPECTRAL_SHAPES)
def test_spectral_tiles_cover_every_output_once(b, m, ci, co):
    tile = fs.tile_plan(b, m, ci, co)
    lo, bt, ks = tile
    assert lo == (1 if co <= 4 else 2) and bt in (2, 4) and ks in (1, 2, 4, 8)
    assert not (ks == 8 and bt == 4)  # the kernel's static shared memory
    assert (ci + 1) // 2 >= 2 * ks or ks == 1
    assert bool((tile_cover(b, m, co, tile) == 1).all())


def test_spectral_plan_fills_the_card_at_the_main_path_shapes():
    sms = 132  # the H100's
    for b, m, ci, co in SPECTRAL_SHAPES[:5]:
        assert fs.kernel_warps(b, m, co, fs.tile_plan(b, m, ci, co)) >= 4 * sms, (b, m, ci, co)


# --------------------------------------------------------------------------
# The "safe" softmax
# --------------------------------------------------------------------------


@pytest.fixture
def tuning():
    """Both packages' softmax switches, restored after the test."""
    prev_j, prev_t = dict(jblock._TUNE), dict(tblock._TUNE)
    try:
        yield
    finally:
        jblock.set_block_tuning(row_tile=prev_j["row_tile"] or 0, softmax=prev_j["softmax"])
        tblock.set_block_tuning(softmax=prev_t["softmax"])


@pytest.mark.parametrize("softmax", ["fast", "safe"])
def test_canon_t_gate_follows_the_softmax_as_in_jax(tuning, softmax):
    jblock.set_block_tuning(softmax=softmax)
    tblock.set_block_tuning(softmax=softmax)
    for t, c, heads in [(2, 128, 4), (4, 256, 8), (8, 256, 8), (9, 256, 8), (4, 192, 4)]:
        assert tblock.canon_t_supported(t, 4, 8, c, heads) == jblock.canon_t_supported(
            t, 4, 8, c, heads), (softmax, t, c, heads)
    assert tblock.canon_t_supported(4, 16, 48, 256, 8) == (softmax == "fast")


def test_set_block_tuning_takes_only_the_two_softmaxes(tuning):
    with pytest.raises(ValueError):
        tblock.set_block_tuning(softmax="exact")
    tblock.set_block_tuning()  # nothing asked: nothing changes
    assert tblock._TUNE["softmax"] == "fast"


def test_flagship_shaped_backbone_under_safe_softmax_matches_jax(tuning):
    """THWTHWTHW at C = 128 (a multiple of 128: the T blocks would take the
    canonical kernel under "fast"), 4 heads; under "safe" both packages send
    the T blocks through the rearranged block."""
    shape = (4, 4, 8, 128)
    jb = JaxBackbone(tensor_shape=shape, attn_axes="THWTHWTHW", n_head=4, mlp_ratio=1.0)
    x = np.random.default_rng(8).normal(size=(B, *shape)).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(6), jnp.asarray(x))
    tb = AttnBackbone(shape, "THWTHWTHW", 4, 1.0)
    load_jax_params(tb, flatten(params))
    jblock.set_block_tuning(softmax="safe")
    tblock.set_block_tuning(softmax="safe")
    assert not tblock.canon_t_supported(4, 4, 8, 128, 4)
    want = jb.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
