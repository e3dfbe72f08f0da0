"""The benchmark's operation and byte counts against counts by hand."""

from __future__ import annotations

import pytest

from models import tante_count as count

TINY = {"in_T": 4, "taylor_order": 1, "attn_axes": "THWTHWTHW", "n_head": 4, "mlp_ratio": 1.0,
        "embed_dim": 32, "patch_scale": 8, "deg": True}


@pytest.mark.parametrize("args, ops, nbytes", [
    # 2 sequences of 3 tokens, C 4, MLP 8, full attention: 6 rows x (4 x 16 + 2 x 32)
    # multiply-adds of the projections and the MLP, 18 pairs x 2 x 4 of scores and
    # the weighted sum; x in, y out (24 floats each) and 172 weight floats.
    ((2, 3, 4, 8, False), 2 * (6 * (4 * 16 + 2 * 32) + 18 * 2 * 4), 4 * (24 + 24 + 172)),
    # 5 causal sequences of 4, C 8, MLP 8: 20 rows, 5 x (1 + 2 + 3 + 4) = 50 admitted
    # pairs; 2 x 160 activation floats and 464 weight floats.
    ((5, 4, 8, 8, True), 2 * (20 * (4 * 64 + 2 * 64) + 50 * 2 * 8), 4 * (320 + 464)),
])
def test_block_work(args, ops, nbytes):
    assert count.block_work(*args) == (ops, nbytes)


def test_blocks_of_a_call():
    # latent grid 4 x 8, T 4, batch 2: T blocks over 2 x 32 pixels, H over 2 x 4 x 8
    # columns of 4, W over 2 x 4 x 4 rows of 8.
    assert count.blocks_of_call(TINY, (32, 64), 2)[:3] == [(64, 4, True), (64, 4, False),
                                                           (32, 8, False)]


def test_encode_and_call_ops():
    # Each stage maps 512 / 128 / 32 output pixels from 16 / 32 / 64 inputs to
    # 8 / 16 / 32 outputs: 65,536 multiply-adds a stage.
    assert count.encode_ops(TINY, (32, 64), 4) == 2 * 3 * 65536
    # Mixers: 1024 H vectors of 4, 512 W vectors of 8 and 1024 T vectors of 4,
    # two square products each; blocks: 3 x (3 x 128 rows x 6 x 1024 + pairs
    # 320 (T, causal), 512 (H), 1024 (W) x 2 x 32).
    mixers = 2 * (1024 * 2 * 16 + 512 * 2 * 64 + 1024 * 2 * 16)
    blocks = 3 * (3 * 2 * 128 * 6 * 1024 + 2 * 2 * 32 * (320 + 512 + 1024))
    assert count.head_ops(TINY, (32, 64)) == mixers + blocks
    adaptive = dict(TINY, deg=False)
    interp = 2 * 32 * (32 * 16 + 16 * 8 + 8)
    assert count.head_ops(adaptive, (32, 64)) == mixers + blocks + interp
    assert count.call_ops(TINY, (32, 64), 4) == mixers + blocks + 2 * 3 * 65536


def test_rollout_ops():
    call, enc = count.call_ops(TINY, (32, 64), 4), count.encode_ops(TINY, (32, 64), 4)
    # 5 one-frame calls: the 4 history frames and 4 fed-back frames are encoded.
    assert count.rollout_ops(TINY, (32, 64), 4, 3, [1] * 5) == 3 * (5 * call + 8 * enc)
    # Calls that emit 3, 2 and 3 frames: 4 + 3 + 2 frames encoded.
    assert count.rollout_ops(TINY, (32, 64), 4, 1, [3, 2, 3]) == 3 * call + 9 * enc


def test_block_bound():
    ops, nbytes = count.block_work(64, 4, 32, 32, True)
    t, what = count.block_bound_s(dict(TINY, attn_axes="T"), (32, 64), 2, 1e12, 1e15)
    assert t == pytest.approx(ops / 1e12) and what == "operations"
    t, what = count.block_bound_s(dict(TINY, attn_axes="T"), (32, 64), 2, 1e18, 1e9)
    assert t == pytest.approx(nbytes / 1e9) and what == "bytes"
