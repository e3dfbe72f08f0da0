"""Where the time goes inside the fused-block kernels, on the card.

    python3 -m tante_tpu_torch.tools.kernel_phases [--halves]
    python3 -m tante_tpu_torch.tools.kernel_phases --packed [--baseline DIR]
    python3 -m tante_tpu_torch.tools.kernel_phases --f32 [--baseline DIR]
    python3 -m tante_tpu_torch.tools.kernel_phases --long [--baseline DIR]
    python3 -m tante_tpu_torch.tools.kernel_phases --long-half [--baseline DIR]
    python3 -m tante_tpu_torch.tools.kernel_phases --long-qkv [--baseline DIR]

(``--halves``: the tensor-parallel halves' sections alone.  ``--packed``: the
attention kernel's section alone, described last but one.  ``--f32``: the f32
block kernels' section alone, described before it.  ``--long``: the long
block's attention entry alone, described last but two; ``--long-half``: the
long attention half's attention kernel, described last but one;
``--long-qkv``: the long pairs' qkv kernels, described last.)

First the Hopper single-block kernels (``ops/csrc/fused_block_sm90.cu`` on
the tile body of ``block_sm90.cuh``): a measurement copy built with
``-DTANTE_PHASE_TIMING`` stamps the global timer after the consumer
warpgroups' barrier at each phase (LN1, each head group's q|k|v projection
and attention, out-projection, LN2, fc1, fc2) and counts, per matmul, the
SM cycles consumer thread 0 spends waiting for weight slabs, in wgmma and in
the epilogue; one JSON line per block (H, W, the rearranged causal T block
through ``fused_block_fwd``, and the canonical T block through
``fused_block_canon_t_fwd``) with the mean microseconds per tile of each
phase, summed over the head groups.

Then the Hopper chain kernel (``ops/csrc/fused_chain_sm90.cu``) on the runs
``THW`` and ``THWTHWTHW`` at the flagship: one JSON line per run and, per
block of the run, the phases of each CTA's first tile of that block, the
matmul cycles per tile, the tiles per CTA (the tiles of all blocks are one
schedule dealt round-robin to the grid), the consumers' wait for the
previous block's tiles of their batch elements (summed over a CTA's tiles
of the block; mean and most over CTAs), the block's span from its first
tile's start to its last tile's end, and how long before a CTA's first tile
of the block its producer issued that block's first slab (positive: the
weights were in flight before the tile began).

Then the Hopper tensor-parallel halves (``ops/csrc/fused_half_sm90.cu``)
at tp = 2 (shard 0 of the flagship's H, W and rearranged causal T blocks):
one JSON line per half and block with the mean microseconds per tile of
each phase (the attention half: LN1, q|k|v projections and attention
summed over the head groups, out-projection; the MLP half: LN2, fc1, fc2)
and the matmul cycles per tile.

Last the first design's tile body (``block_tile`` in ``ops/csrc/fused_block.cu``,
whose canonical T, chain and half entries are the measurement baseline): a measurement copy with
``-DTANTE_PHASE_TIMING`` (a CTA barrier and a global-timer stamp at each
phase boundary: start, row gather, LN1, q, k, v, attention, out-projection,
LN2, fc1, fc2), launches the flagship H and W blocks (each a one-block chain
run) and the canonical T block with seeded bf16 inputs, and prints one JSON
line per block: the mean microseconds per CTA of each phase, the CTA count,
and the measurement build's launch time (the stamps' barriers make it a
little slower than the production kernel).  A last line does the same for
its chain kernel on the run ``THW``: tiles stamp by tile number and each
block of a run overwrites the one before, so what is read back are the
tiles of the run's LAST block (W); ``block_span_us`` is the time from the
first tile's start to the last tile's end of that block across the grid.

``--f32``: the f32 single-block kernels (``tante_fused_block_sm90_f32_fwd`` and
the canonical T entry, on ``block_tile_f32``) at the flagship's H, W, rearranged
causal T and canonical T blocks in f32: a measurement copy of
``fused_block_sm90.cu`` with ``-DTANTE_PHASE_TIMING`` stamps the global timer
after the consumers' barrier at each phase (the bf16 body's stamps), one JSON
line per block with the mean microseconds per tile of LN1, the q|k|v
projections and attention (summed over the head groups), out-projection,
LN2, fc1 and fc2, each phase's share of the tile, the valid rows per tile,
and per matmul the SM cycles consumer thread 0 spends waiting for weight
slabs, in the slabs' products and in the epilogue.  With ``--baseline DIR``
the production kernels of DIR's ``fused_block_sm90.cu`` (weights re-laid by
DIR's own ``ops/fused_block.py``) and of this tree are timed in turns
(baseline, this tree, this tree, baseline) by CUDA events on the same
inputs, and their outputs compared.

``--packed``: the head-packed attention kernel (``ops/csrc/packed_attention.cu``)
at the AViT shape in f32 (row and column views of one (16, 16, 16, 6, 192)
projection, as AViT launches it, and the packed (256, 96, 64) form) and a
TransformerBlock's (1536, 128, 32) in bf16.  A measurement copy built with
``-DTANTE_PHASE_TIMING`` stamps every (sequence, head) unit: lane 0's SM
cycles waiting for the unit's staged rows, in the scores, the softmax, the AV
product, the stores and issuing the copies of a later unit, its start and end
on the global timer, and the warp that took it.  One JSON line per shape: the
plan, the mean cycles and microseconds per unit of each phase (all units, and
each warp's first unit apart: it waits for its rows with nothing to overlap),
units per warp, the launch's span.  With ``--baseline DIR`` (a checkout of
another tree, e.g. the parent commit from ``git archive`` under ``build/``),
its ``packed_attention.cu`` is built too and the two production kernels are
timed in turns (baseline, this tree, this tree, baseline) at the same shapes,
L2-warm (back to back) and L2-cold (a 128 MB write before each launch; and a
128 MB read, which leaves no dirty lines to write back), by CUDA events over
100 launches queued behind a spin of the card.

``--long``: the long block's attention entry (``tante_block_long_attn_sm90_fwd``
and its f32 twin in ``ops/csrc/fused_block_long_sm90.cu``) at the flagship's
L, X, A and C blocks in both dtypes ("fast", seeded weights with wq and wk
2.75x wider, as ``chip_smoke.py``'s ``kernel_long``), the workspace made by
this tree's qkv entry.  A measurement copy built with ``-DTANTE_PHASE_TIMING``
counts, per CTA of the persistent grid, the SM cycles consumer thread 0
spends waiting for k|v blocks, in the scores, the softmax (bf16: with the
AV product), the AV product (f32), waiting for q tiles, in the tail
(out-projection, LN2, fc1, fc2; LN2 with its barriers also alone, and per
matmul its slab waits, products and epilogue) and at the barrier between an
item's attention and its tail;
one JSON line per block and dtype with the mean cycles per work item of each
phase and its share, the items per CTA, the plan and the workspace bytes
read.  With
``--baseline DIR`` the attention entry of DIR's ``fused_block_long_sm90.cu``
(its plan and re-laid weights from DIR's own ``ops/fused_block.py``; where
those hold this tree's values, this tree's tensors) and this tree's are
timed in turns (baseline, this tree, this tree, baseline) by CUDA events on
the same workspace and one output buffer, and their outputs compared.

``--long-half``: the long attention half's attention kernel
(``tante_attn_half_long_attn_sm90_fwd`` and its f32 twin in
``ops/csrc/fused_half_long_sm90.cu``) on shard 0 at tp 2 of the flagship's
L, X, A and C blocks in both dtypes ("fast", wq and wk 2.75x wider), the
workspace made by this tree's qkv kernel.  From a ``-DTANTE_PHASE_TIMING``
build, per work item: the SM cycles consumer thread 0 spends waiting for
k|v blocks, in the scores, the softmax (bf16: with the AV product), the AV
product (f32), waiting for q tiles, at the barrier before the tail, and in
the tail (the out-projection partial, with its slab waits, products and
epilogue); one JSON line per block and dtype with the plan, the launch's
work (items, pair items, grid) and the workspace bytes read.  With
``--baseline DIR`` first the attention kernel of DIR's
``fused_half_long_sm90.cu`` (its plan and re-laid weights from DIR's own
``ops/fused_block.py``, shared as in ``--long``) and this tree's in turns
(baseline, this tree, this tree, baseline) by CUDA events on one workspace
and one output buffer, their outputs compared;
then the long block's attention entry against DIR's in the same way (the
``--long`` turns).

``--long-qkv``: the four qkv kernels of the long pairs (the long block's
``tante_block_long_qkv_sm90[_f32]_fwd`` and shard 0 at tp 2 of the long
half's ``tante_attn_half_long_qkv_sm90[_f32]_fwd``) at the flagship's L, X,
A and C blocks in both dtypes (seeded weights, wq and wk 2.75x wider).  With
``--baseline DIR`` first DIR's kernels (its plans and re-laid weights from
its own ``ops/fused_block.py``; this tree's tensors where those hold the
same values) and this tree's in turns (baseline, this tree, this tree,
baseline) by CUDA events, with one x, one weight copy and one workspace
buffer; each workspace compared bit for bit with the baseline's (a separate
buffer), the achieved GB/s against the bytes bound (``chip_smoke.py:
long_bounds`` / ``half_long_bounds``).  Then, from a
``-DTANTE_PHASE_TIMING`` build, per tile the SM cycles consumer thread 0
spends waiting for the tile's x, in LN1 (with its barrier), in the
products (summed over the head groups), waiting for staging buffers and in
the epilogue (and, of the products, waiting for weight slabs), and the
store thread's cycles issuing the workspace stores,
waiting for written buffers and for the stores' reads; one JSON line per
kernel, block and dtype.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import numpy as np
import torch

from pathlib import Path

from tante_tpu_torch.ops import _build
from tante_tpu_torch.ops import fused_attention as fa
from tante_tpu_torch.ops import fused_block as fb
from tante_tpu_torch.parallel.sharding import shard_block

PHASES = ("gather", "ln1", "q", "k", "v", "attention", "o_proj", "ln2", "fc1", "fc2")
C, HIDDEN, HEADS = 256, 256, 8
# label -> (shape, causal): the serving path's blocks at the flagship.
CASES = {"H": ((1536, 16, C), False), "W": ((512, 48, C), False),
         "T": ((8, 4, 16, 48, C), True)}
DIMS = (4, 16, 48)  # (T, H, W) of the flagship latent, B = 8


def _params(seed: int, dev) -> fb.BlockParams:
    rng = np.random.default_rng(seed)

    def u(*shape, scale=1.0, offset=0.0):
        a = offset + scale * rng.uniform(-1.0, 1.0, size=shape) / np.sqrt(shape[0])
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    return fb.BlockParams(
        u(C, scale=0.1, offset=1.0), u(C, scale=0.1), u(C, C), u(C), u(C, C), u(C),
        u(C, C), u(C), u(C, C), u(C), u(C, scale=0.1, offset=1.0), u(C, scale=0.1),
        u(C, HIDDEN), u(HIDDEN), u(HIDDEN, C), u(C),
    )


SM90_CASES = {"H": ((1536, 16, C), False), "W": ((512, 48, C), False),
              "T rearranged": ((8 * 16 * 48, 4, C), True),
              "T canonical": ((8, 4, 16, 48, C), True)}
MATMULS = ("qkv", "o_proj", "fc1", "fc2")


TIMING_FLAGS = ("-DTANTE_PHASE_TIMING",)


def _timing_library(kernel: str) -> ctypes.CDLL:
    """A measurement copy of ``csrc/<kernel>.cu`` with its phase readers."""
    info = _build.compile_library(kernel, f"{kernel}_phases", TIMING_FLAGS)
    lib = _build.bind(ctypes.CDLL(info["library"]), kernel)
    for fn in ("tante_sm90_phase_read", "tante_sm90_gemm_cycles", "tante_sm90_chain_read",
               "tante_packed_phase_read"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _timed(launch, iters: int = 20) -> float:
    """ms per launch over ``iters`` launches after three warm-up launches."""
    for _ in range(3):
        if launch() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _read(lib, fn: str, shape: tuple) -> np.ndarray:
    out = np.zeros(shape, dtype=np.uint64)
    if getattr(lib, fn)(out.ctypes.data, shape[0]) != 0:
        raise RuntimeError(f"{fn} failed")
    return out


def _phase_summary(stamps: np.ndarray, groups: int) -> tuple[dict, np.ndarray]:
    """Mean us per tile of each phase (q|k|v and attention summed over the
    head groups) from rows of phase stamps; also the stamps used."""
    n_stamps = stamps.shape[1]
    names = ["ln1"] + [f"{k}_{g}" for g in range(groups) for k in ("qkv", "attention")]
    names += ["o_proj", "ln2", "fc1", "fc2"]
    used = [0, 1, *range(2, 2 + 2 * groups), *range(n_stamps - 4, n_stamps)]
    ns = stamps[:, used].astype(np.float64)
    per = dict(zip(names, np.diff(ns, axis=1).mean(axis=0) / 1e3))
    return {"ln1": float(per["ln1"]), "qkv": float(sum(per[f"qkv_{g}"] for g in range(groups))),
            "attention": float(sum(per[f"attention_{g}"] for g in range(groups))),
            **{k: float(per[k]) for k in ("o_proj", "ln2", "fc1", "fc2")}}, ns


def _cycles(per_mm: np.ndarray, parts=("slab_wait", "wgmma", "epilogue")) -> dict:
    return {mm: {part: float(per_mm[i][k]) for k, part in enumerate(parts)}
            for i, mm in enumerate(MATMULS)}


def sm90_phases(dev, stream, card: str) -> None:
    lib = _timing_library("fused_block_sm90")
    n_stamps = lib.tante_sm90_phase_stamps()
    for i, (label, (shape, causal)) in enumerate(SM90_CASES.items()):
        p = _params(20 + i, dev)
        x = torch.from_numpy(np.random.default_rng(i).normal(size=shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        y = torch.empty_like(x)
        if label == "T canonical":
            b, l, h, w, _ = shape
            n_seqs = b * h * w
            plan = fb.sm90_plan(l, C, HIDDEN)
            row_map = (ctypes.c_int * 6)(*fb.canon_t_map((l, h, w), b))
        else:
            n_seqs, l, _ = shape
            plan = fb.sm90_plan(l, C, HIDDEN)
        ptrs = fb._ptr_array([fb.sm90_weights(p, HEADS, plan)])
        plan_arr = (ctypes.c_int * 7)(*plan.ints())
        if label == "T canonical":
            launch = lambda: lib.tante_fused_block_canon_t_sm90_fwd(  # noqa: E731
                x.data_ptr(), y.data_ptr(), ptrs, plan_arr, row_map, n_seqs, l, C, HIDDEN, HEADS,
                0, stream)
        else:
            launch = lambda: lib.tante_fused_block_sm90_fwd(  # noqa: E731
                x.data_ptr(), y.data_ptr(), ptrs, plan_arr, n_seqs, l, C, HIDDEN, HEADS,
                int(causal), 0, 0, stream)
        tiles = -(-n_seqs // plan.seqs)
        for _ in range(3):
            if launch() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        _read(lib, "tante_sm90_gemm_cycles", (tiles, 4, 3))  # zeroes the counters
        ms = _timed(launch, 20)
        per_mm = _read(lib, "tante_sm90_gemm_cycles", (tiles, 4, 3)).astype(np.float64)
        per_mm = per_mm.mean(axis=0) / (20 + 3)
        summary, ns = _phase_summary(_read(lib, "tante_sm90_phase_read", (tiles, n_stamps)),
                                     C // 64)
        print(json.dumps({
            "kernel": ("fused_block_canon_t_fwd" if label == "T canonical" else "fused_block_fwd")
            + " (fused_block_sm90.cu)", "block": label, "shape": list(shape), "causal": causal,
            "tiles": tiles, "plan": plan._asdict(), "timing_build_ms": ms,
            "per_tile_us": summary, "tile_us": float(sum(summary.values())),
            "matmul_cycles_per_tile": _cycles(per_mm),
            "span_us": float((ns[:, -1].max() - ns[:, 0].min()) / 1e3), "card": card,
        }), flush=True)


def schedule(tiles: list, grid: int) -> np.ndarray:
    """Tiles of each block per CTA under the chain's schedule: the tiles of
    all blocks in one sequence, tile g to CTA g % grid."""
    out = np.zeros((len(tiles), grid), dtype=np.int64)
    g = 0
    for i, n in enumerate(tiles):
        for _ in range(n):
            out[i, g % grid] += 1
            g += 1
    return out


def chain_phases(dev, stream, card: str) -> None:
    """The Hopper chain kernel, per block of a run (see the module text)."""
    lib = _timing_library("fused_chain_sm90")
    n_stamps, n_slots = lib.tante_sm90_phase_stamps(), lib.tante_sm90_phase_slots()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = CASES["T"][0]
    b, dims = shape[0], shape[1:4]
    sizes = dict(zip("THW", dims))
    for axes in ("THW", "THWTHWTHW"):
        ps = [_params(30 + i, dev) for i in range(len(axes))]
        plans = fb.chain_plans(axes, dims, C, HIDDEN)
        weights = fb.chain_weights(ps, HEADS, plans)
        rows = fb.chain_plan(axes, dims, b)
        plan_ints = [v for plan in plans for v in plan.ints()]
        maps = [v for row in rows for v in row]
        x = torch.from_numpy(np.random.default_rng(9).normal(size=shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        y, bufs = torch.empty_like(x), [torch.empty_like(x) for _ in range(2)]
        done = torch.empty(len(axes) * b, dtype=torch.int32, device=dev)
        ptrs = fb._ptr_array(weights)
        plan_arr = (ctypes.c_int * len(plan_ints))(*plan_ints)
        map_arr = (ctypes.c_int * len(maps))(*maps)
        launch = lambda: lib.tante_fused_chain_sm90_fwd(  # noqa: E731
            x.data_ptr(), y.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), ptrs, plan_arr,
            map_arr, len(axes), C, HIDDEN, HEADS, 0, done.data_ptr(), b, 0, stream)
        tiles = [-(-row[2] // plan.seqs) for row, plan in zip(rows, plans)]
        grid = min(sms, sum(tiles))  # one CTA per SM at this shared memory
        per_cta = schedule(tiles, grid)
        slots = len(axes) * grid
        if slots > n_slots:
            raise RuntimeError(f"{slots} timing slots needed, {n_slots} built")
        for _ in range(3):
            if launch() != 0:
                raise RuntimeError(f"chain {axes}: launch failed")
        torch.cuda.synchronize()
        _read(lib, "tante_sm90_gemm_cycles", (slots, 4, 3))
        ms = _timed(launch, 20)
        cycles = _read(lib, "tante_sm90_gemm_cycles", (slots, 4, 3)).astype(np.float64)
        stamps = _read(lib, "tante_sm90_phase_read", (slots, n_stamps))
        chain = _read(lib, "tante_sm90_chain_read", (slots, 4)).astype(np.float64)
        steps = []
        for i, (axis, n_tiles) in enumerate(zip(axes, tiles)):
            ran = np.nonzero(per_cta[i])[0]  # CTAs that ran a tile of this block
            sl = i * grid + ran
            n = per_cta[i, ran].astype(np.float64)
            per_mm = (cycles[sl] / n[:, None, None]).mean(axis=0) / (20 + 3)
            summary, _ = _phase_summary(stamps[sl], C // 64)
            start, wait, end, issue = (chain[sl, k] for k in range(4))
            steps.append({
                "block": axis, "L": sizes[axis], "tiles": n_tiles, "grid": grid,
                "ctas": int(len(ran)), "tiles_per_cta": [int(n.min()), int(n.max())],
                "first_tile_us": summary, "first_tile_total_us": float(sum(summary.values())),
                "matmul_cycles_per_tile": _cycles(per_mm),
                "block_span_us": float((end.max() - start.min()) / 1e3),
                "wait_us": {"mean": float(wait.mean() / 1e3), "max": float(wait.max() / 1e3)},
                "producer_lead_us": {"mean": float(((start - issue) / 1e3).mean()),
                                     "min": float(((start - issue) / 1e3).min())}})
        print(json.dumps({"kernel": "fused_chain_fwd (fused_chain_sm90.cu)", "run": axes,
                          "shape": list(shape), "timing_build_ms": ms, "total_tiles": sum(tiles),
                          "tiles_per_cta": [int(per_cta.sum(0).min()), int(per_cta.sum(0).max())],
                          "blocks": steps, "card": card}), flush=True)


HALF_TP = 2
HALF_CASES = {"H": ((1536, 16, C), False), "W": ((512, 48, C), False),
              "T rearranged": ((8 * 16 * 48, 4, C), True)}


def _half_setup(kind: str, label: str, dev):
    """Shard 0 of a flagship block at tp = 2, its input and output, its
    production plan and re-laid weights."""
    from tante_tpu_torch.parallel.sharding import shard_block

    (shape, causal) = HALF_CASES[label]
    p = shard_block(_params(40 + list(HALF_CASES).index(label), dev), HALF_TP, 0)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=shape).astype(np.float32))
    x = x.to(dev, torch.bfloat16)
    n_seqs, l, _ = shape
    heads = HEADS // HALF_TP
    if kind == "attn":
        half = fb.AttnHalfParams(*(getattr(p, f) for f in fb.AttnHalfParams._fields))
        plan = fb.half_plan("attn", l, C, half.wq.shape[-1])
    else:
        half = fb.MlpHalfParams(*(getattr(p, f) for f in fb.MlpHalfParams._fields))
        plan = fb.half_plan("mlp", 1, C, half.w1.shape[-1])
    return half, x, torch.empty_like(x), plan, n_seqs, l, heads, causal


def _half_launch(lib, kind, half, x, y, plan, n_seqs, l, heads, causal, stream):
    """A launch of one half under ``plan`` through ``lib``: a callable
    returning the cudaError_t, and the tile count."""
    w = fb.half_weights(half, plan, heads) if kind == "attn" else fb.half_weights(half, plan)
    ptrs, plan_arr = fb._ptr_array([w]), (ctypes.c_int * 6)(*plan.ints())
    if kind == "attn":
        ca = half.wq.shape[-1]
        return (lambda: lib.tante_attn_half_sm90_fwd(  # noqa: E731
            x.data_ptr(), y.data_ptr(), ptrs, plan_arr, n_seqs, l, C, ca, heads, int(causal), 0,
            0, stream)), -(-n_seqs // plan.seqs)
    m = n_seqs * l
    return (lambda: lib.tante_mlp_half_sm90_fwd(  # noqa: E731
        x.data_ptr(), y.data_ptr(), ptrs, plan_arr, m, C, half.w1.shape[-1], 0, stream)), \
        -(-m // plan.rows)


def half_phases(dev, stream, card: str) -> None:
    """Per-tile phases of the Hopper halves at tp = 2 (see the module text)."""
    lib = _timing_library("fused_half_sm90")
    n_stamps = lib.tante_sm90_phase_stamps()
    for label in HALF_CASES:
        for kind in ("attn", "mlp"):
            half, x, y, plan, n_seqs, l, heads, causal = _half_setup(kind, label, dev)
            launch, tiles = _half_launch(lib, kind, half, x, y, plan, n_seqs, l, heads, causal,
                                         stream)
            for _ in range(3):
                if launch() != 0:
                    raise RuntimeError(f"{kind} half {label}: launch failed")
            torch.cuda.synchronize()
            _read(lib, "tante_sm90_gemm_cycles", (tiles, 4, 3))  # zeroes the counters
            ms = _timed(launch, 20)
            per_mm = _read(lib, "tante_sm90_gemm_cycles", (tiles, 4, 3)).astype(np.float64)
            per_mm = per_mm.mean(axis=0) / (20 + 3)
            ns = _read(lib, "tante_sm90_phase_read", (tiles, n_stamps)).astype(np.float64)
            if kind == "attn":
                g = plan.width // 64
                d = lambda a, b: float((ns[:, a] - ns[:, b]).mean() / 1e3)  # noqa: E731
                phases = {"ln1": d(1, 0),
                          "qkv": sum(d(2 + 2 * i, 1 + 2 * i) for i in range(g)),
                          "attention": sum(d(3 + 2 * i, 2 + 2 * i) for i in range(g)),
                          "o_proj": d(n_stamps - 4, 1 + 2 * g)}
                last, cycles = n_stamps - 4, {k: v for k, v in _cycles(per_mm).items()
                                              if k in ("qkv", "o_proj")}
            else:
                phases = dict(zip(("ln2", "fc1", "fc2"),
                                  (np.diff(ns[:, :4], axis=1).mean(axis=0) / 1e3).tolist()))
                last, cycles = 3, {k: v for k, v in _cycles(per_mm).items() if k in ("fc1", "fc2")}
            print(json.dumps({
                "kernel": f"{kind}_half_fwd (fused_half_sm90.cu)", "block": label, "tp": HALF_TP,
                "shape": list(x.shape), "causal": causal, "tiles": tiles, "plan": plan._asdict(),
                "timing_build_ms": ms, "per_tile_us": phases,
                "tile_us": float(sum(phases.values())), "matmul_cycles_per_tile": cycles,
                "span_us": float((ns[:, last].max() - ns[:, 0].min()) / 1e3), "card": card,
            }), flush=True)


# ---- the f32 block kernels (--f32) ----------------------------------------------

F32_CASES = {"H": ((1536, 16, C), False), "W": ((512, 48, C), False),
             "T rearranged": ((8 * 16 * 48, 4, C), True),
             "T canonical": ((8, 4, 16, 48, C), True)}


def _f32_setup(label: str, dev):
    """A flagship f32 block: its parameters, input, output, plan and, for
    the canonical T block, the T axis's row map."""
    (shape, causal), i = F32_CASES[label], list(F32_CASES).index(label)
    p = fb.BlockParams(*(t.float() for t in _params(50 + i, dev)))
    x = torch.from_numpy(np.random.default_rng(50 + i).normal(size=shape).astype(np.float32))
    x = x.to(dev)
    if label == "T canonical":
        b, l, h, w, _ = shape
        n_seqs, row_map = b * h * w, (ctypes.c_int * 6)(*fb.canon_t_map((l, h, w), b))
    else:
        (n_seqs, l, _), row_map = shape, None
    return p, x, torch.empty_like(x), fb.sm90_plan(l, C, HIDDEN, torch.float32), n_seqs, l, \
        causal, row_map


def _f32_launch(lib, module, label: str, p, x, y, plan, n_seqs, l, causal, row_map, stream):
    """A launch of ``lib``'s f32 entry on the block, its weights re-laid by
    ``module`` (this tree's ``fused_block`` or a baseline's)."""
    w = module.sm90_weights(p, HEADS, plan)
    ptrs, plan_arr = fb._ptr_array([w]), (ctypes.c_int * 7)(*plan.ints())
    if label == "T canonical":
        return lambda: lib.tante_fused_block_canon_t_sm90_f32_fwd(  # noqa: E731
            x.data_ptr(), y.data_ptr(), ptrs, plan_arr, row_map, n_seqs, l, C, HIDDEN, HEADS, 0,
            stream)
    return lambda: lib.tante_fused_block_sm90_f32_fwd(  # noqa: E731
        x.data_ptr(), y.data_ptr(), ptrs, plan_arr, n_seqs, l, C, HIDDEN, HEADS, int(causal), 0,
        0, stream)


def f32_phases(dev, stream, card: str) -> None:
    """Per-tile phases of the f32 single-block kernels (see the module text)."""
    lib = _timing_library("fused_block_sm90")
    n_stamps = lib.tante_sm90_phase_stamps()
    for label in F32_CASES:
        p, x, y, plan, n_seqs, l, causal, row_map = _f32_setup(label, dev)
        launch = _f32_launch(lib, fb, label, p, x, y, plan, n_seqs, l, causal, row_map, stream)
        tiles = -(-n_seqs // plan.seqs)
        for _ in range(3):
            if launch() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        _read(lib, "tante_sm90_gemm_cycles", (tiles, 4, 3))  # zeroes the counters
        ms = _timed(launch, 20)
        per_mm = _read(lib, "tante_sm90_gemm_cycles", (tiles, 4, 3)).astype(np.float64)
        per_mm = per_mm.mean(axis=0) / (20 + 3)
        summary, ns = _phase_summary(_read(lib, "tante_sm90_phase_read", (tiles, n_stamps)),
                                     C // 64)
        tile_us = float(sum(summary.values()))
        print(json.dumps({
            "kernel": ("fused_block_canon_t_sm90_f32_fwd" if label == "T canonical"
                       else "fused_block_sm90_f32_fwd") + " (fused_block_sm90.cu)",
            "block": label, "shape": list(x.shape), "causal": causal, "tiles": tiles,
            "valid_rows_per_tile": plan.seqs * l, "plan": plan._asdict(),
            "timing_build_ms": ms, "per_tile_us": summary, "tile_us": tile_us,
            "share_of_tile": {k: v / tile_us for k, v in summary.items()},
            "matmul_cycles_per_tile": _cycles(per_mm, ("slab_wait", "mma", "epilogue")),
            "span_us": float((ns[:, -1].max() - ns[:, 0].min()) / 1e3), "card": card,
        }), flush=True)


def _baseline_fused_block(baseline: str):
    """DIR's ``ops/fused_block.py`` as a module of its own (its weight
    layouts; its imports resolve to this tree's package)."""
    import importlib.util

    path = Path(baseline) / "tante_tpu_torch" / "ops" / "fused_block.py"
    spec = importlib.util.spec_from_file_location("baseline_fused_block", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def f32_in_turns(dev, stream, card: str, baseline: str) -> None:
    """The baseline tree's f32 kernels and this tree's in turns (module text)."""
    source = Path(baseline) / "tante_tpu_torch" / "ops" / "csrc" / "fused_block_sm90.cu"
    info = _build.compile_library("fused_block_sm90", "fused_block_sm90_baseline", (),
                                  source=source)
    other = _build.bind(ctypes.CDLL(info["library"]), "fused_block_sm90")
    this = _build.load("fused_block_sm90")
    base_fb = _baseline_fused_block(baseline)
    for label in F32_CASES:
        p, x, y, plan, n_seqs, l, causal, row_map = _f32_setup(label, dev)
        y_base = torch.empty_like(y)
        runs = {"baseline": _f32_launch(other, base_fb, label, p, x, y_base, plan, n_seqs, l,
                                        causal, row_map, stream),
                "this_tree": _f32_launch(this, fb, label, p, x, y, plan, n_seqs, l, causal,
                                         row_map, stream)}
        for launch in runs.values():
            if launch() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        diff = float((y_base - y).abs().max())
        b1 = event_ms(runs["baseline"], iters=50)
        t1 = event_ms(runs["this_tree"], iters=50)
        t2 = event_ms(runs["this_tree"], iters=50)
        b2 = event_ms(runs["baseline"], iters=50)
        print(json.dumps({
            "kernel": "f32 block kernel in turns", "block": label, "baseline": str(source),
            "shape": list(x.shape), "baseline_ms": (b1 + b2) / 2, "this_tree_ms": (t1 + t2) / 2,
            "baseline_ms_turns": [b1, b2], "this_tree_ms_turns": [t1, t2],
            "max_abs_diff_baseline_vs_this_tree": diff,
            "max_abs_output": float(y_base.abs().max()), "card": card,
        }), flush=True)


# ---- the head-packed attention kernel (--packed) ------------------------------

SLEEP_CYCLES = 50_000_000  # ~27 ms of the card's spin: the host queues a window behind it
SCRUB_BYTES = 128 << 20    # written before each L2-cold launch (the L2 holds 50 MB)
PACKED_PHASES = ("wait", "scores", "softmax", "av", "store", "stage")


def event_ms(fn, iters: int = 100, flush=None) -> float:
    """Mean ms per call of ``fn`` by CUDA events over ``iters`` calls queued
    behind a spin of the card, so that the host's pace does not enter.  Warm:
    one event pair around back-to-back calls.  Cold: ``flush`` (a pass over
    more than the L2's 50 MB) before each call and an event pair around each
    call alone."""
    fn()
    if flush is not None:
        flush()
    torch.cuda.synchronize()
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    if flush is None:
        start, stop = ev(), ev()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters
    pairs = [(ev(), ev()) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in pairs:
        flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def packed_shapes(dev) -> list[tuple]:
    """(label, (q, k, v), L, causal, heads_last) at the main path's shapes."""
    rng = np.random.default_rng(3)

    def normal(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)

    q, k, v = normal(16, 16, 16, 6, 3 * 64).chunk(3, dim=-1)  # (B', H, W, heads, D) slices
    packed = [normal(256, 96, 64) for _ in range(3)]
    packed[0] *= 64**-0.5
    tb = [normal(1536, 128, 32, dtype=torch.bfloat16) for _ in range(3)]
    return [("AViT row views", (q, k, v), 16, False, True),
            ("AViT column views", tuple(t.transpose(1, 2) for t in (q, k, v)), 16, False, True),
            ("AViT (256, 96, 64)", tuple(packed), 16, False, False),
            ("TransformerBlock (1536, 128, 32) bf16", tuple(tb), 16, False, False)]


def packed_launch(lib, ts, l: int, causal: bool, heads_last: bool, stream):
    """A launch of ``lib``'s ``tante_packed_attention`` on ``ts`` as the
    wrapper hands them over (a callable returning the cudaError_t), its
    output and its (S0, S1, H, L, D)."""
    out = torch.empty(ts[0].shape, dtype=ts[0].dtype, device=ts[0].device)
    (q5, k5, v5, o5), scale = fa.kernel_views((*ts, out), l, heads_last)
    if not all(fa.rows_aligned(t) for t in (q5, k5, v5)):
        raise RuntimeError("the main path's operands should need no copy")
    geom = fa.geometry(q5, k5, v5, o5)
    bf16, index = int(ts[0].dtype == torch.bfloat16), ts[0].device.index
    return (lambda: lib.tante_packed_attention(  # noqa: E731
        q5.data_ptr(), k5.data_ptr(), v5.data_ptr(), o5.data_ptr(), geom, int(causal),
        float(scale), bf16, index, stream)), out, tuple(q5.shape)


def packed_bound_ms(shape, dtype) -> float:
    """q, k, v read and the output written once over 3.35 TB/s (the bytes
    bound them: 4 * L flops a byte in f32 is below the f32 rate)."""
    return 4.0 * math.prod(shape) * torch.finfo(dtype).bits / 8 / 3.35e12 * 1e3


def packed_phases(dev, stream, card: str) -> None:
    """Per-unit phases of the attention kernel (see the module text)."""
    lib = _timing_library("packed_attention")
    fields, capacity = lib.tante_packed_stamp_fields(), lib.tante_packed_stamp_units()
    scrub = torch.empty(SCRUB_BYTES // 4, device=dev)
    for label, ts, l, causal, heads_last in packed_shapes(dev):
        launch, out, shape = packed_launch(lib, ts, l, causal, heads_last, stream)
        units = shape[0] * shape[1] * shape[2]
        if units > capacity:
            raise RuntimeError(f"{units} units, {capacity} stamp slots built")
        ms = _timed(launch, 20)
        res = {"kernel": "packed_attention_kernel (packed_attention.cu)", "case": label,
               "shape_s0_s1_heads_l_d": list(shape),
               "dtype": str(out.dtype).replace("torch.", ""),
               "plan": fa.launch_plan(*shape, out.dtype), "units": units,
               "timing_build_ms": ms, "bound_ms": packed_bound_ms(shape, out.dtype)}
        # The stamps of the last of those (L2-warm) launches, then of one
        # launch after a 128 MB write (L2-cold).
        res["warm"] = _unit_summary(_read(lib, "tante_packed_phase_read", (units, fields)))
        scrub.zero_()
        if launch() != 0:
            raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        res["cold"] = _unit_summary(_read(lib, "tante_packed_phase_read", (units, fields)))
        print(json.dumps({**res, "card": card}), flush=True)


def _unit_summary(stamps: np.ndarray) -> dict:
    """Per-unit phase means (all units; each warp's first unit, which waits
    for its rows with nothing to overlap; the later ones), units per warp,
    the span and when the units' waits ended."""
    st = stamps.astype(np.float64)
    cycles, ns, warp = st[:, 2:2 + len(PACKED_PHASES)], st[:, 1] - st[:, 0], st[:, -1]
    ghz = float(cycles.sum() / ns.sum())  # SM cycles per ns over the units' own spans
    first = np.zeros(len(st), dtype=bool)  # each warp's first unit (the earliest start)
    order = np.lexsort((st[:, 0], warp))
    first[order[np.r_[True, np.diff(warp[order]) != 0]]] = True
    _, per_warp = np.unique(warp, return_counts=True)
    t0 = st[:, 0].min()
    wait_end_us = (st[:, 0] - t0) / 1e3 + cycles[:, 0] / ghz / 1e3

    def per_unit(rows):
        if not rows.any():
            return None
        return {p: {"cycles": float(c), "us": float(c / ghz / 1e3)}
                for p, c in zip(PACKED_PHASES, cycles[rows].mean(axis=0))}

    return {"warps_used": int(len(per_warp)),
            "units_per_warp": [int(per_warp.min()), int(per_warp.max())],
            "sm_ghz_from_stamps": ghz, "per_unit_all": per_unit(np.ones(len(st), dtype=bool)),
            "per_unit_first_of_warp": per_unit(first), "per_unit_later": per_unit(~first),
            "unit_us_mean": float(ns.mean() / 1e3),
            "rows_landed_us_quartiles": np.percentile(wait_end_us, [0, 25, 50, 75, 100]).tolist(),
            "span_us": float((st[:, 1].max() - t0) / 1e3)}


def packed_in_turns(dev, stream, card: str, baseline: str) -> None:
    """The baseline tree's kernel and this tree's in turns (module text)."""
    source = Path(baseline) / "tante_tpu_torch" / "ops" / "csrc" / "packed_attention.cu"
    info = _build.compile_library("packed_attention", "packed_attention_baseline", (),
                                  source=source)
    other = ctypes.CDLL(info["library"])
    p, i = ctypes.c_void_p, ctypes.c_int
    other.tante_packed_attention.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, ctypes.c_float, i, i, p]
    other.tante_packed_attention.restype = i
    this = _build.load("packed_attention")
    scrub = torch.empty(SCRUB_BYTES // 4, device=dev)
    for label, ts, l, causal, heads_last in packed_shapes(dev):
        runs = {name: packed_launch(lib, ts, l, causal, heads_last, stream)
                for name, lib in (("baseline", other), ("this_tree", this))}
        for launch, _, _ in runs.values():
            if launch() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        diff = float((runs["baseline"][1].float() - runs["this_tree"][1].float()).abs().max())
        times = {}
        # cold: after a 128 MB write (the L2 then holds 50 MB of dirty lines,
        # whose write-back the launch shares); cold_read: after a 128 MB read.
        for mode, flush in (("warm", None), ("cold", scrub.zero_),
                            ("cold_read", lambda: scrub.sum())):
            b1 = event_ms(runs["baseline"][0], flush=flush)
            t1 = event_ms(runs["this_tree"][0], flush=flush)
            t2 = event_ms(runs["this_tree"][0], flush=flush)
            b2 = event_ms(runs["baseline"][0], flush=flush)
            times[mode] = {"baseline_ms": (b1 + b2) / 2, "this_tree_ms": (t1 + t2) / 2,
                           "baseline_ms_turns": [b1, b2], "this_tree_ms_turns": [t1, t2]}
        shape, dtype = runs["this_tree"][2], ts[0].dtype
        print(json.dumps({
            "kernel": "packed_attention_kernel in turns", "case": label, "baseline": str(source),
            "shape_s0_s1_heads_l_d": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_diff_baseline_vs_this_tree": diff, **times,
            "bound_ms": packed_bound_ms(shape, dtype), "card": card,
        }), flush=True)


# ---- the long block's attention entry (--long) ----------------------------------

LONG_PHASES = ("kv_wait", "scores", "softmax", "av", "q_wait", "tail", "between", "ln2")
# axis -> (sequences, L, width): the flagship's long blocks (chip_smoke.py:LONG_CASES).
LONG_AXES = {"L": (32, 768, 256), "X": (128, 192, 256), "A": (8, 3072, 256),
             "C": (24576, 256, 128)}
LONG_QK_SCALE = 2.75


def _long_setup(axis: str, dtype, dev, qkv: bool = True):
    """A flagship long block in ``dtype``: parameters, input, output, this
    tree's plan, re-laid weights and workspace (none of the three without
    ``qkv``)."""
    s, l, c = LONG_AXES[axis]
    rng = np.random.default_rng(80 + list(LONG_AXES).index(axis))

    def u(*shape, scale=1.0, offset=0.0):
        a = offset + scale * rng.uniform(-1.0, 1.0, size=shape) / np.sqrt(shape[0])
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    p = fb.BlockParams(
        u(c, scale=0.1, offset=1.0), u(c, scale=0.1), u(c, c, scale=LONG_QK_SCALE), u(c),
        u(c, c, scale=LONG_QK_SCALE), u(c), u(c, c), u(c), u(c, c), u(c),
        u(c, scale=0.1, offset=1.0), u(c, scale=0.1), u(c, c), u(c), u(c, c), u(c))
    gen = torch.Generator(device=dev)
    gen.manual_seed(90 + list(LONG_AXES).index(axis))
    x = torch.randn((s, l, c), generator=gen, device=dev).to(dtype)
    if not qkv:
        return p, x, torch.empty_like(x), None, None, None
    plan = fb.long_plan(c, c, HEADS, dtype)
    w = fb.sm90_weights(p, HEADS, plan)
    return p, x, torch.empty_like(x), plan, w, fb.long_qkv_fwd(x, w, plan, l)


def _long_launch(lib, plan_ints: list, x, ws, y, w, stream):
    """A launch of ``lib``'s attention entry ("fast", not causal)."""
    s, l, c = x.shape
    f32 = x.dtype == torch.float32
    entry = lib.tante_block_long_attn_sm90_f32_fwd if f32 else lib.tante_block_long_attn_sm90_fwd
    ptrs, arr = fb._ptr_array([w]), (ctypes.c_int * len(plan_ints))(*plan_ints)
    return lambda: entry(x.data_ptr(), ws.data_ptr(), y.data_ptr(), ptrs, arr, s, l, c, c,  # noqa: E731
                         HEADS, 0, 0, x.device.index, stream)


def long_phases(dev, stream, card: str) -> None:
    """Per-item phases of the long attention entry (see the module text)."""
    info = _build.compile_library("fused_block_long_sm90", "fused_block_long_sm90_phases",
                                  TIMING_FLAGS)
    lib = _build.bind(ctypes.CDLL(info["library"]), "fused_block_long_sm90")
    for fn in ("tante_block_long_phase_read", "tante_sm90_gemm_cycles"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_int
    n_ph = lib.tante_block_long_phase_count()
    for dtype in (torch.bfloat16, torch.float32):
        for axis in LONG_AXES:
            p, x, y, plan, w, ws = _long_setup(axis, dtype, dev)
            s, l, c = x.shape
            launch = _long_launch(lib, plan.ints(), x, ws, y, w, stream)
            work = fb.long_attn_work(x, plan, c)
            grid = work["grid"]
            if launch() != 0:
                raise RuntimeError(f"{axis}: launch failed")
            torch.cuda.synchronize()
            _read(lib, "tante_block_long_phase_read", (grid, n_ph))  # zeroes the counters
            _read(lib, "tante_sm90_gemm_cycles", (grid, 4, 3))
            iters = 2 if axis == "C" else 10
            ms = _timed(launch, iters)
            cyc = _read(lib, "tante_block_long_phase_read", (grid, n_ph)).astype(np.float64)
            per_mm = _read(lib, "tante_sm90_gemm_cycles", (grid, 4, 3)).astype(np.float64)
            per_cta_items = cyc[:, -1] / (iters + 3)
            total = cyc[:, :-1].sum(axis=0) / cyc[:, -1].sum()  # cycles per item
            per_mm = per_mm.sum(axis=0) / cyc[:, -1].sum()
            item = float(total.sum() - total[LONG_PHASES.index("ln2")])  # LN2 is in the tail
            print(json.dumps({
                "kernel": "long attention entry (fused_block_long_sm90.cu), timing build",
                "axis": axis, "dtype": str(dtype).replace("torch.", ""), "shape": [s, l, c],
                "plan": plan._asdict(), **work,
                "items_per_cta": [float(per_cta_items.min()), float(per_cta_items.max())],
                "timing_build_ms": ms,
                "cycles_per_item": {k: float(v) for k, v in zip(LONG_PHASES, total)},
                "item_cycles": item,
                "share_of_item": {k: float(v) / item for k, v in zip(LONG_PHASES, total)},
                "tail_matmul_cycles_per_item": {
                    k: v for k, v in _cycles(per_mm, ("slab_wait", "mma", "epilogue")).items()
                    if k != "qkv"},
                "workspace_reads": fb.long_attn_reads(plan, s, l, c, False, False, dtype,
                                                      work["big"]),
                "card": card,
            }), flush=True)
            del x, y, ws
            torch.cuda.empty_cache()


def _same_or_own(base_w, w):
    """The baseline's re-laid weights, or this tree's where they hold the
    same values (then both kernels read the same addresses: where a copy of
    the weights lies in memory can move a short kernel's time by itself);
    and whether they were shared."""
    same = len(base_w) == len(w) and all(torch.equal(a, b) for a, b in zip(base_w, w))
    return (w if same else base_w), same


def long_in_turns(dev, stream, card: str, baseline: str) -> None:
    """The baseline tree's long attention entry and this tree's in turns."""
    source = Path(baseline) / "tante_tpu_torch" / "ops" / "csrc" / "fused_block_long_sm90.cu"
    info = _build.compile_library("fused_block_long_sm90", "fused_block_long_sm90_baseline", (),
                                  source=source)
    other = _build.bind(ctypes.CDLL(info["library"]), "fused_block_long_sm90")
    this = _build.load("fused_block_long_sm90")
    base_fb = _baseline_fused_block(baseline)
    for dtype in (torch.bfloat16, torch.float32):
        for axis in LONG_AXES:
            p, x, y, plan, w, ws = _long_setup(axis, dtype, dev)
            s, l, c = x.shape
            base_plan = base_fb.long_plan(c, c, HEADS, dtype)
            base_w, shared = _same_or_own(base_fb.sm90_weights(p, HEADS, base_plan), w)
            y_base = torch.empty_like(y)
            if (_long_launch(other, base_plan.ints(), x, ws, y_base, base_w, stream)() != 0
                    or _long_launch(this, plan.ints(), x, ws, y, w, stream)() != 0):
                raise RuntimeError(f"{axis}: launch failed")
            torch.cuda.synchronize()
            diff = float((y_base.float() - y.float()).abs().max())
            # Timed on the same inputs and one output buffer.
            runs = {"baseline": _long_launch(other, base_plan.ints(), x, ws, y, base_w, stream),
                    "this_tree": _long_launch(this, plan.ints(), x, ws, y, w, stream)}
            iters = 3 if axis == "C" else 50
            b1 = event_ms(runs["baseline"], iters=iters)
            t1 = event_ms(runs["this_tree"], iters=iters)
            t2 = event_ms(runs["this_tree"], iters=iters)
            b2 = event_ms(runs["baseline"], iters=iters)
            print(json.dumps({
                "kernel": "long attention entry in turns", "axis": axis,
                "dtype": str(dtype).replace("torch.", ""), "baseline": str(source),
                "shape": [s, l, c], "baseline_ms": (b1 + b2) / 2, "this_tree_ms": (t1 + t2) / 2,
                "speedup": (b1 + b2) / (t1 + t2), "weights_shared": shared,
                "baseline_ms_turns": [b1, b2], "this_tree_ms_turns": [t1, t2],
                "max_abs_diff_baseline_vs_this_tree": diff,
                "max_abs_output": float(y_base.float().abs().max()), "card": card,
            }), flush=True)
            del x, y, y_base, ws
            torch.cuda.empty_cache()


# ---- the long half's attention kernel (--long-half) -----------------------------


def _half_long_setup(axis: str, dtype, dev):
    """Shard 0 at tp 2 of a flagship long block in ``dtype``: the shard's
    attention half, input, output, this tree's plan, re-laid weights and
    workspace (this tree's qkv kernel)."""
    p, x, y, _, _, _ = _long_setup(axis, dtype, dev, qkv=False)
    c = x.shape[-1]
    ps = shard_block(p, 2, 0)
    ap = fb.AttnHalfParams(*(getattr(ps, f) for f in fb.AttnHalfParams._fields))
    ca, heads = c // 2, HEADS // 2
    plan = fb.half_long_plan(c, ca, heads, dtype)
    w = fb.half_long_weights(ap, heads, plan)
    return ap, x, y, plan, w, fb.half_long_qkv_fwd(x, w, plan, x.shape[1], ca)


def _half_long_launch(lib, plan_ints: list, x, ws, y, w, stream):
    """A launch of ``lib``'s long-half attention kernel ("fast", not causal)."""
    s, l, c = x.shape
    f32 = x.dtype == torch.float32
    entry = (lib.tante_attn_half_long_attn_sm90_f32_fwd if f32
             else lib.tante_attn_half_long_attn_sm90_fwd)
    ptrs, arr = fb._ptr_array([w]), (ctypes.c_int * len(plan_ints))(*plan_ints)
    return lambda: entry(ws.data_ptr(), y.data_ptr(), ptrs, arr, s, l, c, c // 2,  # noqa: E731
                         HEADS // 2, 0, 0, x.device.index, stream)


def half_long_in_turns(dev, stream, card: str, baseline: str) -> None:
    """The baseline tree's long-half attention kernel and this tree's in turns."""
    source = Path(baseline) / "tante_tpu_torch" / "ops" / "csrc" / "fused_half_long_sm90.cu"
    info = _build.compile_library("fused_half_long_sm90", "fused_half_long_sm90_baseline", (),
                                  source=source)
    other = _build.bind(ctypes.CDLL(info["library"]), "fused_half_long_sm90")
    this = _build.load("fused_half_long_sm90")
    base_fb = _baseline_fused_block(baseline)
    for dtype in (torch.bfloat16, torch.float32):
        for axis in LONG_AXES:
            ap, x, y, plan, w, ws = _half_long_setup(axis, dtype, dev)
            s, l, c = x.shape
            base_plan = base_fb.half_long_plan(c, c // 2, HEADS // 2, dtype)
            base_w, shared = _same_or_own(base_fb.half_long_weights(ap, HEADS // 2, base_plan), w)
            y_base = torch.empty_like(y)
            if (_half_long_launch(other, base_plan.ints(), x, ws, y_base, base_w, stream)() != 0
                    or _half_long_launch(this, plan.ints(), x, ws, y, w, stream)() != 0):
                raise RuntimeError(f"{axis}: launch failed")
            torch.cuda.synchronize()
            diff = float((y_base.float() - y.float()).abs().max())
            # Timed on the same inputs and one output buffer.
            runs = {"baseline": _half_long_launch(other, base_plan.ints(), x, ws, y, base_w,
                                                  stream),
                    "this_tree": _half_long_launch(this, plan.ints(), x, ws, y, w, stream)}
            iters = 3 if axis == "C" else 50
            b1 = event_ms(runs["baseline"], iters=iters)
            t1 = event_ms(runs["this_tree"], iters=iters)
            t2 = event_ms(runs["this_tree"], iters=iters)
            b2 = event_ms(runs["baseline"], iters=iters)
            print(json.dumps({
                "kernel": "long half attention kernel in turns", "axis": axis, "tp": 2,
                "shard": 0, "dtype": str(dtype).replace("torch.", ""), "baseline": str(source),
                "shape": [s, l, c], "baseline_ms": (b1 + b2) / 2, "this_tree_ms": (t1 + t2) / 2,
                "speedup": (b1 + b2) / (t1 + t2), "weights_shared": shared,
                "baseline_ms_turns": [b1, b2], "this_tree_ms_turns": [t1, t2],
                "max_abs_diff_baseline_vs_this_tree": diff,
                "max_abs_output": float(y_base.float().abs().max()),
                "plan": plan._asdict(), "baseline_plan": base_plan._asdict(), "card": card,
            }), flush=True)
            del x, y, y_base, ws
            torch.cuda.empty_cache()


HALF_LONG_PHASES = ("kv_wait", "scores", "softmax", "av", "q_wait", "tail", "between")


def half_long_phases(dev, stream, card: str) -> None:
    """Per-item phases of the long half's attention kernel (module text)."""
    info = _build.compile_library("fused_half_long_sm90", "fused_half_long_sm90_phases",
                                  TIMING_FLAGS)
    lib = _build.bind(ctypes.CDLL(info["library"]), "fused_half_long_sm90")
    for fn in ("tante_attn_half_long_phase_read", "tante_sm90_gemm_cycles"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_int
    n_ph = lib.tante_attn_half_long_phase_count()
    for dtype in (torch.bfloat16, torch.float32):
        for axis in LONG_AXES:
            ap, x, y, plan, w, ws = _half_long_setup(axis, dtype, dev)
            s, l, c = x.shape
            launch = _half_long_launch(lib, plan.ints(), x, ws, y, w, stream)
            work = fb.half_long_attn_work(x, plan, l, c // 2)
            grid = work["grid"]
            if launch() != 0:
                raise RuntimeError(f"{axis}: launch failed")
            torch.cuda.synchronize()
            _read(lib, "tante_attn_half_long_phase_read", (grid, n_ph))  # zeroes the counters
            _read(lib, "tante_sm90_gemm_cycles", (grid, 4, 3))
            iters = 2 if axis == "C" else 10
            ms = _timed(launch, iters)
            cyc = _read(lib, "tante_attn_half_long_phase_read", (grid, n_ph)).astype(np.float64)
            per_mm = _read(lib, "tante_sm90_gemm_cycles", (grid, 4, 3)).astype(np.float64)
            per_cta_items = cyc[:, -1] / (iters + 3)
            total = cyc[:, :-1].sum(axis=0) / cyc[:, -1].sum()  # cycles per item
            total = total[:len(HALF_LONG_PHASES)]  # the block's LN2 has no counterpart here
            per_mm = per_mm.sum(axis=0) / cyc[:, -1].sum()
            item = float(total.sum())
            print(json.dumps({
                "kernel": "long half attention kernel (fused_half_long_sm90.cu), timing build",
                "axis": axis, "tp": 2, "shard": 0, "dtype": str(dtype).replace("torch.", ""),
                "shape": [s, l, c], "plan": plan._asdict(), **work,
                "items_per_cta": [float(per_cta_items.min()), float(per_cta_items.max())],
                "timing_build_ms": ms,
                "cycles_per_item": {k: float(v) for k, v in zip(HALF_LONG_PHASES, total)},
                "item_cycles": item,
                "share_of_item": {k: float(v) / item for k, v in zip(HALF_LONG_PHASES, total)},
                "out_projection_cycles_per_item": _cycles(
                    per_mm, ("slab_wait", "mma", "epilogue"))["o_proj"],
                "workspace_reads": fb.long_attn_reads(plan, s, l, plan.width, False, False,
                                                      dtype, work["big"]),
                "card": card,
            }), flush=True)
            del x, y, ws
            torch.cuda.empty_cache()


# ---- the long pairs' qkv kernels (--long-qkv) ------------------------------------

QKV_PHASES = ("x_wait", "ln1", "products", "stage_wait", "epilogue")  # consumer thread 0
QKV_SLAB_WAIT = len(QKV_PHASES)  # thread 0's weight-slab waits, within its products
QKV_STORE_PHASES = ("issue", "full_wait", "read_wait")                  # the store thread


def _qkv_kernels(dev, dtype, axis: str) -> list[dict]:
    """The four qkv kernels' operands at a flagship long block in ``dtype``:
    the long block's entry and shard 0 at tp 2 of the long half's kernel;
    per kernel its library, C entry name, params, plan, re-laid weights,
    width argument and workspace shape (one x for both)."""
    p, x, _, _, _, _ = _long_setup(axis, dtype, dev, qkv=False)
    s, l, c = x.shape
    dt = "_f32" if dtype == torch.float32 else ""
    plan = fb.long_plan(c, c, HEADS, dtype)
    ap = fb.AttnHalfParams(*(getattr(shard_block(p, 2, 0), f) for f in fb.AttnHalfParams._fields))
    hplan = fb.half_long_plan(c, c // 2, HEADS // 2, dtype)
    return x, [
        {"kernel": "block", "source": "fused_block_long_sm90",
         "entry": f"tante_block_long_qkv_sm90{dt}_fwd", "params": p, "plan": plan,
         "weights": lambda mod, pl, p=p: mod.sm90_weights(p, HEADS, pl),
         "plan_of": lambda mod: mod.long_plan(c, c, HEADS, dtype), "arg": c,
         "shape": (3, s, c // 64, l, 64)},
        {"kernel": "half tp 2 shard 0", "source": "fused_half_long_sm90",
         "entry": f"tante_attn_half_long_qkv_sm90{dt}_fwd", "params": ap, "plan": hplan,
         "weights": lambda mod, pl, ap=ap: mod.half_long_weights(ap, HEADS // 2, pl),
         "plan_of": lambda mod: mod.half_long_plan(c, c // 2, HEADS // 2, dtype), "arg": c // 2,
         "shape": (3, s, hplan.width // 64, l, 64)}]


def _qkv_launch(lib, entry: str, x, ws, w, plan_ints: list, arg: int, stream):
    s, l, c = x.shape
    fn = getattr(lib, entry)
    ptrs, arr = fb._ptr_array([w]), (ctypes.c_int * len(plan_ints))(*plan_ints)
    return lambda: fn(x.data_ptr(), ws.data_ptr(), ptrs, arr, s, l, c, arg,  # noqa: E731
                      x.device.index, stream)


def qkv_in_turns(dev, stream, card: str, baseline: str) -> None:
    """The baseline tree's four qkv kernels and this tree's in turns (module
    text), their workspaces compared bit for bit."""
    import chip_smoke  # noqa: PLC0415 (chip_smoke imports this module)

    csrc = Path(baseline) / "tante_tpu_torch" / "ops" / "csrc"
    libs = {}
    for src in ("fused_block_long_sm90", "fused_half_long_sm90"):
        info = _build.compile_library(src, f"{src}_baseline", (), source=csrc / f"{src}.cu")
        libs[src] = (_build.bind(ctypes.CDLL(info["library"]), src), _build.load(src))
    base_fb = _baseline_fused_block(baseline)
    for dtype in (torch.bfloat16, torch.float32):
        for axis in LONG_AXES:
            x, kernels = _qkv_kernels(dev, dtype, axis)
            s, l, c = x.shape
            for k in kernels:
                other, this = libs[k["source"]]
                plan, base_plan = k["plan"], k["plan_of"](base_fb)
                w = k["weights"](fb, plan)
                base_w, shared = _same_or_own(k["weights"](base_fb, base_plan), w)
                ws = torch.empty(k["shape"], dtype=dtype, device=dev)
                ws_base = torch.empty_like(ws)
                runs = {"baseline": _qkv_launch(other, k["entry"], x, ws, base_w,
                                                base_plan.ints(), k["arg"], stream),
                        "this_tree": _qkv_launch(this, k["entry"], x, ws, w, plan.ints(),
                                                 k["arg"], stream)}
                if (_qkv_launch(other, k["entry"], x, ws_base, base_w, base_plan.ints(),
                                k["arg"], stream)() != 0 or runs["this_tree"]() != 0):
                    raise RuntimeError(f"{k['kernel']} {axis}: launch failed")
                torch.cuda.synchronize()
                equal = bool(torch.equal(ws, ws_base))
                diff = float((ws.float() - ws_base.float()).abs().max())
                del ws_base
                iters = 5 if axis == "C" else 50
                b1 = event_ms(runs["baseline"], iters=iters)
                t1 = event_ms(runs["this_tree"], iters=iters)
                t2 = event_ms(runs["this_tree"], iters=iters)
                b2 = event_ms(runs["baseline"], iters=iters)
                if k["kernel"] == "block":
                    bounds = chip_smoke.long_bounds(s, l, c, c, False, dtype)["qkv"]
                else:
                    bounds = chip_smoke.half_long_bounds(s, l, c, c // 2, plan.width, False,
                                                         dtype)["qkv"]
                this_ms = (t1 + t2) / 2
                print(json.dumps({
                    "kernel": f"long qkv ({k['kernel']}) in turns", "axis": axis,
                    "dtype": str(dtype).replace("torch.", ""), "shape": [s, l, c],
                    "baseline": str(csrc / (k["source"] + ".cu")),
                    "baseline_ms": (b1 + b2) / 2, "this_tree_ms": this_ms,
                    "speedup": (b1 + b2) / (t1 + t2), "baseline_ms_turns": [b1, b2],
                    "this_tree_ms_turns": [t1, t2], "workspace_bit_equal": equal,
                    "max_abs_diff": diff, "weights_shared": shared,
                    "bound_ms": bounds["bound_us"] / 1e3, "bound_by": bounds["bound_by"],
                    "bytes": bounds["bytes"], "this_tree_gb_per_s": bounds["bytes"] / this_ms / 1e6,
                    "baseline_gb_per_s": bounds["bytes"] / ((b1 + b2) / 2) / 1e6,
                    "bound_share": bounds["bound_us"] / 1e3 / this_ms,
                    "plan": plan._asdict(), "baseline_plan": base_plan._asdict(), "card": card,
                }), flush=True)
                del ws
            del x
            torch.cuda.empty_cache()


def qkv_phases(dev, stream, card: str) -> None:
    """Per-tile phase cycles of the four qkv kernels from a
    ``-DTANTE_PHASE_TIMING`` build (module text)."""
    libs = {}
    for src, read in (("fused_block_long_sm90", "tante_block_long_qkv_phase"),
                      ("fused_half_long_sm90", "tante_attn_half_long_qkv_phase")):
        info = _build.compile_library(src, f"{src}_phases", TIMING_FLAGS)
        lib = _build.bind(ctypes.CDLL(info["library"]), src)
        getattr(lib, f"{read}_read").argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lib, f"{read}_read").restype = ctypes.c_int
        libs[src] = (lib, read)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for axis in LONG_AXES:
            x, kernels = _qkv_kernels(dev, dtype, axis)
            s, l, c = x.shape
            for k in kernels:
                lib, read = libs[k["source"]]
                plan = k["plan"]
                n_ph = getattr(lib, f"{read}_count")()
                ws = torch.empty(k["shape"], dtype=dtype, device=dev)
                launch = _qkv_launch(lib, k["entry"], x, ws, k["weights"](fb, plan), plan.ints(),
                                     k["arg"], stream)
                tiles = -(-s * l // plan.rows)
                grid = min(tiles, sms)
                if launch() != 0:
                    raise RuntimeError(f"{k['kernel']} {axis}: launch failed")
                torch.cuda.synchronize()
                _read(lib, f"{read}_read", (grid, n_ph))  # zeroes the counters
                iters = 2 if axis == "C" else 10
                ms = _timed(launch, iters)
                cyc = _read(lib, f"{read}_read", (grid, n_ph)).astype(np.float64)
                n_tiles, n_groups = cyc[:, -2].sum(), cyc[:, -1].sum()
                per_tile = cyc[:, :len(QKV_PHASES)].sum(axis=0) / n_tiles
                store = cyc[:, QKV_SLAB_WAIT + 1:-2].sum(axis=0) / n_tiles
                slab_wait = float(cyc[:, QKV_SLAB_WAIT].sum() / n_tiles)
                tile = float(per_tile.sum())
                print(json.dumps({
                    "kernel": f"long qkv ({k['kernel']}), timing build", "axis": axis,
                    "dtype": str(dtype).replace("torch.", ""), "shape": [s, l, c],
                    "plan": plan._asdict(), "tiles": tiles, "grid": grid,
                    "groups_per_tile": float(n_groups / n_tiles), "timing_build_ms": ms,
                    "cycles_per_tile": {p: float(v) for p, v in zip(QKV_PHASES, per_tile)},
                    "tile_cycles": tile,
                    "share_of_tile": {p: float(v) / tile for p, v in zip(QKV_PHASES, per_tile)},
                    "slab_wait_cycles_per_tile": slab_wait,
                    "store_thread_cycles_per_tile": {p: float(v)
                                                     for p, v in zip(QKV_STORE_PHASES, store)},
                    "card": card,
                }), flush=True)
                del ws
            del x
            torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    args = sys.argv[1:]
    if "--packed" in args:
        dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
        packed_phases(dev, stream, card)
        if "--baseline" in args:
            packed_in_turns(dev, stream, card, args[args.index("--baseline") + 1])
        return 0
    if "--long-qkv" in args:
        dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
        specs = [(k, name, flags) for k in ("fused_block_long_sm90", "fused_half_long_sm90")
                 for name, flags in ((f"{k}_phases", TIMING_FLAGS), (k, ()))]
        if "--baseline" in args:
            base = Path(args[args.index("--baseline") + 1]) / "tante_tpu_torch" / "ops" / "csrc"
            specs += [(k, f"{k}_baseline", (), base / f"{k}.cu")
                      for k in ("fused_block_long_sm90", "fused_half_long_sm90")]
        _build.compile_libraries(specs)  # one nvcc each, together; each is found built below
        if "--baseline" in args:
            qkv_in_turns(dev, stream, card, args[args.index("--baseline") + 1])
        qkv_phases(dev, stream, card)
        return 0
    if "--long-half" in args:
        dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
        specs = [("fused_half_long_sm90", "fused_half_long_sm90_phases", TIMING_FLAGS),
                 ("fused_half_long_sm90", "fused_half_long_sm90", ())]
        if "--baseline" in args:
            base = Path(args[args.index("--baseline") + 1]) / "tante_tpu_torch" / "ops" / "csrc"
            specs += [("fused_half_long_sm90", "fused_half_long_sm90_baseline", (),
                       base / "fused_half_long_sm90.cu"),
                      ("fused_block_long_sm90", "fused_block_long_sm90", ()),
                      ("fused_block_long_sm90", "fused_block_long_sm90_baseline", (),
                       base / "fused_block_long_sm90.cu")]
        _build.compile_libraries(specs)  # one nvcc each, together; each is found built below
        if "--baseline" in args:
            half_long_in_turns(dev, stream, card, args[args.index("--baseline") + 1])
            long_in_turns(dev, stream, card, args[args.index("--baseline") + 1])
        half_long_phases(dev, stream, card)
        return 0
    if "--long" in args:
        dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
        specs = [("fused_block_long_sm90", "fused_block_long_sm90_phases", TIMING_FLAGS),
                 ("fused_block_long_sm90", "fused_block_long_sm90", ())]
        if "--baseline" in args:
            base = Path(args[args.index("--baseline") + 1])
            specs.append(("fused_block_long_sm90", "fused_block_long_sm90_baseline", (),
                          base / "tante_tpu_torch" / "ops" / "csrc" / "fused_block_long_sm90.cu"))
        _build.compile_libraries(specs)  # one nvcc each, together; each is found built below
        if "--baseline" in args:
            long_in_turns(dev, stream, card, args[args.index("--baseline") + 1])
        long_phases(dev, stream, card)
        return 0
    if "--f32" in args:
        dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
        specs = [("fused_block_sm90", "fused_block_sm90_phases", TIMING_FLAGS),
                 ("fused_block_sm90", "fused_block_sm90", ())]
        if "--baseline" in args:
            base = Path(args[args.index("--baseline") + 1])
            specs.append(("fused_block_sm90", "fused_block_sm90_baseline", (),
                          base / "tante_tpu_torch" / "ops" / "csrc" / "fused_block_sm90.cu"))
        _build.compile_libraries(specs)  # one nvcc each, together; each is found built below
        f32_phases(dev, stream, card)
        if "--baseline" in args:
            f32_in_turns(dev, stream, card, args[args.index("--baseline") + 1])
        return 0
    halves_only = "--halves" in args
    # The measurement copies build together; each is found built below.
    kernels = ("fused_half_sm90",) if halves_only else (
        "fused_block_sm90", "fused_chain_sm90", "fused_half_sm90", "fused_block")
    _build.compile_libraries([(k, f"{k}_phases", TIMING_FLAGS) for k in kernels])
    dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
    if not halves_only:
        sm90_phases(dev, stream, card)
        chain_phases(dev, stream, card)
    half_phases(dev, stream, card)
    if halves_only:
        return 0
    info = _build.compile_library("fused_block", "fused_block_phases", TIMING_FLAGS)
    lib = _build.bind(ctypes.CDLL(info["library"]))
    lib.tante_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tante_phase_read.restype = ctypes.c_int
    for i, (label, (shape, causal)) in enumerate(CASES.items()):
        scaled = fb._prescaled(_params(i, dev), HEADS)  # alive while the kernels run
        ptrs = fb._ptr_array([scaled])
        x = torch.from_numpy(np.random.default_rng(i).normal(size=shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        y = torch.empty_like(x)
        if label == "T":
            b, t, h, w, _ = shape
            l, n_seqs = t, b * h * w
            launch = lambda: lib.tante_fused_block_canon_t_fwd(  # noqa: E731
                x.data_ptr(), y.data_ptr(), ptrs, b, t, h * w, C, HIDDEN, HEADS, 0, stream)
        else:  # the H or W block alone: a one-block chain run of the same body
            n_seqs, l, _ = shape
            plan = [v for row in fb.chain_plan(label, DIMS, 8, fb._ORDER[label],
                                               fb._ORDER[label]) for v in row]
            plan_arr = (ctypes.c_int * len(plan))(*plan)
            launch = lambda: lib.tante_fused_chain_fwd(  # noqa: E731
                x.data_ptr(), y.data_ptr(), None, None, ptrs, plan_arr, 1, C, HIDDEN, HEADS, 0,
                0, stream)
        for _ in range(3):
            if launch() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch()
        stop.record()
        stop.synchronize()
        ctas = -(-n_seqs // _build.plan(l, C, HIDDEN, lib)["seqs_per_cta"])
        stamps = np.zeros((ctas, len(PHASES) + 1), dtype=np.uint64)
        if lib.tante_phase_read(stamps.ctypes.data, ctas) != 0:
            raise RuntimeError("reading the phase stamps failed")
        per_cta_us = np.diff(stamps.astype(np.float64), axis=1).mean(axis=0) / 1e3
        print(json.dumps({
            "block": label, "shape": list(shape), "causal": causal, "ctas": ctas,
            "timing_build_ms": start.elapsed_time(stop) / 20,
            "per_cta_us": {p: float(v) for p, v in zip(PHASES, per_cta_us)},
            "cta_us": float(per_cta_us.sum()), "card": card,
        }), flush=True)
    # The chain kernel, run THW: the stamps left are the W block's tiles.
    shape, axes = CASES["T"][0], "THW"
    dims = shape[1:4]
    ps = [fb._prescaled(_params(10 + i, dev), HEADS) for i in range(len(axes))]
    x = torch.from_numpy(np.random.default_rng(9).normal(size=shape).astype(np.float32))
    x = x.to(dev, torch.bfloat16)
    y, bufs = torch.empty_like(x), [torch.empty_like(x) for _ in range(2)]
    plan = [v for row in fb.chain_plan(axes, dims, shape[0]) for v in row]
    plan_arr = (ctypes.c_int * len(plan))(*plan)
    launch = lambda: lib.tante_fused_chain_fwd(  # noqa: E731
        x.data_ptr(), y.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), fb._ptr_array(ps),
        plan_arr, len(axes), C, HIDDEN, HEADS, 0, 0, stream)
    for _ in range(3):
        if launch() != 0:
            raise RuntimeError("chain: launch failed")
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        launch()
    stop.record()
    stop.synchronize()
    tiles = shape[0] * dims[0] * dims[1]  # one W sequence (48 rows) per tile
    stamps = np.zeros((tiles, len(PHASES) + 1), dtype=np.uint64)
    if lib.tante_phase_read(stamps.ctypes.data, tiles) != 0:
        raise RuntimeError("reading the phase stamps failed")
    ns = stamps.astype(np.float64)
    per_tile_us = np.diff(ns, axis=1).mean(axis=0) / 1e3
    print(json.dumps({
        "block": "chain THW: tiles of its last block (W)", "shape": list(shape), "tiles": tiles,
        "timing_build_ms": start.elapsed_time(stop) / 20,
        "per_cta_us": {p: float(v) for p, v in zip(PHASES, per_tile_us)},
        "cta_us": float(per_tile_us.sum()),
        "block_span_us": float((ns[:, -1].max() - ns[:, 0].min()) / 1e3), "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
