"""Where the time goes inside the fused-block kernels, on the card.

    python3 -m tante_tpu_torch.tools.kernel_phases [--halves]

(``--halves``: the tensor-parallel halves' sections alone.)

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
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from tante_tpu_torch.ops import _build
from tante_tpu_torch.ops import fused_block as fb

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
    for fn in ("tante_sm90_phase_read", "tante_sm90_gemm_cycles", "tante_sm90_chain_read"):
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


def _cycles(per_mm: np.ndarray) -> dict:
    return {mm: {part: float(per_mm[i][k]) for k, part in
                 enumerate(("slab_wait", "wgmma", "epilogue"))}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    halves_only = "--halves" in sys.argv[1:]
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
