"""Where the time goes inside the fused-block kernels, on the card.

    python3 -m tante_tpu_torch.tools.kernel_phases

First the single-block kernel of ``fused_block_apply``
(``ops/csrc/fused_block_sm90.cu``): a measurement copy built with
``-DTANTE_PHASE_TIMING`` stamps the global timer after the consumer
warpgroups' barrier at each phase (LN1, each head group's q|k|v projection
and attention, out-projection, LN2, fc1, fc2); one JSON line per block (H,
W and the rearranged causal T block) with the mean microseconds per tile of
each phase, summed over the head groups.

Then the PR-1 tile body (``block_tile``, which the canonical T block, the
chain and the tensor-parallel halves run): a measurement copy of
``ops/csrc/fused_block.cu`` with
``-DTANTE_PHASE_TIMING`` (a CTA barrier and a global-timer stamp at each
phase boundary: start, row gather, LN1, q, k, v, attention, out-projection,
LN2, fc1, fc2), launches the flagship H and W blocks (each a one-block chain
run) and the canonical T block with seeded bf16 inputs, and prints one JSON
line per block: the mean microseconds per CTA of each phase, the CTA count,
and the measurement build's launch time (the stamps' barriers make it a
little slower than the production kernel).

A last line does the same for the chain kernel on the run ``THW``: tiles
stamp by tile number and each block of a run overwrites the one before, so
what is read back are the tiles of the run's LAST block (W), to hold against
the one-block W run above; ``block_span_us`` is the time from the first
tile's start to the last tile's end of that block across the grid.
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
              "T rearranged": ((8 * 16 * 48, 4, C), True)}


def sm90_phases(dev, stream, card: str) -> None:
    info = _build.compile_library("fused_block_sm90", "fused_block_sm90_phases",
                                  ("-DTANTE_PHASE_TIMING",))
    lib = _build.bind(ctypes.CDLL(info["library"]), "fused_block_sm90")
    lib.tante_sm90_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tante_sm90_phase_read.restype = ctypes.c_int
    lib.tante_sm90_gemm_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tante_sm90_gemm_cycles.restype = ctypes.c_int
    n_stamps = lib.tante_sm90_phase_stamps()
    groups = C // 64
    names = ["ln1"] + [f"{k}_{g}" for g in range(groups) for k in ("qkv", "attention")]
    names += ["o_proj", "ln2", "fc1", "fc2"]
    for i, (label, (shape, causal)) in enumerate(SM90_CASES.items()):
        n_seqs, l, _ = shape
        p = _params(20 + i, dev)
        plan = fb.sm90_plan(l, C, HIDDEN)
        w = fb.sm90_weights(p, HEADS, plan)
        ptrs, plan_arr = fb._ptr_array([w]), (ctypes.c_int * 7)(*plan.ints())
        x = torch.from_numpy(np.random.default_rng(i).normal(size=shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        y = torch.empty_like(x)
        launch = lambda: lib.tante_fused_block_sm90_fwd(  # noqa: E731
            x.data_ptr(), y.data_ptr(), ptrs, plan_arr, n_seqs, l, C, HIDDEN, HEADS, int(causal),
            0, 0, stream)
        tiles = -(-n_seqs // plan.seqs)
        cycles = np.zeros((tiles, 4, 3), dtype=np.uint64)
        for _ in range(3):
            if launch() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        lib.tante_sm90_gemm_cycles(cycles.ctypes.data, tiles)  # zeroes the counters
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch()
        stop.record()
        stop.synchronize()
        if lib.tante_sm90_gemm_cycles(cycles.ctypes.data, tiles) != 0:
            raise RuntimeError("reading the matmul cycle counters failed")
        per_mm = cycles.astype(np.float64).mean(axis=0) / 20
        stamps = np.zeros((tiles, n_stamps), dtype=np.uint64)
        if lib.tante_sm90_phase_read(stamps.ctypes.data, tiles) != 0:
            raise RuntimeError("reading the phase stamps failed")
        used = [0, 1, *range(2, 2 + 2 * groups), *range(n_stamps - 4, n_stamps)]
        ns = stamps[:, used].astype(np.float64)
        us = np.diff(ns, axis=1).mean(axis=0) / 1e3
        per = dict(zip(names, us))
        summary = {"ln1": per["ln1"], "qkv": sum(per[f"qkv_{g}"] for g in range(groups)),
                   "attention": sum(per[f"attention_{g}"] for g in range(groups)),
                   **{k: per[k] for k in ("o_proj", "ln2", "fc1", "fc2")}}
        print(json.dumps({
            "kernel": "fused_block_fwd (fused_block_sm90.cu)", "block": label,
            "shape": list(shape), "causal": causal, "tiles": tiles, "plan": plan._asdict(),
            "timing_build_ms": start.elapsed_time(stop) / 20,
            "per_tile_us": {k: float(v) for k, v in summary.items()},
            "tile_us": float(us.sum()),
            "matmul_cycles_per_tile": {
                mm: {part: float(per_mm[i][k]) for k, part in
                     enumerate(("slab_wait", "wgmma", "epilogue"))}
                for i, mm in enumerate(("qkv", "o_proj", "fc1", "fc2"))},
            "span_us": float((ns[:, -1].max() - ns[:, 0].min()) / 1e3), "card": card,
        }), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    sm90_phases(torch.device("cuda"), torch.cuda.current_stream().cuda_stream, card)
    info = _build.compile_library("fused_block", "fused_block_phases", ("-DTANTE_PHASE_TIMING",))
    lib = _build.bind(ctypes.CDLL(info["library"]))
    lib.tante_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tante_phase_read.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
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
