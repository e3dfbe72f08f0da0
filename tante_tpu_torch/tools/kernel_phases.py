"""Where the time goes inside the fused-block kernel, on the card.

    python3 -m tante_tpu_torch.tools.kernel_phases

Builds a measurement copy of ``ops/csrc/fused_block.cu`` with
``-DTANTE_PHASE_TIMING`` (a CTA barrier and a global-timer stamp at each
phase boundary: start, row gather, LN1, q, k, v, attention, out-projection,
LN2, fc1, fc2), launches the flagship H, W and T blocks with seeded bf16
inputs, and prints one JSON line per block: the mean microseconds per CTA of
each phase, the CTA count, and the measurement build's launch time (the
stamps' barriers make it a little slower than the production kernel).
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device available", file=sys.stderr)
        return 2
    info = _build.compile_library("fused_block_phases", ("-DTANTE_PHASE_TIMING",))
    lib = _build.bind(ctypes.CDLL(info["library"]))
    lib.tante_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tante_phase_read.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    for i, (label, (shape, causal)) in enumerate(CASES.items()):
        ptrs = fb._ptr_array(fb._prescaled(_params(i, dev), HEADS))
        x = torch.from_numpy(np.random.default_rng(i).normal(size=shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        y = torch.empty_like(x)
        if label == "T":
            b, t, h, w, _ = shape
            l, n_seqs = t, b * h * w
            launch = lambda: lib.tante_fused_block_canon_t_fwd(  # noqa: E731
                x.data_ptr(), y.data_ptr(), ptrs, b, t, h * w, C, HIDDEN, HEADS, 0, stream)
        else:
            n_seqs, l, _ = shape
            launch = lambda: lib.tante_fused_block_fwd(  # noqa: E731
                x.data_ptr(), y.data_ptr(), ptrs, n_seqs, l, C, HIDDEN, HEADS, int(causal), 0,
                stream)
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
            "cta_us": float(per_cta_us.sum()), "card": card.strip(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
