"""How fast the f32 tile body's 3xTF32 inner loop can run on the card.

    python3 -m tante_tpu_torch.tools.mma_rate [--slabs N]

Builds ``tools/mma_rate.cu`` (nvcc, ``sm_90a``, into ``build/kernels/``) and
runs its loop, ``block_sm90.cuh:gemm_f32_rb``'s at the q|k|v pass (64 rows x
192 columns a 16-deep slab, 8 warps), with both operands resident in shared
memory and no weight ring, one CTA on each SM, in seven variants:

    tf32 x1          one mma per product, no split: mma.sync's TF32 rate
    tf32 x3          three mma per product, no split
    3xTF32 cvt       the split by cvt.rna.tf32.f32, one running total
    3xTF32 int       the split by integer rounding (add 0x1000, clear 13 bits)
    + fresh sums     each slab's products in a fresh fragment, added in f32
    + fence          a proxy fence and warp sync per slab (the ring's release)
    + runtime rows   the 16-row block count as a runtime test in the loop

One JSON line per variant: SM cycles per slab, launch ms (CUDA events), the
tensor cores' TF32 rate and the f32 products' rate (TFLOP/s); the card's name
and power limit first.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from tante_tpu_torch.ops import _build

VARIANTS = [("tf32 x1", 1), ("tf32 x3", 3), ("3xTF32 cvt", 3), ("3xTF32 int", 3),
            ("+ fresh sums", 3), ("+ fence", 3), ("+ runtime rows", 3)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--slabs", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    info = _build.compile_library("mma_rate", source=Path(__file__).with_name("mma_rate.cu"))
    lib = ctypes.CDLL(info["library"])
    p = ctypes.c_void_p
    lib.tante_mma_rate.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tante_mma_rate.restype = ctypes.c_int
    dev = torch.device("cuda")
    ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(64 * 260, device=dev, generator=gen)
    b = torch.randn(16 * 192, device=dev, generator=gen)
    out = torch.empty(ctas * 256, device=dev)
    cycles = torch.empty(ctas, dtype=torch.int64, device=dev)
    flops = 2.0 * 64 * 16 * 192 * args.slabs * ctas  # the f32 products, all CTAs
    for v, (name, passes) in enumerate(VARIANTS):
        ms = ctypes.c_float(0.0)
        rc = lib.tante_mma_rate(a.data_ptr(), b.data_ptr(), out.data_ptr(), cycles.data_ptr(),
                                ctypes.byref(ms), args.slabs, ctas, v)
        if rc != 0:
            raise RuntimeError(f"{name}: cudaError {rc}")
        print(json.dumps({"variant": name, "ms": ms.value,
                          "cycles_per_slab": float(cycles.double().mean()) / args.slabs,
                          "tf32_tflops": passes * flops / ms.value / 1e9,
                          "f32_tflops": flops / ms.value / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
