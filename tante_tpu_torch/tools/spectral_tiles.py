"""The mode-mixing kernel's tile templates at the FNO paths' shapes, on the card.

    python3 -m tante_tpu_torch.tools.spectral_tiles

For each main-path shape of ``spectral_mode_matmul`` (TANTE-FNO encoder and
decoder layers, the FNO layer in both layouts; ``chip_smoke.py``'s
``SPECTRAL_CASES``), one JSON line: the template the wrapper picks
(``fused_spectral.tile_plan``), then the device time of every (LO, BT, KS)
template the kernel has at that shape, each checked against the plain
version (1e-4 + 1e-4 |plain|), beside the complex64 einsum.  Device time is
``torch.profiler``'s kernel time over 20 calls.  A last line names the card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import torch

from tante_tpu_torch.ops import fused_spectral as fs

# (label, B, modes, Cin, Cout): chip_smoke.py's main-path SPECTRAL_CASES, stored weights.
SHAPES = [
    ("TANTE-FNO enc 1", 16, (32, 32), 4, 32), ("TANTE-FNO enc 2", 16, (8, 8), 64, 128),
    ("TANTE-FNO dec 1", 16, (8, 8), 128, 64), ("TANTE-FNO dec 2", 16, (32, 32), 32, 4),
    ("FNO layer", 4, (20, 11), 48, 48),
]


def device_ms(fn, iters: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / iters / 1e3


def operands(b, modes, ci, co, dev, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(ci, co, *modes, 2)) / math.sqrt(ci))
                         .astype(np.float32)).to(dev)
    perm = (*range(2, 2 + len(modes)), 0, 1)
    x = [torch.from_numpy(rng.normal(size=(b, *modes, ci)).astype(np.float32)).to(dev)
         for _ in range(2)]
    return x[0], x[1], w[..., 0].permute(perm), w[..., 1].permute(perm)


def main() -> int:
    if not torch.cuda.is_available():
        print("spectral_tiles: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    picked = fs.tile_plan
    for label, b, modes, ci, co in SHAPES:
        args = operands(b, modes, ci, co, dev)
        want = fs.spectral_mode_matmul_ref(*args)
        xc = torch.complex(args[0], args[1]).reshape(b, -1, ci).contiguous()
        wc = torch.complex(args[2], args[3]).reshape(-1, ci, co).contiguous()
        m = math.prod(modes)
        line = {"case": label, "B": b, "modes": list(modes), "Cin": ci, "Cout": co,
                "picked": picked(b, m, ci, co),
                "einsum_ms": device_ms(lambda: torch.einsum("bmi,mio->bmo", xc, wc))}
        lo = 1 if co <= fs.OUT_PER_THREAD else 2
        times = {}
        for bt in (2, 4):
            for ks in (1, 2, 4, 8):
                if (ks == 8 and bt == 4) or (ks > 1 and (ci + 1) // 2 < 2 * ks):
                    continue
                fs.tile_plan = lambda *_, t=(lo, bt, ks): t
                try:
                    got = fs.spectral_mode_matmul(*args)
                    ok = all(bool(((g - w).abs() <= 1e-4 + 1e-4 * w.abs()).all())
                             for g, w in zip(got, want))
                    times[f"LO{lo} BT{bt} KS{ks}"] = {
                        "ms": device_ms(lambda: fs.spectral_mode_matmul(*args)), "ok": ok}
                finally:
                    fs.tile_plan = picked
        line["templates"] = times
        print(json.dumps(line), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
