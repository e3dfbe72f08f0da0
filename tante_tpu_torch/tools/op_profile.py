"""Which PyTorch operators a model call spends its device time in, on the card.

    python3 -m tante_tpu_torch.tools.op_profile [fno_cw|fno_wc|tante_fno|tante_cnn]

Builds the model at the width ``chip_smoke.py`` serves it (seeded weights,
bf16) behind a ``Predictor``, profiles ONE rollout step through
``Predictor.rollout`` with ``torch.profiler`` (``record_shapes``), and prints
one JSON line: the step's device time and kernel launches, and the operators
that take the most device time, grouped by operator and input shapes (which
tells a field-sized copy from a small one).  For TANTE the step includes the
encode of the whole first window.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tante_tpu_torch.convert import seeded_jax_params
from tante_tpu_torch.models import FNO, TANTE
from tante_tpu_torch.serve import Predictor

RES, FIELDS, IN_T = (128, 384), 4, 4


def build(name: str, dev):
    """(Predictor over the bf16 model with seeded weights, input batch)."""
    if name.startswith("fno"):
        model = FNO(in_T=IN_T, modes1=20, modes2=20, hidden_channels=48, n_layers=4,
                    dtype=torch.bfloat16, layout=name[-2:], device=dev)
        batch = 4
    else:
        model = TANTE(in_T=IN_T, attn_axes="THWTHWTHW", embed_dim=256, patch_scale=8, n_head=8,
                      mlp_ratio=1.0, enc_dec_type=name[-3:], dtype=torch.bfloat16, device=dev)
        batch = 8
    pred = Predictor.from_numpy(model, seeded_jax_params(model, seed=0), device=dev)
    x = np.random.default_rng(0).normal(size=(batch, IN_T, *RES, FIELDS)).astype(np.float32)
    return pred, torch.from_numpy(x).to(dev)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("op_profile: no CUDA device available", file=sys.stderr)
        return 2
    name = argv[1] if len(argv) > 1 else "fno_cw"
    if name not in ("fno_cw", "fno_wc", "tante_fno", "tante_cnn"):
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pred, x = build(name, dev)
    for _ in range(3):
        pred.rollout(x, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        pred.rollout(x, 1)
        torch.cuda.synchronize()
    events = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "model": name, "input": list(x.shape), "card": card,
        "device_kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "top_ops": [{"op": e.key, "input_shapes": str(e.input_shapes)[:160], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in ops[:16]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
