"""Device selection (counterpart of ``tante_tpu/ops/backend.py``).

The port's entry points run on the GPU.  The CPU is taken only when the
caller asks for it by name (the tests do); a missing card is an error, never
a silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); ``"cpu"`` / a
    ``torch.device`` -> that device, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tante_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
