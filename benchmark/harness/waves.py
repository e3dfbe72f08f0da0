"""The traffic's fields: travelling waves in the four-field schema of the
turbulent-radiative-layer geometry, the data the repository's trained TANTE
asset was trained on (``chip_smoke.py:wave_input``, frozen here).

Each trajectory has a phase and a speed; frame t of it is

  f0 = s(k1) + 0.5 s(k2),  f1 = s(k2) + 0.25 s(k1),  f2 = s(k1),
  f3 = 0.7 s(k1 swapped),   s(kx, ky) = sin(kx x + ky y + phase + speed t)

on x, y in [0, 2 pi) over H and W.  The traffic file gives k1, k2 and the
ranges of phase and speed; everything is drawn on the device from the run's
seed, in a few calls.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from harness.core import derived_seed


def fields(phase: torch.Tensor, speed: torch.Tensor, t0: int, n_frames: int,
           resolution: Tuple[int, int], k1, k2) -> torch.Tensor:
    """phase, speed (N,) -> (N, n_frames, H, W, 4) float32."""
    h, w = resolution
    dev = phase.device
    gx = torch.arange(h, dtype=torch.float32, device=dev) * (2 * math.pi / h)
    gy = torch.arange(w, dtype=torch.float32, device=dev) * (2 * math.pi / w)
    t = t0 + torch.arange(n_frames, dtype=torch.float32, device=dev)
    shift = (phase[:, None] + speed[:, None] * t[None, :])[:, :, None, None]  # (N, T, 1, 1)

    def s(kx, ky, amp=1.0):
        return amp * torch.sin(kx * gx[:, None] + ky * gy[None, :] + shift)

    a, b = s(*k1), s(*k2)
    return torch.stack([a + 0.5 * b, b + 0.25 * a, a, s(k1[1], k1[0], 0.7)], dim=-1)


def trajectories(traffic: dict, seed: int, resolution, n_frames: int,
                 device) -> List[torch.Tensor]:
    """``traffic["batches"]`` batches of ``traffic["batch"]`` trajectories,
    frames 0 .. n_frames - 1 each: a list of (B, n_frames, H, W, 4), every
    trajectory's phase and speed drawn uniformly over the traffic's ranges."""
    n, b = traffic["batches"], traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, "traffic"))
    lo_p, hi_p = traffic["phase"]
    lo_s, hi_s = traffic["speed"]
    u = torch.rand((2, n * b), generator=gen, device=device)
    f = fields(lo_p + (hi_p - lo_p) * u[0], lo_s + (hi_s - lo_s) * u[1], 0, n_frames,
               tuple(resolution), tuple(traffic["k1"]), tuple(traffic["k2"]))
    return list(f.reshape(n, b, *f.shape[1:]).unbind(0))
