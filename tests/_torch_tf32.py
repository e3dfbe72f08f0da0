"""The f32 tile body's 3xTF32 arithmetic in PyTorch (``ops/csrc/block_sm90.cuh``:
``tf32_rna``, ``split_tf32``, ``mma_3xtf32``), for the CPU tests.

TF32 rounding is emulated as ``cvt.rna.tf32.f32`` does it: add 0x1000 to the
f32 bit pattern and clear its low 13 bits (to nearest, ties away from zero).
Each operand x is split into hi = tf32(x) and lo = tf32(x - hi); a product is
lo.hi + hi.lo + hi.hi summed in f32, lo.lo dropped.  ``mm3_card`` also
models how the tensor cores round their sums (toward zero) and the order
the kernel sums in."""

import numpy as np
import torch

LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32, as an f32 tensor whose low 13 bits are 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~LOW_BITS).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the card's 3xTF32 product: the small terms first."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass: what a single mma per product would give."""
    return tf32_rna(a) @ tf32_rna(b)


def _rz_f32(v: np.ndarray) -> np.ndarray:
    """float64 values rounded toward zero to f32."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def mm3_card(a: torch.Tensor, b: torch.Tensor, fresh_slabs: bool = True) -> torch.Tensor:
    """``a @ b`` in the order ``gemm_f32`` sums it, with the tensor cores'
    accumulation modelled: each m16n8k8 adds its eight exact TF32 products to
    the accumulator and truncates the sum to f32 (rounds toward zero).  Per
    16-deep slab of K the six products (lo.hi, hi.lo, hi.hi of two k8 steps)
    go to a fresh fragment, added to the total rounding to nearest; with
    ``fresh_slabs=False`` all go straight into one running total."""
    ah, al = (t.double().numpy() for t in split_tf32(a))
    bh, bl = (t.double().numpy() for t in split_tf32(b))
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        part = np.zeros_like(total) if fresh_slabs else total
        for k in (k0, k0 + 8):
            s = slice(k, k + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                part = _rz_f32(part.astype(np.float64) + x[:, s] @ y[s])
        total = (total + part).astype(np.float32) if fresh_slabs else part
    return torch.from_numpy(total)
