"""tante_tpu_torch: the PyTorch / CUDA (Hopper) port of ``tante_tpu``.

The JAX package ``tante_tpu`` stays the reference; every module here mirrors
its counterpart's name and is tested against it on the CPU
(``tests/test_torch_*.py``).  The serving path (fixed latent rollout and
adaptive rollout of TANTE) runs end to end; its two fused transformer-block
kernels are hand-written CUDA for ``sm_90a`` (``ops/csrc/fused_block.cu``).

This package imports ``torch``, ``numpy`` and ``einops`` only — never JAX,
flax or ``tante_tpu``.
"""

from tante_tpu_torch.ops.backend import resolve_device

__all__ = ["resolve_device"]
