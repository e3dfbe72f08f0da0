"""tante_tpu_torch: the PyTorch / CUDA (Hopper) port of ``tante_tpu``.

The JAX package ``tante_tpu`` stays the reference; every module here mirrors
its counterpart's name and is tested against it on the CPU
(``tests/test_torch_*.py``).  The serving path (fixed latent rollout and
adaptive rollout of TANTE) and the fixed-step training path (``Trainer``
over in-memory synthetic waves) run end to end, for TANTE with either
encoder/decoder, for the FNO family (FNO, TFNO, UNO) and for the attention
family (AViT, CViT with ``cvit=True``), with the ``Evaler``'s 4-metric report;
``Trainer(mesh=...)`` trains under data, tensor and (FNO) spatial
parallelism (``parallel/``).
The kernels are hand-written CUDA for ``sm_90a``: the fused transformer blocks
on one Hopper tile body (``ops/csrc/block_sm90.cuh``: the single block and the
canonical T block in ``fused_block_sm90.cu``, the chain/group of blocks in
``fused_chain_sm90.cu``, the two tensor-parallel halves in
``fused_half_sm90.cu``; the first design's body, ``fused_block.cu``, is kept
as the timing baseline), the spectral convolutions' per-mode complex channel
mixing (``ops/csrc/spectral_matmul.cu``) and the head-packed attention core
(``ops/csrc/packed_attention.cu``).

This package imports ``torch``, ``numpy`` and ``einops`` only — never JAX,
flax or ``tante_tpu``.
"""

from tante_tpu_torch.ops.backend import resolve_device

__all__ = ["resolve_device"]
