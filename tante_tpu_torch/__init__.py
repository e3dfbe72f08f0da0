"""tante_tpu_torch: the PyTorch / CUDA (Hopper) port of ``tante_tpu``.

The JAX package ``tante_tpu`` stays the reference; every module here mirrors
its counterpart's name and is tested against it on the CPU
(``tests/test_torch_*.py``).  The serving path (fixed latent rollout and
adaptive rollout of TANTE) and the fixed-step training path (``Trainer``
over in-memory synthetic waves) run end to end, for TANTE with either
encoder/decoder, for the FNO family (FNO, TFNO, UNO) and for the attention
family (AViT, CViT with ``cvit=True``), with the ``Evaler``'s 4-metric report;
``Trainer(mesh=...)`` trains under data, tensor and (FNO) spatial
parallelism (``parallel/``).  The paper's entry points run on the shipped
``configs/*.yaml``: ``python -m tante_tpu_torch.cli.train`` / ``cli.eval``
(``config.py``, ``registry.py``) over the Well HDF5 reader
(``data/dataset.py``, ``TanteDataModule``) or the native WellPack loader
(``data/wellpack.py``), and ``serve.Predictor.from_experiment``.
The kernels are hand-written CUDA for ``sm_90a``: the fused transformer blocks
on one Hopper tile body (``ops/csrc/block_sm90.cuh``: the single block and the
canonical T block in ``fused_block_sm90.cu``, the chain/group of blocks in
``fused_chain_sm90.cu``, the two tensor-parallel halves in
``fused_half_sm90.cu`` and, in f32, ``fused_half_sm90_f32.cu``; the first
design's body, ``fused_block.cu``, is kept
as the timing baseline), the spectral convolutions' per-mode complex channel
mixing (``ops/csrc/spectral_matmul.cu``) and the head-packed attention core
(``ops/csrc/packed_attention.cu``).

This package imports ``torch``, ``numpy`` and ``einops`` — never JAX, flax or
``tante_tpu``; ``h5py``, ``yaml`` and ``fsspec`` only inside the functions of
the data and config layers that need them.
"""

from tante_tpu_torch.ops.backend import resolve_device

__all__ = ["resolve_device"]
