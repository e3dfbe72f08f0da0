"""Drive the PyTorch/H100 port of TANTE on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase is reported and the
script exits non-zero without the final result line):

1. build    nvcc builds every kernel source of this checkout
            (``tante_tpu_torch/ops/csrc/fused_block_sm90.cu``,
            ``fused_block_long_sm90.cu``, ``fused_chain_sm90.cu``, ``fused_half_sm90.cu``,
            ``fused_half_sm90_f32.cu``, ``fused_half_long_sm90.cu`` (all six on the
            Hopper tile body of ``block_sm90.cuh``; the two long ones also on
            ``long_sm90.cuh``), ``fused_block.cu`` (the
            first design, the timing baseline), ``spectral_matmul.cu`` and
            ``packed_attention.cu``, one nvcc each, started together); build
            seconds, the ``-Xptxas -v`` summaries (the bf16 and the f32
            instantiations) and each tile plan (bf16 and f32).
2. kernel   each kernel against its plain PyTorch version (f32 from the
            same bf16 inputs) at the main paths' shapes, the single-block
            kernel also under the "safe" softmax (H, W, the rearranged causal
            T block); max abs error, tolerance, kernel / plain time (CUDA
            events) and the bound.  At H and W ``fused_block_fwd`` is timed in
            turns with the first design's tile body (``block_tile``, a
            one-block run of its chain entry) on the same block.  The
            canonical T kernel is held bit for bit against
            ``fused_block_fwd`` on the rearranged tensor and timed in turns
            with the first design's canonical T entry and against rearrange +
            ``fused_block_fwd`` + rearrange.  The chain kernel (run ``THW``
            through ``fused_chain_apply``, ``THWTHWTHW`` through
            ``fused_group_apply``) is held bit for bit against the
            single-block kernels in sequence, timed in turns with the first
            design's chain entry and against that sequence.
3. grad     gradients of sum(y**2) through the autograd Functions (block,
            canonical T block, chain) against ordinary autograd through
            the f32 plain versions; relative L2 error per tensor.
3a. kernel_f32  the f32 instantiations (``*_f32_fwd``) against the f32 plain
            versions (TF32 off) on f32 inputs: ``fused_block_fwd`` at H, W,
            the active_matter geometry (L 32) and the rearranged causal T
            block, both softmax forms; the canonical T kernel, bit for bit
            against f32 ``fused_block_fwd`` on the rearranged tensor; the
            chain (``THW``) and group (``THWTHWTHW``), bit for bit against the
            f32 single-block kernels in sequence.  Relative L2, max abs error,
            kernel / plain time (CUDA events) and the bound (3xTF32).  Then
            ``grad`` in f32.
3b. kernel_long  the long entry (``fused_block_long``: ``fused_block_long_sm90.cu``'s
            qkv kernel into a workspace, then its attention kernel over streamed
            key blocks and the block's tail), in bf16 (against the f32 plain
            block from the same bf16 inputs, ATOL / RTOL) and f32 (TF32 off,
            F32_REL_L2_TOL / F32_MAX_ABS_SHARE): the flagship's L (768), X (192)
            and A (3072) blocks at C 256 and the C block (24,576 sequences of 256
            channels, 128 wide; plain on the first 512) in both softmax forms,
            causal at L 100, ragged at L 65 and 257, L 48 through the low-level
            entry; each block launched twice and the two compared bit for
            bit; wq and wk seeded LONG_QK_SCALE times wider, so that the
            softmax is peaked and a wrong attention shows; in bf16 a control,
            the plain block with its last key block dropped, must fail the
            same limit at the flagship's shapes (``dropped_keys_ref``); one
            launch of each kernel a block; each entry's time, the
            block's, the plain block's (at C on 512 sequences, scaled and
            labelled so), the bounds (``long_bounds``); the attention entry's
            work (its 128- / 64-row items, pair items past the grid's last
            whole wave, the grid) and the workspace bytes it reads, items x
            bytes each, beside the workspace's unique 3*S*L*C values; the
            phase's seconds.
4. fixed    flagship TANTE (deg=True, bf16, seeded random weights), B=8,
            16-step latent rollout through ``Predictor.rollout``; launch
            counts (exactly 96 + 48 per rollout), frames/s, and a check
            against the CPU f32 model on one sample.  Then the same
            rollout with ``fused_chain=3`` (48 chain launches, no
            single-block launch), held to the same check, and whether it
            equals the per-block rollout (same tile body and rounding
            points).  Each profiled rollout's kernel events are compared with
            the wrappers' launch counts.
4a. fixed_f32  ``configs/tante.yaml``'s TANTE as shipped (f32), seeded weights,
            B=8 x 16 steps through ``Predictor.rollout``: exactly 96 + 48 f32
            launches, frames/s, device time, busy share, host split, the first
            calls against f32 on the CPU; with ``fused_chain=3`` (48 f32 chain
            launches) and ``fused_group`` (16); the trained asset's adaptive
            rollout in f32 (K 8): calls, VRMSE and L2RE against the port's f32
            CPU run (within 1e-4 relative), frames/s.
4b. long_axes  TANTE whose backbone runs every attention axis of the JAX
            alphabet (``THWLYXAC``, the C block ``expanded_channel`` 128 wide) at
            the flagship width, seeded weights, B=8 x 16 steps through
            ``Predictor.rollout``, in bf16 then f32: exactly 16 canonical T, 48
            single-block (H, W, Y) and 64 launches of each long entry (L, X, A, C)
            a rollout, the profiler's kernel events held against them; frames/s,
            device ms, busy share, host split; the first two calls of one sample
            against the f32 model on the CPU (ROLLOUT_REL_TOL, F32_ROLLOUT_REL_TOL);
            the phase's seconds.
5. adaptive the trained asset ``tante_tpu/assets/tante_flagship.npz``
            (deg=False) through ``Predictor.rollout_adaptive`` with K=8 on
            the synthetic-waves input; n_calls, r_t, frames/s, VRMSE and
            L2RE on the held-out trajectory, checked against the CPU f32
            model.
6. train    the flagship through ``Trainer`` (bf16 over f32 weights, AdamW,
            warmup-cosine, B=8 of 128x384x4 in-memory waves, 4 rollout
            steps per train step): an epoch at ``dropout=0.1`` (plain
            blocks: no kernel launch), an epoch at ``dropout=0`` (36
            forward launches per step, backward recomputes), validation
            with ``fused_chain=3`` / per block / ``fused_group``, save and
            resume; first loss and gradient norm against the f32 model on
            the CPU for one sample; seconds per step, peak memory.
7. adaptive_train  the adaptive training path: (a) ``R_Trainer`` at
            ``configs/tante_adaptive.yaml`` (one-frame engine, B=8, 4 slots a
            step, rt_eps 0.5, value clip, seeded weights): an epoch at
            ``dropout=0.1`` (0 launches) and one at ``dropout=0`` (exactly 24 +
            12 a step), the first loss and gradient norm of one sample against
            the f32 model on the CPU; (b) the flagship recipe of
            ``scripts/train_flagship.py:92-107`` from the trained asset
            (variable-frame engine, B=4, 16 slots of 8-frame blocks, growth
            supervision): an epoch with remat (the default: 2 x 9 launches a
            real call) and one without (9), real calls per step, r_t, peak
            memory, one step each from seeded weights, the first step of one
            sample against the CPU (cums equal, loss, gradient norm); (c)
            ``R_Trainer.validation_loop`` (9 launches a call, ``saved_rt.txt``)
            and ``R_Evaler`` on the asset (16 steps, K 8: its calls per rollout
            equal to ``Predictor.rollout_adaptive``'s, its metrics to the metric
            functions on the same rollouts); model calls counted by a forward
            hook; then each block kernel on the inputs the path gave it, one
            per shape (B 8, 4 and 1), against its plain version.
8. spectral_kernel  ``spectral_mode_matmul`` against its plain version (the
            four f32 einsums) at the shapes the FNO paths give it and at
            ragged ones; kernel / plain time, the time of the one library
            call that computes the same function (a complex64 einsum) and
            their ratio, the bound; gradients of its Function against
            autograd of the plain version.
9. fno_serving  ``Predictor.rollout`` of flagship-width TANTE with the FNO
            encoder/decoder (modes 32, B=8, 16 steps, bf16: exactly 66
            mode-mixing launches beside the 96 + 48 block launches) and of
            FNO at ``configs/fno.yaml`` width (hidden 48, modes 20, 4 layers,
            B=4, both layouts: 64 launches); frames/s, and the first frames
            against the same weights in f32 on the CPU.
9a. overlap  overlapping patch convs at full width (``overlap_ratio`` 0.5: stride 1
            at every stage of the flagship's pyramid, the conv outputs average-pooled
            to the patch grid, the transposed convs' resized to it): (a) the flagship
            TANTE (seeded) through ``Predictor.rollout``, B=8 x 16 steps, bf16 and
            (b) f32 as ``configs/tante.yaml`` ships: exactly 96 + 48 block launches
            of the lane's dtype, frames/s, device ms, busy share, the top kernels and
            operators and the device ms of each named range (``op.conv_nhwc``,
            ``op.conv_transpose_nhwc``, ``op.adaptive_avg_pool2d``,
            ``op.resize_bilinear``, ``model.encode``, ``model.decode``), the first
            two calls of one sample against f32 on the CPU (5e-2 / 1e-4); (c) one
            f32 ``Trainer`` step (B 8, 4 rollout steps, dropout 0): the first loss and
            gradient norm of one sample within 1e-3 / 1e-2 of the CPU, s/step, peak
            memory, 24 + 12 f32 launches a step; (d) TANTE-FNO (modes 32) at overlap
            0.25 in bf16: 66 mode-mixing + 96 + 48 launches, within 5e-2; (e) the
            packed enc/dec API at overlap 0, bf16: ``encode`` / ``head`` with
            ``packed=True`` against the plain calls (equal bits, the largest
            difference reported; 6 + 3 launches a ``head`` call), and the fixed lane's Morton
            rollout with its encode / decode ranges named.
10. fno_train_eval  ``Trainer`` on that FNO over in-memory waves (two epochs
            of four steps: 16 forward launches per step, first loss and
            gradient norm against the f32 model on the CPU, the loss falls),
            save, then ``Evaler`` on the saved weights: the 4-metric report,
            each metric equal to the port's metric functions on the same
            rollouts.
11. packed_kernel  ``packed_attention`` against its plain version at the AViT
            shape in f32 (as AViT launches it: strided row and column views of
            one (16, 16, 16, 6, 192) projection; and as (256, 96, 64)), the JAX
            tests' (10, 128, 32) and
            (7, 16, 16) in f32 and bf16, causal and not, and a TransformerBlock's
            (1536, 128, 32) in bf16; two launches equal bit for bit, no operand
            copied; CUDA-event times (100 calls queued behind a spin of the card)
            of kernel, plain version and ``scaled_dot_product_attention`` (the
            yardstick), L2-warm and L2-cold, the bound and its share of the cold
            time.
12. packed_grad  gradients through its Function against autograd of the plain
            version (f32), packed and on AViT's strided row / column views.
13. avit    AViT at ``configs/avit.yaml`` width (embed 384, 6 heads, 12 blocks,
            drop path 0.2), f32, B=4 of 256x256x8 waves: ``Predictor.rollout``
            (16 steps = 4 calls, exactly 96 ``packed_attention`` launches, no
            operand copied by its wrapper here or below), its
            first call against the f32 CPU model; ``Trainer`` (24 forward
            launches a step; with drop path 0 the first loss and gradient norm
            against the CPU); ``Evaler`` on the saved weights.
14. cvit    CViT at ``configs/cvit.yaml`` width in bf16 on the same data:
            ``Predictor.rollout`` on the full grid, ``Trainer(cvit=True,
            num_query_points=1024)``, ``Evaler(cvit=True)``; no hand-written
            kernel runs here (8 heads x 256 tokens > 128), which the phase says.
15. zoo     the rest of the model zoo at the shipped configs' widths, f32 as
            shipped (``configs/afno.yaml``, ``dpot.yaml``, ``unet_convnext.yaml``,
            ``unet_att.yaml``), B=4 of the AViT lane's 256x256x8 waves: per model
            ``Predictor.rollout`` (16 steps; every wrapper's launch count 0: no zoo
            model reaches a Pallas kernel in JAX), its first call against f32 on
            the CPU; ``Trainer`` (AdamW 5e-5 / 1e-5, 4 rollout steps: s/step, peak
            memory, 0 launches), one sample's first loss and gradient norm (and
            AttentionUNet's running BatchNorm statistics) against the CPU;
            ``Evaler`` on the saved weights; then ``cli.train`` for one epoch on
            each config (data node replaced) and ``Predictor.from_experiment``
            with no device (on the card, bit-equal to a Predictor built by hand
            from the same ``state.pt``, buffers included).
16. tp_kernel  the two tensor-parallel half kernels (``attn_half_fwd``,
            ``mlp_half_fwd``, ``fused_half_sm90.cu``) on every shard at the
            flagship's H, W and causal T shapes, tp = 2 and 4, and at H for
            tp = 8 (32-wide shards, zero-padded), against their plain versions
            (limits of their own: a half is a pre-bias partial with no
            residual); the shards' partials recombined against the unsplit f32
            block and the unsplit kernel; launches counted; each half timed in
            turns with the first design's (``block_tile_attn_half`` /
            ``block_tile_mlp_half``) on the same shard, the kernel's own device
            time apart from its wrapper's, the profiled symbols, the bound and
            the achieved TFLOP/s; weight re-layouts counted (none over the
            timed calls; once per weight version through ``copy_to_tp``
            views) and one timed at tp = 2; gradients through each half's
            Function; then the MLP half on every 16-wide shard of the channel
            block at tp 8 (48 zero hidden columns), summed against the
            unsplit MLP.
16a. tp_kernel_f32  the f32 halves (``*_sm90_f32_fwd``,
            ``fused_half_sm90_f32.cu``) on every shard at the same H, W and
            causal T shapes, tp = 2 and 4, on f32 inputs: relative L2 against
            the f32 plain halves (TF32 off, within 1e-6), the shards' partials
            recombined against the unsplit f32 block kernel and the f32 plain
            block (within 1e-6), f32 launches counted, shard 0's kernel
            device time against the 3xTF32 bound and the FFMA peak, the plain
            halves' time, no re-layout over the timed calls.
16b. tp_kernel_long  the long attention half (``attn_half_apply`` at L > 64:
            ``fused_half_long_sm90.cu``'s qkv kernel into the shard's workspace,
            then its attention kernel, the long block's design over the
            shard's head groups (a persistent grid of work items, each
            case's items, grid and workspace bytes read reported beside the
            workspace's unique 3*S*L*W), and the out-projection partial) at
            the flagship's L, X, A and C blocks,
            every shard at tp 2 and shard 0 at tp 4 (at C a 32-wide shard
            padded to one group), every 16-wide shard of the C block at tp 8
            (one head of 16, three zero heads), causal L 100 and the "safe"
            softmax, in bf16
            (the halves' limits against the f32 plain half from the same bf16
            inputs; a control, the plain half without its last key block, must
            fail them at every flagship shape) and f32 (TF32 off,
            F32_REL_L2_TOL / F32_MAX_ABS_SHARE), wq and wk LONG_QK_SCALE wider;
            one launch of each kernel a call, two launches bit-equal; at tp 2
            and 8 the shards' partials + bo, then the MLP halves + b2, against
            the unsplit ``fused_block_long``; shard 0 at tp 2 timed: each kernel,
            the whole half and the plain half (at C on 512 sequences, scaled)
            beside the bounds (``half_long_bounds``); gradients through the
            half's Function at (64, 100, 256).
17. parallel  two spawned ranks of one gloo process group, both on the card:
            the flagship forward on (dp 1, tp 2) against one rank, in bf16
            and in f32 as configs/tante.yaml ships (exactly 18 half launches
            of the forward's dtype per model call per rank, none of the other
            and no single-device kernel; 18 weight re-layouts in the first
            call, none in the next four); the long-axes model (``THWLYXAC``,
            B cut to 2) on (dp 1, tp 2) in bf16 and f32 against one rank
            (5e-2 / 1e-5; exactly 4 short attention halves, 4 + 4 long-half
            kernels and 8 MLP halves a call per rank, nothing else, 16
            re-layouts in the first call, none in the next two); every step's loss, gradient norm
            (at tp 2 also 18 re-layouts a step) of Trainer at (dp 1, tp 2),
            (dp 2, tp 1) and FNO at (dp 1, sp 2) against one rank, the f32
            Trainer (enable_amp off) at (dp 1, tp 2) within 1e-4 of one rank
            with 36 f32 half launches a step and 18 a validation call;
            R_Trainer in f32 at (dp 1, tp 2), configs/tante_adaptive.yaml's
            one-frame engine and the flagship recipe's variable-frame engine
            from the trained asset with remat on and off (B 2, two steps
            each): every step's loss, r_t and gradient norm within 1e-4 of
            one rank, equal calls, cums and model calls, 9 + 9 f32 half
            launches a model call (twice with remat), its validation step;
            replicas equal after a dropout step, the tp checkpoint on one rank;
            AttentionUNet (``configs/unet_att.yaml``,
            depth 5, 256x256, global B 2) at (dp 1, sp 2), every 3x3 conv
            halo-exchanging, and at (dp 2, sp 1): its steps against one rank and
            its BatchNorm statistics equal on both ranks; seconds per step (two
            ranks sharing one card through gloo: not a tp speed).
18. cli     the paper's entry points at the flagship's width (run after
            adaptive_train): for ``configs/tante.yaml`` and
            ``configs/tante_adaptive.yaml`` as shipped (f32: no enable_amp;
            copies with only the data node replaced: the in-memory
            ``WaveDataModule`` at 128x384x4, B 8, or, where h5py imports, the
            configs' own node over a ``make_well_dataset`` tree with the
            native loader): ``cli.train.main`` in-process for one epoch (0
            block launches a train step at the config's dropout 0.1, 6 + 3 f32
            a validation model call), again to ``max_epoch=2`` (exactly one
            more epoch, resumed from ``recent/``), ``cli.eval.main
            --choose=best`` against the ``Evaler`` / ``R_Evaler`` built by
            hand on the same checkpoint (1e-6 relative),
            ``Predictor.from_experiment`` with no device (on the card, f32;
            96 + 48 f32 launches a 16-step B 8 rollout, the adaptive one as
            many calls as ``R_Evaler``; bit for bit a Predictor built by hand
            from the same ``state.pt``); then each block kernel on the inputs
            the path gave it against its plain version.
19. wellpack  a WellPack cache of 128x384x4 waves written by the port's cache
            writer, ``native/wellpack.cpp`` built with g++ into
            ``build/native/``, the native loader's batches (B 8, 4 in, 4 out,
            shuffled, 4 threads) against the Python ``DataLoader``'s on the
            card over two epochs (max abs 0), then each loader timed in turns
            over 3 windows of whole epochs of at least 3 s: batches/s and the
            GB/s that reached the card, median and spread, and their ratio.
20. kernels one {"kernels": [...]} line (the block, canonical T and
            mode-mixing rows also with their launches per overlap rollout; eight
            kernels, then the three f32
            block entries, then the two f32 half entries with their launches
            per f32 flagship call, Trainer step and R_Trainer step at tp 2;
            the bf16 block, canonical T, chain and tp half rows with
            the first design's time, in turns; the two bf16 block rows also
            with their launches per R_Trainer step, the two f32 block rows
            with theirs on the CLI path; then the long entry's two kernels in
            bf16 and in f32 with their launches per long_axes rollout, each
            entry's mean time over the L, X, A and C blocks beside its bound,
            the plain block's time and the whole block's; then the long
            attention half's two kernels in bf16 and in f32 with their launches
            per long-axes model call per rank at tp 2, each kernel's mean time
            over the L, X, A and C blocks beside its bound, the plain half's
            time and the whole half's).

Then the card's name and power limit (``nvidia-smi``) and, last, the
result line {"ok": true, "device": {...}}.  Exits non-zero when no CUDA
device is available.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import queue
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.data.synthetic import make_well_arrays
from tante_tpu_torch.models import attn_backbone as model_backbone
from tante_tpu_torch.models import common as model_common
from tante_tpu_torch.models.attn_backbone import AttnBackbone
from tante_tpu_torch.models.avit import AViT
from tante_tpu_torch.models.cvit import CViT
from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import _build
from tante_tpu_torch.ops import convs as model_convs
from tante_tpu_torch.ops import fused_attention as fa
from tante_tpu_torch.ops import fused_block as fb
from tante_tpu_torch.ops import fused_spectral as fs
from tante_tpu_torch.ops.activations import gelu_tanh_f32
from tante_tpu_torch.parallel.sharding import shard_block
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.tools.conv_layouts import wrapped_patch_ops
from tante_tpu_torch.tools.kernel_phases import SCRUB_BYTES, event_ms
from tante_tpu_torch.train.evaler import Evaler, cvit_full_grid_rollout, full_grid_coords
from tante_tpu_torch.train.metrics import L2RE, MSE, NNMSE, VRMSE
from tante_tpu_torch.train.optimizers import AdamW, global_norm
from tante_tpu_torch.train.r_evaler import R_Evaler
from tante_tpu_torch.train.r_trainer import R_Trainer
from tante_tpu_torch.train.rollout import (
    rollout_adaptive_train,
    rollout_adaptive_train_vf,
    rollout_fixed,
)
from tante_tpu_torch.train.schedules import LinearWarmupCosineAnnealingLR
from tante_tpu_torch.train.trainer import Trainer, set_compute_dtype

ROOT = Path(__file__).resolve().parent
ASSET = ROOT / "tante_tpu" / "assets" / "tante_flagship.npz"
FIRST_DESIGN_SOURCE = "tante_tpu_torch/ops/csrc/fused_block.cu"
HALF_SOURCE = "tante_tpu_torch/ops/csrc/fused_half_sm90.cu"
HALF_F32_SOURCE = "tante_tpu_torch/ops/csrc/fused_half_sm90_f32.cu"
SM90_SOURCE = "tante_tpu_torch/ops/csrc/fused_block_sm90.cu"
CHAIN_SOURCE = "tante_tpu_torch/ops/csrc/fused_chain_sm90.cu"
SPECTRAL_SOURCE = "tante_tpu_torch/ops/csrc/spectral_matmul.cu"
PACKED_SOURCE = "tante_tpu_torch/ops/csrc/packed_attention.cu"
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet, 700 W)
PEAK_F32_FLOPS = 67e12    # f32 outside the tensor cores (the spectral kernel's FMAs)
PEAK_TF32_FLOPS = 495e12  # dense TF32 (the f32 blocks' bound: 3 TF32 products a product)
PEAK_HBM_BYTES = 3.35e12
BATCH, IN_T, RES, FIELDS, N_STEPS, K = 8, 4, (128, 384), 4, 16, 8
C, HEADS = 256, 8
# Kernel vs plain: bf16 rounding of q, k, v, attention, fc1 and the
# residuals (a CPU emulation of the kernel's rounding points gives 0.032).
ATOL, RTOL = 5e-2, 2e-2
# A chain rounds its activations to bf16 after every block, so its error
# against the f32 plain chain grows with depth (this script on an NVIDIA H100
# 80GB HBM3 at 700 W: 0.066 at 3 blocks, 0.114 at 9); the absolute part is
# set at about twice that.
CHAIN_ATOL = {3: 1e-1, 9: 2.5e-1}
# Gradients through the Functions (the plain version recomputed in bf16)
# against f32 autograd: relative L2 per tensor (this script on the same card:
# worst 0.009; tests/test_torch_kernels_gpu.py over more cases: 0.013).
GRAD_REL_TOL = 5e-2
# First training loss / gradient norm, bf16 on the card against f32 on the
# CPU, one sample, four rollout steps through 36 blocks.
TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL = 2e-2, 1e-1
# A tp half returns a pre-bias partial with no residual: its rms is 0.03-0.14
# at these weight scales, against about 1 for a block's output, so the
# halves are held to their own limits: elementwise, and in relative L2 over
# the whole partial (this script on an NVIDIA H100 80GB HBM3 at 700 W: worst
# max abs error 0.0057, at the causal T shape).
HALF_ATOL, HALF_RTOL, HALF_REL_L2_TOL = 1.5e-2, 2e-2, 2e-2
# Trainer on a mesh against one rank on the same card, every step's loss and
# gradient norm (this script on the same card: losses within 2.4e-5, norms
# within 1.3e-3, the latter dp's bf16 reductions over half batches).  A
# missing dp mean doubles the norm; a wrong update moves the second loss.
MESH_LOSS_REL_TOL, MESH_GNORM_REL_TOL = 2e-4, 5e-3
# AttentionUNet in f32 decides its training numbers only so far
# (tante_tpu_torch/tools/zoo_conditioning.py: f32 against float64 from the
# same seeded weights, depth 5, 256x256).  At initialisation each rollout step
# multiplies the gradient by ~10 (train-mode BatchNorm over a fed-back frame),
# and AdamW's first step is lr * sign(g) for every parameter, also where f32
# rounding (ReLU inputs near 0) sets the sign.  So its parallel cell takes one
# model call a step; its first step is held at the mesh tolerances above (its
# statistics at MESH_STATS_REL_TOL), and its second step, which every sign of
# the first moves, at UNET_STEP2_* (its statistics are reported).  The tool at
# this cell (--batch 2 --rollout 1, on the CPU): first step loss 2.1e-7,
# gradient norm 4.2e-4, statistics 3.8e-6; second step 1.2e-5, 1.45e-2,
# 1.4e-3.  On an NVIDIA H100 80GB HBM3 at 700 W the mesh runs' second losses
# read 2.4e-4 and 3.1e-4 from one rank's (this script).
UNET_STEP2_LOSS_REL_TOL, UNET_STEP2_GNORM_REL_TOL = 2e-3, 5e-2
MESH_STATS_REL_TOL = 1e-3
# Validation loss with the chain / group kernel against the per-block
# kernels: the same arithmetic, so the same number.
VAL_REL_TOL = 1e-6
# Rollouts in bf16 on the card vs the f32 model on the CPU: relative L2
# error of the predicted change (the CPU in bf16 gives 2.5e-3), and the
# relative VRMSE gap of the adaptive lane.
ROLLOUT_REL_TOL = 5e-2
# The mode-mixing kernel is f32 and sums over Cin in order with FMAs where
# the plain version sums four products separately: rounding order only.
SPECTRAL_ATOL = SPECTRAL_RTOL = 1e-4
SPECTRAL_GRAD_TOL = 1e-5  # the Function's backward IS the plain version's
# FNO at configs/fno.yaml width (the model's default depth of 4 layers).
FNO_BATCH = 4
FNO_KW = dict(in_T=IN_T, modes1=20, modes2=20, hidden_channels=48, n_layers=4)
FNO_MODES = 32  # TANTE's FNO encoder/decoder: modes1 = modes2 (configs/tante.yaml)

# The f32 block kernels against their f32 plain versions (TF32 off): 3xTF32
# products (as close as f32 FMAs) in another summation order, nothing
# rounded to bf16: relative L2
# error and max abs error as a share of max |plain|.
F32_REL_L2_TOL, F32_MAX_ABS_SHARE = 1e-5, 1e-4
# Gradients through the Functions in f32: the backward is the plain
# version's, fed the kernel's output; they differ by its rounding only.
F32_GRAD_REL_TOL = 1e-4
# f32 on the card against f32 on the CPU: a rollout's predicted change
# (relative L2), and the adaptive lane's VRMSE / L2RE (relative).
F32_ROLLOUT_REL_TOL = 1e-4
AM_L = 32  # configs/tante.yaml's active_matter: 256 x 256 at patch 8, 32 x 32 tokens
LONG_SOURCE = "tante_tpu_torch/ops/csrc/fused_block_long_sm90.cu"
# The long_axes lane: TANTE with every attention axis of the JAX alphabet
# (the T, H, W, Y blocks on the single-block kernels, L, X, A and C on the
# long entry) at the flagship width; the C block's width is the JAX
# default expanded_channel.
LONG_AXES, EXPANDED = "THWLYXAC", 128
# The long blocks at the flagship (B 8 frames, latent T 4 x 16 x 48, C 256):
# axis -> (sequences, L, width).
LONG_CASES = {"L": (BATCH * IN_T, 16 * 48, C), "X": (BATCH * 16, IN_T * 48, C),
              "A": (BATCH, IN_T * 16 * 48, C), "C": (BATCH * IN_T * 16 * 48, C, EXPANDED)}
LONG_C_PLAIN_SEQS = 512  # the plain block at the C shape runs on this many sequences
# wq and wk of the kernel_long blocks: scores of std about LONG_QK_SCALE^2 / 3
# = 2.5 (at 1, about 0.33: a near-uniform softmax, whose output hides a
# dropped key block under the bf16 limit).
LONG_QK_SCALE = 2.75
LONG_WRAPPERS = {"fused_block_long_qkv_fwd": fb.long_qkv_fwd,
                 "fused_block_long_attn_fwd": fb.long_attn_fwd}
LONG_ENTRIES = {"fused_block_long_qkv_fwd": "tante_block_long_qkv_sm90{}_fwd",
                "fused_block_long_attn_fwd": "tante_block_long_attn_sm90{}_fwd"}
# The tensor-parallel attention half at L > 64 (attn_half_apply sends it to
# attn_half_long): its two kernels.
HALF_LONG_SOURCE = "tante_tpu_torch/ops/csrc/fused_half_long_sm90.cu"
HALF_LONG_WRAPPERS = {"attn_half_long_qkv_fwd": fb.half_long_qkv_fwd,
                      "attn_half_long_attn_fwd": fb.half_long_attn_fwd}
HALF_LONG_ENTRIES = {"attn_half_long_qkv_fwd": "tante_attn_half_long_qkv_sm90{}_fwd",
                     "attn_half_long_attn_fwd": "tante_attn_half_long_attn_sm90{}_fwd"}

FAILURES: list[str] = []
NOTES: list[str] = []
T0 = time.perf_counter()  # the script's start: each phase line says when it ended


def emit(obj: dict):
    print(json.dumps({**obj, "t_s": time.perf_counter() - T0}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        FAILURES.append(what)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def metadata() -> TanteMetadata:
    return TanteMetadata(
        dataset_name="bench", n_spatial_dims=2, spatial_resolution=RES,
        field_names={0: ["f"] * FIELDS, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
        n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[32], n_fields=FIELDS,
    )


def flagship(deg: bool, dtype, device, md=None, **kw) -> TANTE:
    return TANTE(in_T=IN_T, dset_metadata=md or metadata(), taylor_order=1,
                 attn_axes="THWTHWTHW", embed_dim=C, patch_scale=8, n_head=HEADS, mlp_ratio=1.0,
                 output_length=1, deg=deg, dtype=dtype, device=device, **kw)


def set_fusion(model: TANTE, fused_chain: int = 0, fused_group: bool = False):
    """Switch the backbones' opt-in chain / group fusion (constructor
    fields of ``AttnBackbone``; ``TANTE(fused_chain=...)`` sets the first)."""
    for m in model.modules():
        if isinstance(m, AttnBackbone):
            m.fused_chain, m.fused_group = fused_chain, fused_group


BLOCK_WRAPPERS = {"fused_block_fwd": fb.fused_block_apply,
                  "fused_block_canon_t_fwd": fb.fused_block_canon_t,
                  "fused_chain_apply": fb.fused_chain_apply,
                  "fused_group_apply": fb.fused_group_apply}


def launch_counts(dtype: torch.dtype = torch.bfloat16) -> dict:
    """Launches of the block kernels' wrappers since the last reset, in
    ``dtype`` (each wrapper counts its launches by activation dtype)."""
    return {name: fn.launches[dtype] for name, fn in BLOCK_WRAPPERS.items()}


def other_launches(dtype: torch.dtype) -> int:
    """The block wrappers' launches since the last reset in any dtype but
    ``dtype``."""
    return sum(n for fn in BLOCK_WRAPPERS.values() for dt, n in fn.launches.items()
               if dt != dtype)


def long_counts(dtype: torch.dtype) -> dict:
    """Launches of the long entry's two kernels since the last reset, in
    ``dtype``."""
    return {name: fn.launches[dtype] for name, fn in LONG_WRAPPERS.items()}


def half_long_counts(dtype: torch.dtype) -> dict:
    """Launches of the long attention half's two kernels since the last
    reset, in ``dtype``."""
    return {name: fn.launches[dtype] for name, fn in HALF_LONG_WRAPPERS.items()}


def reset_counts():
    """Every wrapper's launch count to 0."""
    fb.reset_launches()
    fs.spectral_mode_matmul.launches = 0
    fa.packed_attention.launches = 0
    fa.packed_attention.copies = 0


def wave_input(batch=BATCH, t0: int = 0, n_frames: int = IN_T, seed: int = 7) -> np.ndarray:
    """``bench.py:_wave_input``: the synthetic-waves fields (4-field
    turbulent-radiative-layer schema) the trained asset was trained on."""
    h, w = RES
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0, 2 * np.pi, h, endpoint=False),
                         np.linspace(0, 2 * np.pi, w, endpoint=False), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, size=(batch, 1, 1, 1)).astype(np.float32)
    speed = rng.uniform(0.1, 0.3, size=(batch, 1, 1, 1)).astype(np.float32)
    t = (t0 + np.arange(n_frames, dtype=np.float32)).reshape(1, n_frames, 1, 1)

    def wave(kx, ky, amp=1.0):
        return amp * np.sin(kx * gx + ky * gy + phase + speed * t).astype(np.float32)

    k1, k2 = (1, 2), (3, 1)
    return np.stack([wave(*k1) + 0.5 * wave(*k2), wave(*k2) + 0.25 * wave(*k1), wave(*k1),
                     wave(k1[1], k1[0], amp=0.7)], axis=-1)


def vrmse(x: torch.Tensor, y: torch.Tensor) -> float:
    return float(VRMSE()(x, y).mean())


def l2re(x: torch.Tensor, y: torch.Tensor) -> float:
    return float(L2RE()(x, y).mean())


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# ---------------------------------------------------------------------------


def phase_build() -> dict:
    t0 = time.perf_counter()
    info = _build.build()  # one nvcc per source, started together
    seconds = time.perf_counter() - t0
    for kernel in info:
        _build.load(kernel)
    plans = {f"L={l}": {"block_sm90 (block, canonical T, chain)": fb.sm90_plan(l, C, C)._asdict(),
                        "block_sm90 f32": f32_plan(l),
                        "half_sm90 attention half, tp 2":
                            fb.half_plan("attn", l, C, C // 2)._asdict(),
                        "half_sm90 f32 attention half, tp 2": half_f32_plan("attn", l),
                        "fused_block (first design)": _build.plan(l, C, C)}
             for l in (4, 16, AM_L, 48)}
    for axis, (_, l, c) in LONG_CASES.items():
        plans[f"long_sm90 {axis} (L={l}, C={c})"] = {
            str(dt).replace("torch.", ""): {
                **fb.long_plan(c, c, HEADS, dt)._asdict(),
                "smem_bytes_qkv_attn": fb.long_smem(fb.long_plan(c, c, HEADS, dt), c, c, dt)}
            for dt in (torch.bfloat16, torch.float32)}
    for axis, (_, l, c) in LONG_CASES.items():
        plans[f"half_long_sm90 {axis} (L={l}, C={c}), tp 2"] = {
            str(dt).replace("torch.", ""): {
                **fb.half_long_plan(c, c // 2, HEADS // 2, dt)._asdict(),
                "smem_bytes_qkv_attn": fb.half_long_smem(
                    fb.half_long_plan(c, c // 2, HEADS // 2, dt), c, dt)}
            for dt in (torch.bfloat16, torch.float32)}
    plans["half_sm90 MLP half, tp 2"] = fb.half_plan("mlp", 1, C, C // 2)._asdict()
    plans["half_sm90 f32 MLP half, tp 2"] = half_f32_plan("mlp", 1)
    emit({"phase": "build", "seconds": seconds, "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          "libraries": {k: {"seconds": v["seconds"], "cached": v["cached"], "ptxas": v["ptxas"]}
                        for k, v in info.items()},
          "tile_plans": plans,
          "chain_argument_bytes": _build.load("fused_chain_sm90").tante_chain_sm90_args_bytes()})
    return info


def f32_plan(l: int) -> dict:
    plan = fb.sm90_plan(l, C, C, torch.float32)
    return {**plan._asdict(), "smem_bytes": fb.sm90_smem(plan.rows, C, C, plan.np, plan.stages,
                                                         torch.float32)}


def half_f32_plan(kind: str, l: int) -> dict:
    plan = fb.half_plan(kind, l, C, C // 2, torch.float32)
    return {**plan._asdict(), "smem_bytes": fb.half_smem(
        kind == "attn", plan.rows, C, plan.width, plan.np, plan.stages, torch.float32)}


def block_params(seed: int, device, dtype=torch.bfloat16, c: int = C,
                 qk_scale: float = 1.0) -> fb.BlockParams:
    """One block's weights, uniform in +-1/sqrt(fan in); wq and wk
    ``qk_scale`` times that."""
    rng = np.random.default_rng(seed)

    def u(*shape, fan_in=None, scale=1.0, offset=0.0):
        bound = 1.0 / math.sqrt(fan_in or shape[0])
        a = offset + scale * rng.uniform(-bound, bound, size=shape)
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    return fb.BlockParams(
        ln1_scale=u(c, scale=0.1, offset=1.0), ln1_bias=u(c, scale=0.1),
        wq=u(c, c, scale=qk_scale), bq=u(c), wk=u(c, c, scale=qk_scale), bk=u(c), wv=u(c, c),
        bv=u(c), wo=u(c, c), bo=u(c), ln2_scale=u(c, scale=0.1, offset=1.0),
        ln2_bias=u(c, scale=0.1), w1=u(c, c), b1=u(c), w2=u(c, c), b2=u(c),
    )


def bound(rows: int, blocks: list) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, flops, bytes) for one launch that runs
    ``blocks`` = [(L, causal, params), ...] back to back on ``rows`` tokens.
    Per block: matmuls 2*M*(4C^2 + 2C*hidden) plus attention 4*C per (query,
    key) pair its mask admits.  Bytes: x in + y out + every weight once (a
    chain's activations between blocks need not leave the 50 MB L2)."""
    flops, nbytes = 0.0, 2 * rows * C * 2
    for l, causal, p in blocks:
        pairs = rows * (l + 1) / 2 if causal else rows * l
        flops += 2 * rows * (4 * C * C + 2 * C * p.w1.shape[-1]) + 4 * C * pairs
        nbytes += sum(t.numel() * t.element_size() for t in p)
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def bound_f32(rows: int, blocks: list) -> tuple[float, str, float, float]:
    """``bound`` for f32 blocks: f32-accurate products take at least three
    TF32 tensor-core products each (3xTF32) at the TF32 rate; bytes: f32 x
    in and y out, every f32 weight once."""
    _, _, flops, nbytes = bound(rows, blocks)
    nbytes += 2 * rows * C * 2  # the activations' second two bytes
    t_ops, t_mem = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def f32_agree(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, dict]:
    """An f32 kernel's output against its plain version: finite, relative L2
    <= F32_REL_L2_TOL and max abs <= F32_MAX_ABS_SHARE * max |plain|."""
    err = float((got - want).abs().max())
    peak = float(want.abs().max())
    rel = rel_l2(got, want)
    ok = (bool(torch.isfinite(got).all()) and rel <= F32_REL_L2_TOL
          and err <= F32_MAX_ABS_SHARE * peak)
    return ok, {"rel_l2": rel, "max_abs_err": err, "max_abs_plain": peak,
                "tolerance": f"rel L2 <= {F32_REL_L2_TOL}, max abs <= {F32_MAX_ABS_SHARE} * "
                             "max |plain|"}


# (wrapper, label, shape, causal, softmax).  "T rearranged": the causal T
# block as (B*H*W, T, C) rows, where it runs under "safe" (the canonical T
# kernel has no safe form).  The W causal and safe cases are checks only.
KERNEL_CASES = [
    ("fused_block_fwd", "H", (1536, 16, C), False, "fast"),
    ("fused_block_fwd", "W", (512, 48, C), False, "fast"),
    ("fused_block_fwd", "W causal", (512, 48, C), True, "fast"),
    ("fused_block_fwd", "T rearranged", (BATCH * 16 * 48, IN_T, C), True, "fast"),
    ("fused_block_fwd", "H safe", (1536, 16, C), False, "safe"),
    ("fused_block_fwd", "W safe", (512, 48, C), False, "safe"),
    ("fused_block_fwd", "T rearranged safe", (BATCH * 16 * 48, IN_T, C), True, "safe"),
    ("fused_block_canon_t_fwd", "T", (BATCH, IN_T, 16, 48, C), True, "fast"),
]
MAIN_BLOCK_CASES = ("H", "W")  # the fused_block_fwd headline: the H and W blocks


def in_turns(kernel, before, iters: int) -> dict:
    """Mean ms of ``kernel`` and of ``before`` (the first design's body on
    the same inputs), timed in turns: kernel, before, before, kernel."""
    k1, b1 = cuda_ms(kernel, iters=iters), cuda_ms(before, iters=iters)
    b2, k2 = cuda_ms(before, iters=iters), cuda_ms(kernel, iters=iters)
    return {"kernel_ms": (k1 + k2) / 2, "first_design_ms": (b1 + b2) / 2,
            "kernel_ms_turns": [k1, k2], "first_design_ms_turns": [b1, b2]}


def rearranged_t(x5: torch.Tensor, p: fb.BlockParams) -> torch.Tensor:
    """The causal T block as rearrange + ``fused_block_fwd`` + rearrange."""
    b, t, h, w, c = x5.shape
    y = fb.fused_block_apply(to_t_order(x5), p, t, HEADS, True)
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4).contiguous()


def phase_kernels(dev) -> dict[str, list[dict]]:
    """Each block kernel against its plain version.  At H and W the Hopper
    kernel is also timed in turns with the first design's tile body on the
    same block (a one-block run of ``block_tile_chain``: ``block_tile``
    under the chain's row maps), kernel, body, body, kernel; the canonical T
    kernel likewise against ``block_tile_canon_t``, and against rearrange +
    ``fused_block_fwd`` + rearrange, which it must equal bit for bit."""
    results: dict[str, list[dict]] = {}
    for i, (name, label, shape, causal, softmax) in enumerate(KERNEL_CASES):
        p = block_params(100 + i, dev)
        pf = fb.BlockParams(*(t.float() for t in p))
        x = torch.from_numpy(np.random.default_rng(i).normal(size=shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        fb.set_block_tuning(softmax=softmax)
        if name == "fused_block_fwd":
            s, l, _ = shape
            run = lambda: fb.fused_block_apply(x, p, l, HEADS, causal)  # noqa: E731
            plain = lambda: fb.block_ref(x.float(), pf, l, HEADS, causal)  # noqa: E731
        else:
            l = shape[1]
            run = lambda: fb.fused_block_canon_t(x, p, HEADS)  # noqa: E731
            plain = lambda: fb.canon_t_ref(x.float(), pf, HEADS)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= ATOL + RTOL * want.abs()).all())
        check(ok, f"kernel {name} {label} disagrees with its plain version")
        rows = x.numel() // C
        b_ms, b_by, flops, nbytes = bound(rows, [(l, causal, p)])
        res = {"phase": "kernel", "name": name, "case": label, "shape": list(shape),
               "causal": causal, "softmax": softmax, "max_abs_err": float(err.max()),
               "tolerance": f"|k - plain| <= {ATOL} + {RTOL}*|plain|", "ok": ok,
               "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
        if name == "fused_block_canon_t_fwd":
            bit_equal = bool(torch.equal(got, rearranged_t(x, p)))
            check(bit_equal, "fused_block_canon_t_fwd differs from fused_block_fwd on the "
                             "rearranged tensor")
            res["ok"] = ok and bit_equal
            res["equals_rearranged_fused_block_fwd_bit_for_bit"] = bit_equal
        if softmax == "fast":
            if label in MAIN_BLOCK_CASES:
                body = lambda: fb.block_tile_chain(  # noqa: E731
                    x, [p], label, HEADS, (IN_T, 16, 48), fb._ORDER[label], fb._ORDER[label])
                res.update(in_turns(run, body, 50))
                res["first_design"] = "block_tile_chain, one block (block_tile)"
            elif name == "fused_block_canon_t_fwd":
                res.update(in_turns(run, lambda: fb.block_tile_canon_t(x, p, HEADS), 50))
                res["first_design"] = "block_tile_canon_t (block_tile)"
                res["rearranged_fused_block_fwd_ms"] = cuda_ms(lambda: rearranged_t(x, p), 50)
            else:
                res["kernel_ms"] = cuda_ms(run, iters=50)
            res.update({"plain_ms": cuda_ms(plain, iters=10, warmup=1),
                        "achieved_tflops": flops / res["kernel_ms"] / 1e9})
        emit(res)
        results.setdefault(name, []).append(res)
    fb.set_block_tuning(softmax="fast")
    return results


def sequential(x5: torch.Tensor, ps: list, axes: str) -> torch.Tensor:
    """The single-block kernels applied one after the other, as the
    per-block backbone path does."""
    b, t, h, w, c = x5.shape
    x = x5
    for axis, p in zip(axes, ps):
        if axis == "T":
            x = fb.fused_block_canon_t(x.contiguous(), p, HEADS)
        elif axis == "H":
            y = x.permute(0, 1, 3, 2, 4).reshape(b * t * w, h, c).contiguous()
            x = fb.fused_block_apply(y, p, h, HEADS, False).reshape(b, t, w, h, c)
            x = x.permute(0, 1, 3, 2, 4)
        else:
            y = fb.fused_block_apply(x.reshape(b * t * h, w, c).contiguous(), p, w, HEADS, False)
            x = y.reshape(b, t, h, w, c)
    return x.contiguous()


def to_t_order(x5: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*H*W, T, C): the T axis's token order."""
    return x5.permute(0, 2, 3, 1, 4).reshape(-1, x5.shape[1], x5.shape[-1]).contiguous()


def f32_params(p: fb.BlockParams) -> fb.BlockParams:
    return fb.BlockParams(*(t.float() for t in p))


def phase_chain_kernels(dev) -> dict[str, dict]:
    """The chain kernel through both wrappers at the flagship geometry: bit
    for bit against the single-block kernels in sequence, and timed in turns
    with the first design's chain entry on the same inputs."""
    shape = (BATCH, IN_T, 16, 48, C)
    dims, sizes = shape[1:4], dict(zip("THW", shape[1:4]))
    x5 = torch.from_numpy(np.random.default_rng(20).normal(size=shape).astype(np.float32))
    x5 = x5.to(dev, torch.bfloat16)
    x3 = to_t_order(x5)
    results = {}
    for name, axes in (("fused_chain_apply", "THW"), ("fused_group_apply", "THWTHWTHW")):
        ps = [block_params(200 + i, dev) for i in range(len(axes))]
        pf = [f32_params(p) for p in ps]
        if name == "fused_chain_apply":
            run = lambda: fb.fused_chain_apply(x3, ps, axes, HEADS, dims)  # noqa: E731
            before = lambda: fb.block_tile_chain(  # noqa: E731
                x3, ps, axes, HEADS, dims, fb._ORDER[axes[0]], fb._ORDER[axes[-1]])
            # Chain contract: T order in, W order (= canonical) out.
            as5 = lambda y: y.reshape(shape)  # noqa: E731
            plain = lambda: fb.chain_ref(x3.float(), pf, axes, HEADS, dims)  # noqa: E731
        else:
            run = lambda: fb.fused_group_apply(x5, ps, axes, HEADS)  # noqa: E731
            before = lambda: fb.block_tile_chain(x5, ps, axes, HEADS, dims)  # noqa: E731
            as5 = lambda y: y  # noqa: E731
            plain = lambda: fb.group_ref(x5.float(), pf, axes, HEADS)  # noqa: E731
        got = as5(run())
        torch.cuda.synchronize()
        want = as5(plain())
        err = (got.float() - want).abs()
        atol = CHAIN_ATOL[len(axes)]
        close = bool(torch.isfinite(got).all()) and bool((err <= atol + RTOL * want.abs()).all())
        seq = sequential(x5, ps, axes)
        bit_equal = bool(torch.equal(got, seq))
        before_err = float((as5(before()).float() - want).abs().max())
        check(close, f"{name} {axes} disagrees with its plain version")
        check(bit_equal, f"{name} {axes} differs from the single-block kernels in sequence")
        rows = x5.numel() // C
        b_ms, b_by, flops, nbytes = bound(rows, [(sizes[a], a == "T", p) for a, p in zip(axes, ps)])
        turns = in_turns(run, before, 20)
        seq_ms = cuda_ms(lambda: sequential(x5, ps, axes), iters=20)
        p_ms = cuda_ms(plain, iters=3, warmup=1)
        res = {"phase": "kernel", "name": "fused_chain_fwd", "wrapper": name, "case": axes,
               "shape": list(shape), "max_abs_err": float(err.max()),
               "tolerance": f"|k - plain| <= {atol} + {RTOL}*|plain|", "ok": close and bit_equal,
               "equals_single_block_kernels_in_sequence_bit_for_bit": bit_equal, **turns,
               "first_design": "block_tile_chain (block_tile, cooperative)",
               "first_design_max_abs_err": before_err,
               "single_block_kernels_in_sequence_ms": seq_ms, "plain_ms": p_ms,
               "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
               "achieved_tflops": flops / turns["kernel_ms"] / 1e9}
        emit(res)
        results[name] = res
    return results


def phase_grad(dev, dtype=torch.bfloat16) -> dict:
    """Gradients of sum(y**2) w.r.t. x and all 16 parameters per block
    through each autograd Function (bf16 or f32, kernel forward, plain
    recompute backward) against ordinary autograd through the f32 plain
    version."""
    f32 = dtype == torch.float32
    shape5 = (BATCH, IN_T, 16, 48, C)
    dims = shape5[1:4]
    cases = [
        ("fused_block_fwd", (1536, 16, C), "H",
         lambda x, ps: fb.fused_block_apply(x, ps[0], 16, HEADS, False),
         lambda x, ps: fb.block_ref(x, ps[0], 16, HEADS, False)),
        ("fused_block_canon_t_fwd", shape5, "T",
         lambda x, ps: fb.fused_block_canon_t(x, ps[0], HEADS),
         lambda x, ps: fb.canon_t_ref(x, ps[0], HEADS)),
        ("fused_chain_fwd", (BATCH * 16 * 48, IN_T, C), "THW",
         lambda x, ps: fb.fused_chain_apply(x, ps, "THW", HEADS, dims),
         lambda x, ps: fb.chain_ref(x, ps, "THW", HEADS, dims)),
    ]

    def grads(fn, x, ps):
        x = x.detach().requires_grad_(True)
        ps = [fb.BlockParams(*(t.detach().requires_grad_(True) for t in p)) for p in ps]
        (fn(x, ps).float() ** 2).sum().backward()
        return [x.grad] + [t.grad for p in ps for t in p]

    out = {}
    tol = F32_GRAD_REL_TOL if f32 else GRAD_REL_TOL
    for i, (name, shape, axes, kernel, plain) in enumerate(cases):
        ps = [block_params(300 + 10 * i + k, dev, dtype) for k in range(len(axes))]
        x = torch.from_numpy(np.random.default_rng(30 + i).normal(size=shape).astype(np.float32))
        x = x.to(dev, dtype)
        reset_counts()
        got = grads(kernel, x, ps)
        torch.cuda.synchronize()
        forward_launches = sum(launch_counts(dtype).values())
        want = grads(plain, x.float(), [f32_params(p) for p in ps])
        names = ["x"] + [f"{f}[{k}]" for k in range(len(ps)) for f in fb.BlockParams._fields]
        ref = dict(zip(names, want))
        # bk: a key bias shifts every score of a query alike, softmax ignores
        # it, the true gradient is 0; its rounding noise is held to bq's scale.
        errs = {n: float(torch.linalg.norm(g.float() - w)
                         / torch.linalg.norm(ref[n.replace("bk[", "bq[")]))
                for n, g, w in zip(names, got, want)}
        worst = max(errs, key=errs.get)
        ok = forward_launches == 1 and errs[worst] <= tol
        check(ok, f"grad {name} {dtype}: worst {worst} rel L2 {errs[worst]}, "
                  f"{forward_launches} launches in forward + backward")
        out[name] = {"shape": list(shape), "axes": axes, "worst_tensor": worst,
                     "worst_rel_l2": errs[worst], "x_rel_l2": errs["x"],
                     "launches_forward_and_backward": forward_launches, "ok": ok}
    res = {"phase": "grad_f32" if f32 else "grad", "loss": "sum(y**2)",
           "dtype": f"{'f32' if f32 else 'bf16'} vs f32 plain autograd",
           "rel_l2_tolerance": tol, "kernels": out}
    emit(res)
    return res


# The f32 kernels at the slice's shapes: the H and W blocks and the
# active_matter geometry (configs/tante.yaml, L 32), the rearranged causal T
# block, in both softmax forms; the canonical T kernel.
F32_KERNEL_CASES = [
    ("fused_block_fwd", "H", (1536, 16, C), False, "fast"),
    ("fused_block_fwd", "W", (512, 48, C), False, "fast"),
    ("fused_block_fwd", "active_matter", (BATCH * IN_T * AM_L, AM_L, C), False, "fast"),
    ("fused_block_fwd", "T rearranged", (BATCH * 16 * 48, IN_T, C), True, "fast"),
    ("fused_block_fwd", "H safe", (1536, 16, C), False, "safe"),
    ("fused_block_fwd", "W safe", (512, 48, C), False, "safe"),
    ("fused_block_fwd", "active_matter safe", (BATCH * IN_T * AM_L, AM_L, C), False, "safe"),
    ("fused_block_fwd", "T rearranged safe", (BATCH * 16 * 48, IN_T, C), True, "safe"),
    ("fused_block_canon_t_fwd", "T", (BATCH, IN_T, 16, 48, C), True, "fast"),
]
F32_ENTRIES = {"fused_block_fwd": "tante_fused_block_sm90_f32_fwd",
               "fused_block_canon_t_fwd": "tante_fused_block_canon_t_sm90_f32_fwd",
               "fused_chain_fwd": "tante_fused_chain_sm90_f32_fwd",
               "attn_half_fwd": "tante_attn_half_sm90_f32_fwd",
               "mlp_half_fwd": "tante_mlp_half_sm90_f32_fwd"}


def phase_kernels_f32(dev) -> dict[str, list[dict]]:
    """Each f32 block kernel against its f32 plain version on the same f32
    inputs (TF32 off): relative L2 and max abs error, kernel and plain time
    (CUDA events), the bound; the canonical T kernel also bit for bit
    against ``fused_block_fwd`` in f32 on the rearranged tensor."""
    results: dict[str, list[dict]] = {}
    for i, (name, label, shape, causal, softmax) in enumerate(F32_KERNEL_CASES):
        p = block_params(400 + i, dev, torch.float32)
        x = torch.from_numpy(np.random.default_rng(40 + i).normal(size=shape).astype(np.float32))
        x = x.to(dev)
        fb.set_block_tuning(softmax=softmax)
        l = shape[1]
        if name == "fused_block_fwd":
            run = lambda: fb.fused_block_apply(x, p, l, HEADS, causal)  # noqa: E731
            plain = lambda: fb.block_ref(x, p, l, HEADS, causal)  # noqa: E731
        else:
            run = lambda: fb.fused_block_canon_t(x, p, HEADS)  # noqa: E731
            plain = lambda: fb.canon_t_ref(x, p, HEADS)  # noqa: E731
        reset_counts()
        got = run()
        torch.cuda.synchronize()
        launched = (launch_counts(torch.float32)[name] == 1
                    and not other_launches(torch.float32))
        check(launched, f"f32 {name} {label}: not one launch of its f32 kernel")
        ok, agree = f32_agree(got, plain())
        check(ok, f"f32 kernel {name} {label} disagrees with its plain version: {agree}")
        b_ms, b_by, flops, nbytes = bound_f32(x.numel() // C, [(l, causal, p)])
        res = {"phase": "kernel_f32", "name": name, "entry": F32_ENTRIES[name], "case": label,
               "shape": list(shape), "causal": causal, "softmax": softmax, **agree,
               "ok": ok and launched, "bound_us": 1e3 * b_ms, "bound_by": b_by,
               "ffma_bound_us": 1e6 * flops / PEAK_F32_FLOPS, "flops": flops, "bytes": nbytes}
        if name == "fused_block_canon_t_fwd":
            bit_equal = bool(torch.equal(got, rearranged_t(x, p)))
            check(bit_equal, "f32 fused_block_canon_t_fwd differs from f32 fused_block_fwd on "
                             "the rearranged tensor")
            res["ok"] = res["ok"] and bit_equal
            res["equals_rearranged_fused_block_fwd_bit_for_bit"] = bit_equal
        res["kernel_ms"] = cuda_ms(run, iters=20)
        res["plain_ms"] = cuda_ms(plain, iters=5, warmup=1)
        res["achieved_tflops"] = flops / res["kernel_ms"] / 1e9
        emit(res)
        results.setdefault(name, []).append(res)
    fb.set_block_tuning(softmax="fast")
    return results


def phase_chain_kernels_f32(dev) -> dict[str, dict]:
    """The f32 chain kernel through both wrappers at the flagship geometry:
    against the f32 plain chain, and bit for bit against the f32
    single-block kernels in sequence."""
    shape = (BATCH, IN_T, 16, 48, C)
    dims, sizes = shape[1:4], dict(zip("THW", shape[1:4]))
    x5 = torch.from_numpy(np.random.default_rng(21).normal(size=shape).astype(np.float32)).to(dev)
    x3 = to_t_order(x5)
    results = {}
    for name, axes in (("fused_chain_apply", "THW"), ("fused_group_apply", "THWTHWTHW")):
        ps = [block_params(500 + i, dev, torch.float32) for i in range(len(axes))]
        if name == "fused_chain_apply":
            run = lambda: fb.fused_chain_apply(x3, ps, axes, HEADS, dims)  # noqa: E731
            as5 = lambda y: y.reshape(shape)  # noqa: E731
            plain = lambda: fb.chain_ref(x3, ps, axes, HEADS, dims)  # noqa: E731
        else:
            run = lambda: fb.fused_group_apply(x5, ps, axes, HEADS)  # noqa: E731
            as5 = lambda y: y  # noqa: E731
            plain = lambda: fb.group_ref(x5, ps, axes, HEADS)  # noqa: E731
        reset_counts()
        got = as5(run())
        torch.cuda.synchronize()
        launched = (launch_counts(torch.float32)[name] == 1
                    and not other_launches(torch.float32))
        ok, agree = f32_agree(got, as5(plain()))
        bit_equal = bool(torch.equal(got, sequential(x5, ps, axes)))
        check(launched, f"f32 {name} {axes}: not one launch of its f32 kernel")
        check(ok, f"f32 {name} {axes} disagrees with its plain version: {agree}")
        check(bit_equal, f"f32 {name} {axes} differs from the f32 single-block kernels in "
                         "sequence")
        b_ms, b_by, flops, nbytes = bound_f32(
            x5.numel() // C, [(sizes[a], a == "T", p) for a, p in zip(axes, ps)])
        k_ms = cuda_ms(run, iters=10)
        res = {"phase": "kernel_f32", "name": "fused_chain_fwd", "entry": F32_ENTRIES[
                   "fused_chain_fwd"], "wrapper": name, "case": axes, "shape": list(shape),
               **agree, "ok": ok and bit_equal and launched,
               "equals_single_block_kernels_in_sequence_bit_for_bit": bit_equal,
               "kernel_ms": k_ms,
               "single_block_kernels_in_sequence_ms": cuda_ms(
                   lambda: sequential(x5, ps, axes), iters=10),
               "plain_ms": cuda_ms(plain, iters=3, warmup=1), "bound_us": 1e3 * b_ms,
               "bound_by": b_by, "ffma_bound_us": 1e6 * flops / PEAK_F32_FLOPS, "flops": flops,
               "bytes": nbytes, "achieved_tflops": flops / k_ms / 1e9}
        emit(res)
        results[name] = res
    return results


def long_bounds(rows: int, l: int, c: int, hidden: int, causal: bool, dtype) -> dict:
    """The least time of the long block on these inputs, whole and per entry:
    operations (projections 2*M*(4c^2 + 2c*hidden), attention 4*c per admitted
    (query, key) pair) at the dtype's tensor-core rate (f32: three TF32
    products a product, 3xTF32), bytes (each input read once, each output
    written once) at the memory rate; the larger of the two.  The qkv entry
    reads x and its weights and writes the workspace (3 values a token and
    channel); the attention entry reads x, the workspace and its weights and
    writes y; the block as a whole reads x and all weights and writes y."""
    e = 4 if dtype == torch.float32 else 2
    m = rows * l
    pairs = rows * l * (l + 1) / 2 if causal else rows * l * l
    w_qkv = (3 * c * c + 3 * c + 2 * c) * e
    w_tail = (c * c + 2 * c * hidden + 4 * c + hidden) * e
    parts = {"qkv": (2 * m * 3 * c * c, 4 * m * c * e + w_qkv),
             "attn": (2 * m * (c * c + 2 * c * hidden) + 4 * c * pairs, 5 * m * c * e + w_tail),
             "block": (2 * m * (4 * c * c + 2 * c * hidden) + 4 * c * pairs,
                       2 * m * c * e + w_qkv + w_tail)}
    out = {}
    for k, (flops, nbytes) in parts.items():
        t_ops = (3 * flops / PEAK_TF32_FLOPS if e == 4 else flops / PEAK_BF16_FLOPS)
        t_mem = nbytes / PEAK_HBM_BYTES
        out[k] = {"bound_us": 1e6 * max(t_ops, t_mem),
                  "bound_by": "operations" if t_ops >= t_mem else "bytes",
                  "flops": flops, "bytes": nbytes}
    return out


QKV_GUARD = 4096  # elements past a qkv kernel's workspace that must stay NaN


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(v.float()), e - 8)


def qkv_operands(p, heads: int, width: int) -> tuple:
    """The q|k|v weights and biases of a block's or a tp shard's ``p`` as its
    qkv kernel reads them (``fb.qkv_groups``): wq, bq times d^-0.5 log2 e
    (a bf16 product rounded once), zero columns past a shard up to
    ``width``."""
    ca = p.wq.shape[-1]
    qs = (ca // heads) ** -0.5 * fb.LOG2E

    def pad(t):
        return torch.nn.functional.pad(t, (0, width - ca))

    return (tuple(pad(t) for t in (p.wq * qs, p.wk, p.wv)),
            tuple(pad(t) for t in (p.bq * qs, p.bk, p.bv)))


def qkv_reference(x, ln_s, ln_b, ws_qkv, bs_qkv, width: int, mm=None):
    """The workspace (3, S, width/64, L, 64) of a qkv kernel's order of work
    (``tests/test_torch_long_block.py:long_qkv``: LN1 with one-pass moments,
    rounded to x's dtype, then each product + bias) on x's sequences, before
    its last rounding, and (bf16) the bound of what that order leaves open;
    ws_qkv / bs_qkv from ``qkv_operands``.  bf16: float64 products of the
    rounded LN1 output; the bound is the f32 sums' order over K = C terms
    (C 2^-24 |xn| |w|) plus one ulp of each LN1 output that lies within
    2^-16 of a bf16 rounding boundary (the kernel's f32 moments may round it
    the other way).  f32: ``mm`` (default: f32 matmul) of the f32 LN1
    output, no bound (the long block's f32 limits apply)."""
    s, l, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    xf = x.double() if bf16 else x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    xn = (xf - mu) * torch.rsqrt(var + 1e-5) * ln_s.to(xf.dtype) + ln_b.to(xf.dtype)
    parts, bounds = [], []
    if bf16:
        xr = xn.to(torch.bfloat16).double()
        lo, hi = (xn * (1 - 2.0**-16)).to(torch.bfloat16), (xn * (1 + 2.0**-16)).to(torch.bfloat16)
        amb = (lo != hi).double() * bf16_ulp(xn).double()
    for w, b in zip(ws_qkv, bs_qkv):
        if bf16:
            wd = w.double()
            parts.append(xr @ wd + b.double())
            bounds.append(c * 2.0**-24 * (xr.abs() @ wd.abs()) + amb @ wd.abs())
        else:
            parts.append(((mm or torch.matmul)(xn, w.float()) + b.float()).double())
    g = width // 64

    def lay(t):
        return t.reshape(s, l, g, 64).permute(0, 2, 1, 3)

    return (torch.stack([lay(t) for t in parts]),
            torch.stack([lay(t) for t in bounds]) if bf16 else None)


def qkv_launch(entry, x, w, plan, s: int, l: int, c: int, width_arg: int, ws_shape) -> tuple:
    """One launch of a qkv kernel's C entry (the block's or the half's) into
    a NaN-filled buffer: the workspace view and the QKV_GUARD elements past
    it.  width_arg: the block's hidden width, or the shard's."""
    buf = torch.full((math.prod(ws_shape) + QKV_GUARD,), float("nan"), dtype=x.dtype,
                     device=x.device)
    ws = buf[:-QKV_GUARD].view(ws_shape)
    rc = entry(x.data_ptr(), ws.data_ptr(), fb._ptr_array([w]), fb._ints(plan), s, l, c,
               width_arg, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qkv kernel launch failed with cudaError {rc}")
    torch.cuda.synchronize()
    return ws, buf[-QKV_GUARD:]


def qkv_agree(ws, guard, ref, bound, n: int) -> tuple[bool, dict]:
    """A qkv workspace against ``qkv_reference`` on its first n sequences:
    every element written (finite) and the guard past it untouched (NaN);
    bf16 within one bf16 ulp of the reference plus its bound, f32 as
    ``f32_agree``."""
    written = bool(torch.isfinite(ws).all()) and bool(torch.isnan(guard).all())
    got = ws[:, :n].double()
    if bound is None:
        ok, agree = f32_agree(got.float(), ref.float())
    else:
        err = (got - ref).abs()
        limit = bf16_ulp(ref).double() + bound
        over = float((err / limit).max())
        ok, agree = over <= 1, {"max_abs_err": float(err.max()), "max_err_over_limit": over,
                                "tolerance": "one bf16 ulp + the order's bound (qkv_reference)"}
    return ok and written, {**agree, "all_written_none_past": written}


def dropped_keys_ref(x: torch.Tensor, p: fb.BlockParams, l: int, heads: int, causal: bool,
                     keys: int) -> torch.Tensor:
    """``block_ref`` in f32 whose attention sees only the first ``keys`` keys
    of each sequence: the control of kernel_long's bf16 limit."""
    c = x.shape[-1]
    d = c // heads
    xn = fb.ln(x, p.ln1_scale, p.ln1_bias)
    q = ((xn @ p.wq) + p.bq) * d**-0.5
    k, v = (xn @ p.wk) + p.bk, (xn @ p.wv) + p.bv
    q, k, v = (t.reshape(-1, l, heads, d) for t in (q, k, v))
    logits = torch.einsum("blhd,bmhd->bhlm", q, k[:, :keys])
    if causal:
        m = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))[:, :keys]
        logits = torch.where(m, logits, torch.full_like(logits, -1e30))
    attn = torch.einsum("bhlm,bmhd->blhd", torch.softmax(logits, dim=-1), v[:, :keys])
    x = x + attn.reshape(x.shape) @ p.wo + p.bo
    h = gelu_tanh_f32((fb.ln(x, p.ln2_scale, p.ln2_bias) @ p.w1) + p.b1)
    return x + h @ p.w2 + p.b2


# (label, axis of LONG_CASES or (sequences, L, width), causal, softmax, timed):
# the flagship's L, X, A and C blocks in both softmax forms, causal at L 100,
# ragged last tiles at L 65 and 257, and L 48 through the low-level entry
# (below the single-block kernel's limit).
LONG_KERNEL_CASES = [
    *((axis, axis, False, sm, sm == "fast") for axis in "LXAC" for sm in ("fast", "safe")),
    ("causal L 100", (64, 100, C), True, "fast", False),
    ("causal L 100 safe", (64, 100, C), True, "safe", False),
    ("ragged L 65", (48, 65, C), False, "fast", False),
    ("ragged L 257", (12, 257, C), True, "fast", False),
    ("L 48, low-level entry", (64, 48, C), False, "fast", False),
]


def long_qkv_check(x: torch.Tensor, p, plan, n: int, shard: tuple | None = None) -> dict:
    """The qkv kernel of the long block (or, with ``shard`` = (local heads,
    local width), the long half's on the shard ``p``) on x into a NaN-filled
    buffer twice: both equal, every element written and none past the end,
    the first n sequences against ``qkv_reference`` (``qkv_agree``)."""
    s, l, c = x.shape
    f32 = x.dtype == torch.float32
    if shard is None:
        heads, width, arg = HEADS, c, c
        w = fb.sm90_weights(p, HEADS, plan)
        lib = fb._long_lib(x)
        entry = lib.tante_block_long_qkv_sm90_f32_fwd if f32 else lib.tante_block_long_qkv_sm90_fwd
    else:
        (heads, arg), width = shard, plan.width
        w = fb.half_long_weights(p, heads, plan)
        lib = fb._half_long_lib(x)
        entry = (lib.tante_attn_half_long_qkv_sm90_f32_fwd if f32
                 else lib.tante_attn_half_long_qkv_sm90_fwd)
    shape = (3, s, width // 64, l, 64)
    ws, guard = qkv_launch(entry, x, w, plan, s, l, c, arg, shape)
    again, _ = qkv_launch(entry, x, w, plan, s, l, c, arg, shape)
    equal = bool(torch.equal(ws, again))
    del again
    ref, bound = qkv_reference(x[:n], p.ln1_scale, p.ln1_bias, *qkv_operands(p, heads, width),
                               width)
    ok, agree = qkv_agree(ws, guard, ref, bound, n)
    del ws, guard, ref, bound
    return {**agree, "repeat_equal": equal, "ok": ok and equal, "sequences_checked": n,
            "plan": {"rows": plan.rows, "qkv_stages": plan.qkv_stages,
                     "qkv_parts": plan.qkv_parts, "resident": plan.qkv_resident,
                     "split": plan.qkv_split}}


def phase_kernels_long(dev, dtype) -> list[dict]:
    """The long entry (``fused_block_long``: the qkv kernel, then the
    attention kernel) against the plain block on the same inputs, in
    ``dtype``: bf16 against the f32 plain block from the same bf16 inputs
    (ATOL / RTOL), f32 against the f32 plain block, TF32 off
    (F32_REL_L2_TOL / F32_MAX_ABS_SHARE).  At the C shape the kernel runs on
    all 24,576 sequences and the plain block on the first 512.  The
    flagship's fast cases are timed (CUDA events): each entry alone, the
    block (both), and the plain block (at C on its 512 sequences, scaled to
    the whole tensor and labelled so), beside the bounds."""
    f32 = dtype == torch.float32
    t0 = time.perf_counter()
    out = []
    gen = torch.Generator(device=dev)
    for i, (label, shape, causal, softmax, timed) in enumerate(LONG_KERNEL_CASES):
        rows, l, c = LONG_CASES[shape] if isinstance(shape, str) else shape
        p = block_params(700 + i, dev, dtype, c, qk_scale=LONG_QK_SCALE)
        gen.manual_seed(70 + i)
        x = torch.randn((rows, l, c), generator=gen, device=dev).to(dtype)
        fb.set_block_tuning(softmax=softmax)
        reset_counts()
        got = fb.fused_block_long(x, p, l, HEADS, causal)
        torch.cuda.synchronize()
        launched = (long_counts(dtype) == {k: 1 for k in LONG_WRAPPERS}
                    and not any(fn.launches for fn in BLOCK_WRAPPERS.values()))
        check(launched, f"kernel_long {label} {dtype}: not one launch of each long entry")
        again = fb.fused_block_long(x, p, l, HEADS, causal)
        repeat_equal = bool(torch.equal(got, again))  # a race shows as unequal launches
        del again
        check(repeat_equal, f"kernel_long {label} {dtype}: two launches differ")
        n_plain = min(rows, LONG_C_PLAIN_SEQS)
        pf = f32_params(p)
        plain = lambda: fb.block_ref(x[:n_plain].float(), pf, l, HEADS, causal)  # noqa: E731
        want = plain()
        sub = got[:n_plain]
        if f32:
            ok, agree = f32_agree(sub, want)
        else:
            err = (sub.float() - want).abs()
            limit = ATOL + RTOL * want.abs()
            ok = bool(torch.isfinite(sub).all()) and bool((err <= limit).all())
            # The control: the plain block without the keys of the last key
            # block the kernel streams (at L <= 64, the second half).
            cut = fb.LONG_KEY_BLOCK * ((l - 1) // fb.LONG_KEY_BLOCK) or l // 2
            ctl = dropped_keys_ref(x[:n_plain].float(), pf, l, HEADS, causal, cut)
            agree = {"max_abs_err": float(err.max()),
                     "tolerance": f"|k - plain| <= {ATOL} + {RTOL}*|plain|",
                     "max_err_over_limit": float((err / limit).max()),
                     "control_keys_dropped": l - cut,
                     "control_max_err_over_limit": float(((ctl - want).abs() / limit).max())}
            del ctl
            if isinstance(shape, str):
                check(agree["control_max_err_over_limit"] > 1,
                      f"kernel_long {label}: the bf16 limit does not see a dropped key block")
        ok = ok and bool(torch.isfinite(got).all())
        check(ok, f"kernel_long {label} {dtype} disagrees with the plain block: {agree}")
        bounds = long_bounds(rows, l, c, c, causal, dtype)
        plan = fb.long_plan(c, c, HEADS, dtype)
        work = fb.long_attn_work(x, plan, c)
        qkv = long_qkv_check(x, p, plan, n_plain)
        check(qkv["ok"], f"kernel_long {label} {dtype}: the qkv workspace disagrees: {qkv}")
        res = {"phase": "kernel_long", "dtype": str(dtype).replace("torch.", ""), "case": label,
               "shape": [rows, l, c], "heads": HEADS, "causal": causal, "softmax": softmax,
               **agree, "ok": ok and launched and repeat_equal and qkv["ok"],
               "repeat_equal": repeat_equal, "qkv_workspace": qkv,
               "plain_sequences": n_plain, "attn_work": work,
               "attn_workspace_reads": fb.long_attn_reads(plan, rows, l, c, causal,
                                                          softmax == "safe", dtype, work["big"]),
               "bounds": bounds}
        if timed:
            w = fb.sm90_weights(p, HEADS, plan)
            ws = fb.long_qkv_fwd(x, w, plan, l)
            iters = 3 if label == "C" else 10
            res["qkv_ms"] = cuda_ms(lambda: fb.long_qkv_fwd(x, w, plan, l), iters)
            res["qkv_bound_share"] = bounds["qkv"]["bound_us"] / 1e3 / res["qkv_ms"]
            res["qkv_gb_per_s"] = bounds["qkv"]["bytes"] / res["qkv_ms"] / 1e6
            res["attn_ms"] = cuda_ms(
                lambda: fb.long_attn_fwd(x, ws, w, plan, l, HEADS, causal), iters)
            res["kernel_ms"] = cuda_ms(lambda: fb.fused_block_long(x, p, l, HEADS, causal), iters)
            del ws
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            res["plain_ms"] = plain_ms * rows / n_plain
            if n_plain < rows:
                res["plain_ms_is"] = (f"the plain block on {n_plain} sequences ({plain_ms} ms), "
                                      f"scaled by {rows}/{n_plain}")
            res["bound_share"] = bounds["block"]["bound_us"] / 1e3 / res["kernel_ms"]
            res["achieved_tflops"] = bounds["block"]["flops"] / res["kernel_ms"] / 1e9
        emit(res)
        out.append(res)
        del x, got, want, sub
        torch.cuda.empty_cache()
    fb.set_block_tuning(softmax="fast")
    emit({"phase": "kernel_long", "dtype": str(dtype).replace("torch.", ""),
          "seconds": time.perf_counter() - t0})
    return out


def trace(fn, top: int = 8, f32: bool = False) -> dict:
    """One call of ``fn`` under ``torch.profiler``: host wall time, device
    kernel time and busy share, kernel launches, and the kernels that take
    the most device time (``f32``: the block-kernel events of the f32
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "wall_ms": wall_us / 1e3, "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in kernels[:top]],
        "block_kernel_events": block_kernel_events(kernels, f32),
        "long_kernel_events": long_kernel_events(kernels, f32),
    }


# The block kernels' symbols, demangled or not: the single-block kernel's
# last template flag says whether it ran under the canonical T row map.
_BLOCK_KERNEL = {f32: re.compile(rf"fused_block_sm90{'_f32' if f32 else ''}_kernel"
                                 r"(?:<\d+, \w+, (\w+)>|ILi\d+ELb[01]ELb([01])E)")
                 for f32 in (False, True)}


def block_kernel_events(kernels, f32: bool = False) -> dict:
    """Kernel events of the Hopper block kernels (bf16, or ``f32``) in a
    profile, by wrapper."""
    out = {"fused_block_fwd": 0, "fused_block_canon_t_fwd": 0, "fused_chain_fwd": 0}
    chain = "fused_chain_sm90_f32_kernel" if f32 else "fused_chain_sm90_kernel"
    for e in kernels:
        m = _BLOCK_KERNEL[f32].search(e.key)
        if m:
            strided = (m.group(1) or m.group(2)) in ("true", "1")
            out["fused_block_canon_t_fwd" if strided else "fused_block_fwd"] += e.count
        elif chain in e.key:
            out["fused_chain_fwd"] += e.count
    return out


def long_kernel_events(kernels, f32: bool = False) -> dict:
    """Kernel events of the long entry's two kernels (bf16, or ``f32``) in a
    profile."""
    dt = "_f32" if f32 else ""
    symbols = {"fused_block_long_qkv_fwd": f"block_long_qkv{dt}_kernel",
               "fused_block_long_attn_fwd": f"block_long_attn{dt}_kernel"}
    return {name: sum(e.count for e in kernels if sym in e.key) for name, sym in symbols.items()}


def traced(fn, label: str, top: int = 8, f32: bool = False) -> dict:
    """``trace`` of one call, with its block-kernel events (bf16, or
    ``f32``) held against the wrappers' launch counts over the same call; a
    difference is reported (the profiler has dropped events before), not
    failed."""
    reset_counts()
    prof = trace(fn, top, f32)
    c = launch_counts(torch.float32 if f32 else torch.bfloat16)
    counted = {"fused_block_fwd": c["fused_block_fwd"],
               "fused_block_canon_t_fwd": c["fused_block_canon_t_fwd"],
               "fused_chain_fwd": c["fused_chain_apply"] + c["fused_group_apply"]}
    prof["launches_counted"] = counted
    prof["events_match_counts"] = prof["block_kernel_events"] == counted
    if not prof["events_match_counts"]:
        NOTES.append(f"{label}: the profiler listed {prof['block_kernel_events']} block-kernel "
                     f"events where the wrappers counted {counted} launches")
    return prof


def device_split(fn, pattern: re.Pattern | None, iters: int = 10, launches=None,
                 label: str = "") -> dict:
    """Per call of ``fn`` (``torch.profiler`` over ``iters`` calls): the
    device time of the kernels whose name matches ``pattern`` (the kernel's
    own), of all its kernels (the call's), and the kernels' names.  A time
    is the events' sum over the calls, except where ``launches`` (a callable
    reading the wrapper's launch counter) says how often the kernel ran in
    the window: a profile may list fewer events than ran (this script on an
    NVIDIA H100 80GB HBM3 at 700 W: 9 of 10), so the kernel's time is then
    its mean per event times the counted launches per call, and a window
    whose events fall more than one short of the launches is noted.  A
    profile now and then comes back without device events: it is taken
    again, and after three empty ones the CUDA-event time stands in (and
    the result line says so)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        counted = launches() if launches else 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        counted = launches() - counted if launches else None
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            own = [e for e in events if pattern and pattern.search(e.key)]
            own_events = sum(e.count for e in own)
            own_us = sum(e.self_device_time_total for e in own)
            kernel_us = own_us
            if counted is not None and own_events:
                kernel_us = own_us / own_events * counted
                if own_events < counted - 1:
                    NOTES.append(f"{label}: the profiler listed {own_events} kernel events "
                                 f"where the wrapper counted {counted} launches")
            return {"kernel_ms": kernel_us / iters / 1e3,
                    "call_ms": (total_us - own_us + kernel_us) / iters / 1e3,
                    "kernel_events": own_events, "launches_counted": counted, "calls": iters,
                    "symbols": sorted({e.key for e in own}),
                    "all_symbols": sorted({e.key for e in events})}
    NOTES.append("a device time is a CUDA-event time: three profiles held no device events")
    ms = cuda_ms(fn, iters)
    return {"kernel_ms": ms, "call_ms": ms, "kernel_events": None, "launches_counted": None,
            "calls": iters, "symbols": [], "all_symbols": []}


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: its kernels' time by ``torch.profiler``
    over ``iters`` calls (``device_split``).  For a call that is shorter on
    the card than its enqueue on the host, back-to-back CUDA events read the
    host's pace; this reads the card's."""
    return device_split(fn, None, iters)["call_ms"]


def timed_rollouts(fn, n: int = 3, windows: int = 3) -> dict:
    """Seconds per call of ``fn``: CUDA events around ``windows`` windows of
    ``n`` back-to-back calls; the median window and the spread (the host
    is shared, so single windows vary)."""
    per = sorted(cuda_ms(fn, iters=n, warmup=0) / 1e3 for _ in range(windows))
    return {"median_s": per[len(per) // 2], "min_s": per[0], "max_s": per[-1],
            "calls": n * windows}


def host_split(fn) -> dict:
    """Host time to enqueue one call of ``fn`` against its wall time to
    completion: equal values mean the host, not the card, sets the pace
    (or that the call waits on the card inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"host_enqueue_ms": 1e3 * enqueued, "host_wall_ms": 1e3 * (time.perf_counter() - t0)}


def lane_speed(tm: dict) -> dict:
    frames = BATCH * N_STEPS
    return {"ms_per_rollout": 1e3 * tm["median_s"], "frames_per_s": frames / tm["median_s"],
            "frames_per_s_range": [frames / tm["max_s"], frames / tm["min_s"]],
            "timed_rollouts": tm["calls"]}


def phase_fixed(dev) -> dict:
    model = flagship(True, torch.bfloat16, dev)
    flat = seeded_jax_params(model, seed=0)
    pred = Predictor.from_numpy(model, flat)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(BATCH, IN_T, *RES, FIELDS)).astype(np.float32)).to(dev)
    for _ in range(2):
        pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_counts()
    y = pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == {"fused_block_fwd": 96, "fused_block_canon_t_fwd": 48,
                       "fused_chain_apply": 0, "fused_group_apply": 0},
          f"fixed lane launches {launches}, want 96 + 48")
    shape_ok = tuple(y.shape) == (BATCH, N_STEPS, *RES, FIELDS)
    finite = bool(torch.isfinite(y).all())
    check(shape_ok and finite, "fixed lane output shape / finiteness")
    tm = timed_rollouts(lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16))

    prof = traced(lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16), "fixed")
    prof.update(host_split(lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)))

    # The same weights in f32 on the CPU (plain path), one sample, 2 steps:
    # relative L2 error of the predicted change from the last input frame.
    ref_model = flagship(True, torch.float32, "cpu")
    u = x[:1, -1:].cpu()
    ref = Predictor.from_numpy(ref_model, flat, device="cpu").rollout(x[:1].cpu(), 2)
    err = rel_l2(pred.rollout(x[:1], 2).cpu() - u, ref - u)
    check(err <= ROLLOUT_REL_TOL, f"fixed lane vs CPU f32: rel L2 {err}")
    cpu_f32_rollout = ref
    res = {"phase": "fixed", "batch": BATCH, "n_steps": N_STEPS, "dtype": "bf16",
           "weights": "seeded (numpy seed 0)", "output_shape": list(y.shape), "finite": finite,
           "launches_per_rollout": launches, **lane_speed(tm),
           "change_vs_cpu_f32_rel_l2": err, "rel_l2_tolerance": ROLLOUT_REL_TOL, "trace": prof}
    emit(res)
    res["cpu_f32_rollout"] = cpu_f32_rollout  # for the chain and f32 lanes; not emitted
    res["chain"] = phase_chain_serving(pred, x, y, res)
    return res


def phase_chain_serving(pred: Predictor, x: torch.Tensor, y_per_block: torch.Tensor,
                        fixed: dict) -> dict:
    """The fixed lane once more with ``fused_chain=3``: every run ``THW``
    of the backbone in one chain launch."""
    set_fusion(pred.model, fused_chain=3)
    roll = lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)  # noqa: E731
    roll()
    torch.cuda.synchronize()
    reset_counts()
    y = roll()
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == {"fused_block_fwd": 0, "fused_block_canon_t_fwd": 0,
                       "fused_chain_apply": 3 * N_STEPS, "fused_group_apply": 0},
          f"chain serving launches {launches}, want {3 * N_STEPS} chain launches only")
    # The chain and the per-block kernels run one tile body with the same
    # rounding points: the two rollouts should be equal.  Each is held to the
    # lane's check against the f32 model on the CPU; their gap is reported.
    mutual = rel_l2(y, y_per_block)
    same = bool(torch.equal(y, y_per_block))
    x1 = x[:1]
    u = x1[:, -1:].cpu()
    err = rel_l2(pred.rollout(x1, 2).cpu() - u, fixed["cpu_f32_rollout"] - u)
    check(err <= ROLLOUT_REL_TOL, f"fixed lane with fused_chain=3 vs CPU f32: rel L2 {err}")
    tm = timed_rollouts(roll)
    prof = traced(roll, "fixed_chain", top=4)
    prof.update(host_split(roll))
    set_fusion(pred.model)
    res = {"phase": "fixed_chain", "fused_chain": 3, "launches_per_rollout": launches,
           "launches_per_model_call": launches["fused_chain_apply"] // N_STEPS,
           "change_vs_cpu_f32_rel_l2": err, "rel_l2_tolerance": ROLLOUT_REL_TOL,
           "vs_per_block_rollout_rel_l2": mutual, "equals_per_block_rollout_bit_for_bit": same,
           **lane_speed(tm), "per_block_frames_per_s": fixed["frames_per_s"],
           "per_block_device_kernel_ms": fixed["trace"]["device_kernel_ms"], "trace": prof}
    emit(res)
    return res


def phase_adaptive(dev) -> dict:
    flat = dict(np.load(ASSET))
    pred = Predictor.from_numpy(flagship(False, torch.bfloat16, dev), flat)
    x = torch.from_numpy(wave_input()).to(dev)
    pred.rollout_adaptive(x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_counts()
    y, rt, n_calls = pred.rollout_adaptive(x, N_STEPS, max_frames_per_call=K,
                                           out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == {"fused_block_fwd": 6 * n_calls, "fused_block_canon_t_fwd": 3 * n_calls,
                       "fused_chain_apply": 0, "fused_group_apply": 0},
          f"adaptive lane launches {launches} for {n_calls} calls")
    tm = timed_rollouts(lambda: pred.rollout_adaptive(
        x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16))

    prof = trace(lambda: pred.rollout_adaptive(
        x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16))
    prof.update(host_split(lambda: pred.rollout_adaptive(
        x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16)))

    # Accuracy on the held-out trajectory (bench.py:_adaptive_accuracy),
    # on the card and for the f32 model on the CPU.
    traj = wave_input(n_frames=IN_T + N_STEPS, seed=123)
    hist, target = torch.from_numpy(traj[:, :IN_T]), torch.from_numpy(traj[:, IN_T:])
    ya, rt_a, calls_a = pred.rollout_adaptive(hist, N_STEPS, max_frames_per_call=K)
    ya = ya.float().cpu()
    ref_pred = Predictor.from_numpy(flagship(False, torch.float32, "cpu"), flat, device="cpu")
    yr, rt_r, calls_r = ref_pred.rollout_adaptive(hist, N_STEPS, max_frames_per_call=K)
    v_gpu, l_gpu = vrmse(ya, target), l2re(ya, target)
    v_ref, l_ref = vrmse(yr, target), l2re(yr, target)
    check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (BATCH, N_STEPS, *RES, FIELDS),
          "adaptive lane output shape / finiteness")
    check(calls_a == calls_r, f"adaptive n_calls {calls_a} on the card, {calls_r} in f32 on the CPU")
    check(abs(v_gpu - v_ref) <= ROLLOUT_REL_TOL * v_ref,
          f"adaptive VRMSE {v_gpu} on the card vs {v_ref} in f32 on the CPU")
    res = {"phase": "adaptive", "batch": BATCH, "n_steps": N_STEPS, "K": K, "dtype": "bf16",
           "weights": "trained (tante_tpu/assets/tante_flagship.npz)", "n_calls": n_calls,
           "rt_log": [float(r) for r in rt], "launches_per_rollout": launches,
           **lane_speed(tm), "trace": prof,
           "heldout": {"n_calls": calls_a, "rt_log": [float(r) for r in rt_a],
                       "vrmse": v_gpu, "l2re": l_gpu},
           "heldout_cpu_f32": {"n_calls": calls_r, "rt_log": [float(r) for r in rt_r],
                               "vrmse": v_ref, "l2re": l_ref},
           "tpu_v5e_history_not_a_port_figure": {"n_calls": 3, "vrmse": 1.0722, "l2re": 1.1336}}
    emit(res)
    return res


def phase_fixed_f32(dev, fixed: dict, adaptive: dict) -> dict:
    """``configs/tante.yaml``'s TANTE in f32, as the config ships (no
    enable_amp), seeded weights: ``Predictor.rollout`` B 8 x 16 steps
    through the f32 kernels (exactly 96 + 48 f32 launches, no bf16 launch),
    frames/s, device time, busy share and host split, the first calls
    against f32 on the CPU (``phase_fixed``'s reference, same weights and
    input); the same rollout with ``fused_chain=3`` (48 f32 chain launches)
    and with ``fused_group`` (16 f32 group launches), each compared with the
    per-block rollout (each traced: device time, busy share); then the
    trained asset's adaptive rollout in f32 (K 8) on the held-out trajectory
    against the port's f32 CPU run (``phase_adaptive``'s): calls, VRMSE,
    L2RE, and traced on the lane's input."""
    model = flagship(True, torch.float32, dev)
    pred = Predictor.from_numpy(model, seeded_jax_params(model, seed=0))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(BATCH, IN_T, *RES, FIELDS)).astype(np.float32)).to(dev)
    roll = lambda: pred.rollout(x, N_STEPS)  # noqa: E731
    for _ in range(2):
        roll()
    torch.cuda.synchronize()
    reset_counts()
    y = roll()
    torch.cuda.synchronize()
    launches, other = launch_counts(torch.float32), other_launches(torch.float32)
    check(launches == {"fused_block_fwd": 96, "fused_block_canon_t_fwd": 48,
                       "fused_chain_apply": 0, "fused_group_apply": 0} and not other,
          f"fixed_f32 lane launches {launches} ({other} in other dtypes), want 96 + 48 f32")
    finite = bool(torch.isfinite(y).all()) and y.dtype == torch.float32
    check(finite and tuple(y.shape) == (BATCH, N_STEPS, *RES, FIELDS),
          "fixed_f32 lane output shape / finiteness")
    tm = timed_rollouts(roll)
    prof = traced(roll, "fixed_f32", f32=True)
    prof.update(host_split(roll))
    u = x[:1, -1:].cpu()
    err = rel_l2(pred.rollout(x[:1], 2).cpu() - u, fixed["cpu_f32_rollout"] - u)
    check(err <= F32_ROLLOUT_REL_TOL, f"fixed_f32 lane vs CPU f32: rel L2 {err}")

    fusion = {}
    for label, kw, want in (("fused_chain=3", dict(fused_chain=3), "fused_chain_apply"),
                            ("fused_group", dict(fused_group=True), "fused_group_apply")):
        set_fusion(pred.model, **kw)
        reset_counts()
        yf = roll()
        torch.cuda.synchronize()
        got = launch_counts(torch.float32)
        n = 3 * N_STEPS if want == "fused_chain_apply" else N_STEPS
        check(got == {**{k: 0 for k in got}, want: n} and not other_launches(torch.float32),
              f"fixed_f32 lane with {label}: launches {got}, want {n} {want}")
        fusion[label] = {"launches_per_rollout": got,
                         "vs_per_block_rollout_rel_l2": rel_l2(yf, y),
                         "equals_per_block_rollout_bit_for_bit": bool(torch.equal(yf, y)),
                         **lane_speed(timed_rollouts(roll, n=2, windows=1)),
                         "trace": traced(roll, f"fixed_f32 {label}", f32=True)}
    set_fusion(pred.model)

    # The trained asset in f32 on the held-out trajectory (phase_adaptive's
    # f32 CPU run is the reference), then timed on the lane's input.
    pa = Predictor.from_numpy(flagship(False, torch.float32, dev), dict(np.load(ASSET)))
    traj = wave_input(n_frames=IN_T + N_STEPS, seed=123)
    hist, target = torch.from_numpy(traj[:, :IN_T]), torch.from_numpy(traj[:, IN_T:])
    reset_counts()
    ya, rt_a, calls_a = pa.rollout_adaptive(hist, N_STEPS, max_frames_per_call=K)
    torch.cuda.synchronize()
    a_launches = launch_counts(torch.float32)
    ya = ya.float().cpu()
    v, l2 = vrmse(ya, target), l2re(ya, target)
    ref = adaptive["heldout_cpu_f32"]
    check(calls_a == ref["n_calls"], f"f32 adaptive n_calls {calls_a}, {ref['n_calls']} on the CPU")
    check(a_launches == {"fused_block_fwd": 6 * calls_a, "fused_block_canon_t_fwd": 3 * calls_a,
                         "fused_chain_apply": 0, "fused_group_apply": 0},
          f"f32 adaptive launches {a_launches} for {calls_a} calls")
    check(abs(v - ref["vrmse"]) <= F32_ROLLOUT_REL_TOL * ref["vrmse"]
          and abs(l2 - ref["l2re"]) <= F32_ROLLOUT_REL_TOL * ref["l2re"],
          f"f32 adaptive VRMSE / L2RE {v} / {l2} vs {ref['vrmse']} / {ref['l2re']} on the CPU")
    xa = torch.from_numpy(wave_input()).to(dev)
    a_roll = lambda: pa.rollout_adaptive(xa, N_STEPS, max_frames_per_call=K)  # noqa: E731
    a_roll()
    a_tm = timed_rollouts(a_roll)
    a_prof = traced(a_roll, "fixed_f32 adaptive", f32=True)
    res = {"phase": "fixed_f32", "config": "configs/tante.yaml as shipped (f32, no enable_amp)",
           "batch": BATCH, "n_steps": N_STEPS, "dtype": "f32", "weights": "seeded (numpy seed 0)",
           "output_shape": list(y.shape), "finite": finite, "launches_per_rollout": launches,
           "other_dtype_launches_per_rollout": other, **lane_speed(tm),
           "change_vs_cpu_f32_rel_l2": err, "rel_l2_tolerance": F32_ROLLOUT_REL_TOL,
           "trace": prof, "fusion": fusion,
           "adaptive": {"weights": "trained (tante_tpu/assets/tante_flagship.npz)", "K": K,
                        "launches_per_rollout": a_launches, "n_calls": calls_a,
                        "rt_log": [float(r) for r in rt_a], "vrmse": v, "l2re": l2,
                        "cpu_f32": {k: ref[k] for k in ("n_calls", "vrmse", "l2re")},
                        "rel_tolerance": F32_ROLLOUT_REL_TOL, **lane_speed(a_tm),
                        "trace": a_prof}}
    emit(res)
    return res


def long_model(dtype, device, **kw) -> TANTE:
    """The long_axes lane's model: the flagship's width and input with every
    attention axis of the JAX alphabet (``LONG_AXES``)."""
    return TANTE(in_T=IN_T, dset_metadata=metadata(), taylor_order=1, attn_axes=LONG_AXES,
                 expanded_channel=EXPANDED, embed_dim=C, patch_scale=8, n_head=HEADS,
                 mlp_ratio=1.0, output_length=1, deg=True, dtype=dtype, device=device, **kw)


# Launches per long_axes rollout (16 model calls): the canonical T block, the
# single-block kernel at H, W, Y (L <= 64), each entry of the long block at
# L, X, A and C.
LONG_AXES_WANT = {"fused_block_fwd": 3 * N_STEPS, "fused_block_canon_t_fwd": N_STEPS,
                  "fused_chain_apply": 0, "fused_group_apply": 0}
LONG_AXES_LONG_WANT = {name: 4 * N_STEPS for name in LONG_WRAPPERS}


def long_axes_lane(dev, dtype, x: torch.Tensor, flat: dict, ref: torch.Tensor, tol: float,
                   timing: dict) -> dict:
    """One dtype of the long_axes lane: ``Predictor.rollout`` B 8 x 16 steps,
    the exact launches of every block kernel (and the profiler's kernel
    events beside them), frames/s, device time, busy share, host split, and
    the first two calls of one sample against the f32 CPU rollout ``ref``."""
    f32 = dtype == torch.float32
    pred = Predictor.from_numpy(long_model(dtype, dev), flat)
    roll = lambda: pred.rollout(x, N_STEPS, out_dtype=dtype)  # noqa: E731
    roll()
    torch.cuda.synchronize()
    reset_counts()
    y = roll()
    torch.cuda.synchronize()
    blocks, longs = launch_counts(dtype), long_counts(dtype)
    other = other_launches(dtype) + sum(n for fn in LONG_WRAPPERS.values()
                                        for dt, n in fn.launches.items() if dt != dtype)
    name = "f32" if f32 else "bf16"
    check(blocks == LONG_AXES_WANT and longs == LONG_AXES_LONG_WANT and not other,
          f"long_axes {name}: launches {blocks} + {longs} ({other} in other dtypes), want "
          f"{LONG_AXES_WANT} + {LONG_AXES_LONG_WANT}")
    finite = bool(torch.isfinite(y).all())
    check(finite and tuple(y.shape) == (BATCH, N_STEPS, *RES, FIELDS),
          f"long_axes {name}: output shape / finiteness")
    tm = timed_rollouts(roll, **timing)
    prof = traced(roll, f"long_axes {name}", top=10, f32=f32)
    counted_long = long_counts(dtype)
    prof["long_launches_counted"] = counted_long
    prof["long_events_match_counts"] = prof["long_kernel_events"] == counted_long
    if not prof["long_events_match_counts"]:
        NOTES.append(f"long_axes {name}: the profiler listed {prof['long_kernel_events']} long "
                     f"kernel events where the wrappers counted {counted_long}")
    prof.update(host_split(roll))
    u = x[:1, -1:].cpu().float()
    err = rel_l2(pred.rollout(x[:1], 2).float().cpu() - u, ref - u)
    check(err <= tol, f"long_axes {name} vs CPU f32: rel L2 {err} > {tol}")
    return {"dtype": name, "output_shape": list(y.shape), "finite": finite,
            "launches_per_rollout": {**blocks, **longs}, "other_dtype_launches": other,
            **lane_speed(tm), "first_two_calls_vs_cpu_f32_rel_l2": err, "rel_l2_tolerance": tol,
            "trace": prof}


def phase_long_axes(dev) -> dict:
    """TANTE whose backbone runs every attention axis of the JAX alphabet
    (``THWLYXAC``, the C block 128 wide) at the flagship width (embed 256,
    patch 8, 8 heads, MLP ratio 1, CNN encoder and decoder), seeded weights,
    B 8 frames of 128x384x4: ``Predictor.rollout`` of 16 steps in bf16, then
    in f32 (the shipped configs' dtype).  Per rollout exactly 16 canonical T,
    48 single-block (H, W, Y) and 64 launches of each long entry (L, X, A,
    C); the first two calls of one sample against the f32 model on the CPU
    (ROLLOUT_REL_TOL in bf16, F32_ROLLOUT_REL_TOL in f32)."""
    t0 = time.perf_counter()
    model = long_model(torch.float32, "cpu")
    flat = seeded_jax_params(model, seed=0)
    x = torch.from_numpy(np.random.default_rng(16).normal(
        size=(BATCH, IN_T, *RES, FIELDS)).astype(np.float32))
    t_cpu = time.perf_counter()
    ref = Predictor.from_numpy(model, flat, device="cpu").rollout(x[:1], 2)
    cpu_s = time.perf_counter() - t_cpu
    del model
    x = x.to(dev)
    lanes = {"bf16": long_axes_lane(dev, torch.bfloat16, x, flat, ref, ROLLOUT_REL_TOL, {}),
             "f32": long_axes_lane(dev, torch.float32, x, flat, ref, F32_ROLLOUT_REL_TOL,
                                   dict(n=2, windows=1))}
    res = {"phase": "long_axes", "attn_axes": LONG_AXES, "expanded_channel": EXPANDED,
           "embed_dim": C, "heads": HEADS, "batch": BATCH, "n_steps": N_STEPS,
           "weights": "seeded (numpy seed 0)", "cpu_f32_reference_s": cpu_s, **lanes,
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def loss_and_gnorm(model, x, y, n_out: int, k: int = 1) -> tuple[float, float]:
    """The train step's objective with no update: ``rollout_fixed`` of
    ``n_out`` frames, ``k`` a call, in training mode (dropout drawn from a
    generator seeded 0 on ``x``'s device), MSE against ``y``; the loss and
    the gradient norm."""
    gen = torch.Generator(device=x.device).manual_seed(0)
    pred = rollout_fixed(lambda w: model(w, deterministic=False, generator=gen), x, n_out, k)
    loss = MSE()(pred.to(y.dtype), y).mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    gnorm = float(global_norm(model.parameters()))
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), gnorm


def phase_train(dev, workdir: Path) -> dict:
    """The flagship through ``Trainer`` and the in-memory datamodule
    (``configs/tante.yaml``'s geometry and optimizer; the schedule starts its
    warmup at a fifth of the peak rate instead of 0, so that the first
    epoch's steps move the weights)."""
    n_out, n_roll = 4, 8
    dm = WaveDataModule(
        batch_size=BATCH, n_steps_input=IN_T, n_steps_output=n_out, eval_steps_output=n_roll,
        data_workers=4, seed=0, device=dev,
        waves=dict(resolution=RES, n_trajectories=4, n_steps=16, with_pressure=True, seed=0))
    md = dm.train_dataset.metadata
    mse = MSE()

    def trainer_for(dropout: float, folder: str, model=None, **kw) -> Trainer:
        model = model or flagship(True, torch.float32, dev, md, dropout=dropout)
        return Trainer(
            str(workdir / folder), "channels_first_default", model, dm,
            AdamW(lr=5e-5, weight_decay=1e-5), mse, L2RE(), max_epoch=34,
            lr_scheduler=LinearWarmupCosineAnnealingLR(
                warmup_epochs=2, max_epochs=34, lr=5e-5, warmup_start_lr=1e-5),
            enable_amp=True, n_steps_output=n_out, n_steps_rollout=n_roll, seed=0, **kw)

    loader = dm.train_dataloader()
    loader.set_epoch(1)
    batches = [tuple(b[k] for k in ("input", "output")) for b in loader]
    x0, y0 = batches[0]

    def eval_loss(model) -> float:
        with torch.no_grad():
            pred = rollout_fixed(lambda w: model(w), x0, n_out, 1)
            return float(mse(pred.float(), y0).mean())

    def epoch(trainer: Trainer) -> dict:
        """One epoch through ``train_one_epoch`` with the launches counted,
        then the same batches step by step under CUDA events."""
        before = eval_loss(trainer.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        epoch_loss, logs = trainer.train_one_epoch(1, loader)
        torch.cuda.synchronize()
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        after = eval_loss(trainer.model)
        ms = []
        for x, y in batches:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            trainer.train_step(x, y)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
        split = host_split(lambda: trainer.train_step(x0, y0))
        split["trace"] = trace(lambda: trainer.train_step(x0, y0), top=6)
        steps = len(batches)
        check(np.isfinite(epoch_loss) and np.isfinite(after), "training loss is not finite")
        check(after < before, f"loss on the first batch did not fall: {before} -> {after}")
        return {"steps": steps, "epoch_train_loss": epoch_loss, "lr": logs["lr"],
                "first_batch_loss_before": before, "first_batch_loss_after": after,
                "launches_per_step": {k: v / steps for k, v in launches.items()},
                "seconds_per_step_median": sorted(ms[1:])[len(ms[1:]) // 2] / 1e3,
                "seconds_per_step_all": [m / 1e3 for m in ms],
                "peak_memory_allocated_gb": peak / 2**30, **split}

    # (a) the config's dropout 0.1: every block takes its plain path.
    tr_a = trainer_for(0.1, "dropout")
    res_a = epoch(tr_a)
    check(all(v == 0 for v in res_a["launches_per_step"].values()),
          f"dropout-0.1 steps launched kernels: {res_a['launches_per_step']}")
    del tr_a

    # (b) dropout 0: the kernels forward, the plain recompute backward.
    tr_b = trainer_for(0.0, "kernels")
    init_state = {k: v.detach().cpu().clone() for k, v in tr_b.model.state_dict().items()}
    loss_gpu, gnorm_gpu = loss_and_gnorm(tr_b.model, x0[:1], y0[:1], n_out)
    res_b = epoch(tr_b)
    want = {"fused_block_fwd": 6.0 * n_out, "fused_block_canon_t_fwd": 3.0 * n_out,
            "fused_chain_apply": 0.0, "fused_group_apply": 0.0}
    check(res_b["launches_per_step"] == want,
          f"dropout-0 step launches {res_b['launches_per_step']}, want {want}")
    cpu_model = flagship(True, torch.float32, "cpu", md, dropout=0.0)
    cpu_model.load_state_dict(init_state)
    loss_cpu, gnorm_cpu = loss_and_gnorm(cpu_model, x0[:1].cpu(), y0[:1].cpu(), n_out)
    check(abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_REL_TOL * loss_cpu,
          f"first loss {loss_gpu} on the card vs {loss_cpu} in f32 on the CPU")
    check(abs(gnorm_gpu - gnorm_cpu) <= TRAIN_GNORM_REL_TOL * gnorm_cpu,
          f"first gradient norm {gnorm_gpu} on the card vs {gnorm_cpu} in f32 on the CPU")

    # (c) validation: chain, per block, group.  Same batches each time (the
    # loader's shuffle depends on seed and epoch only).
    val_loader = dm.val_dataloader()
    calls = len(val_loader) * n_roll
    val = {}
    for label, fusion, want in (
        ("fused_chain=3", dict(fused_chain=3), {"fused_chain_apply": 3 * calls}),
        ("per_block", {}, {"fused_block_fwd": 6 * calls, "fused_block_canon_t_fwd": 3 * calls}),
        ("fused_group", dict(fused_group=True), {"fused_group_apply": calls}),
    ):
        set_fusion(tr_b.model, **fusion)
        tr_b.validation_loop(val_loader)  # warm
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss = tr_b.validation_loop(val_loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        check(launches == {**dict.fromkeys(launches, 0), **want},
              f"validation ({label}) launches {launches}, want only {want}")
        val[label] = {"loss": loss, "seconds": seconds, "model_calls": calls,
                      "launches": launches,
                      "launches_per_model_call": {k: v / calls for k, v in launches.items()}}
    set_fusion(tr_b.model)
    base = val["per_block"]["loss"]
    for label in ("fused_chain=3", "fused_group"):
        check(np.isfinite(base) and abs(val[label]["loss"] - base) <= VAL_REL_TOL * abs(base),
              f"validation loss {val[label]['loss']} ({label}) vs {base} per block")

    # (d) save, and a second Trainer resuming from "recent".
    tr_b.save_model(1, base, "recent")
    resumed = trainer_for(0.0, "kernels", checkpoint_path=str(workdir / "kernels" / "recent"))
    same_weights = all(torch.equal(a, b) for a, b in zip(
        tr_b.model.state_dict().values(), resumed.model.state_dict().values()))
    resume_ok = (same_weights and resumed.starting_epoch == 2
                 and resumed.global_step == resumed.steps_per_epoch
                 and resumed.starting_val_loss == base)
    l_a, l_b = float(tr_b.train_step(x0, y0)), float(resumed.train_step(x0, y0))
    check(resume_ok, "the resumed Trainer does not continue from the saved state")
    check(np.isfinite(l_b) and abs(l_a - l_b) <= 1e-3 * abs(l_a),
          f"first step after resume: loss {l_b} vs {l_a} for the Trainer that saved")

    res = {"phase": "train", "batch": BATCH, "n_steps_output": n_out, "n_steps_rollout": n_roll,
           "dtype": "bf16 compute, f32 weights", "weights": "seeded init (torch seed 0)",
           "dropout_0.1": res_a, "dropout_0": res_b,
           "first_step_one_sample": {
               "loss": loss_gpu, "loss_cpu_f32": loss_cpu, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
               "grad_norm": gnorm_gpu, "grad_norm_cpu_f32": gnorm_cpu,
               "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL},
           "validation": val, "validation_rel_tol": VAL_REL_TOL,
           "resume": {"ok": resume_ok, "starting_epoch": resumed.starting_epoch,
                      "global_step": resumed.global_step,
                      "next_step_loss": l_b, "next_step_loss_of_saver": l_a}}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The adaptive training path: R_Trainer (both rollout engines), R_Evaler
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_calls(model: torch.nn.Module):
    """[n]: the model's calls while the block is open (a forward hook; a
    recompute under remat is not a call and does not fire it)."""
    n = [0]
    hook = model.register_forward_hook(lambda *_: n.__setitem__(0, n[0] + 1))
    try:
        yield n
    finally:
        hook.remove()


@contextlib.contextmanager
def captured_block_inputs(store: dict):
    """The block wrappers, where the models call them, wrapped to keep a copy
    of the first card input of each shape and dtype (x, the weights, the
    softmax in force); each call goes on to the wrapper, which counts its
    launch."""
    apply, canon = model_common.fused_block_apply, model_backbone.fused_block_canon_t

    def keep(key, x, p, *args):
        if x.is_cuda and key not in store:
            store[key] = (x.detach().clone(), fb.BlockParams(*(t.detach().clone() for t in p)),
                          args, fb._TUNE["softmax"])

    def apply_kept(x, p, l, heads, causal):
        keep(("fused_block_fwd", tuple(x.shape), causal, x.dtype), x, p, l, heads, causal)
        return apply(x, p, l, heads, causal)

    def canon_kept(x, p, heads):
        keep(("fused_block_canon_t_fwd", tuple(x.shape), True, x.dtype), x, p, heads)
        return canon(x, p, heads)

    model_common.fused_block_apply, model_backbone.fused_block_canon_t = apply_kept, canon_kept
    try:
        yield store
    finally:
        model_common.fused_block_apply, model_backbone.fused_block_canon_t = apply, canon


def kernels_at_path_shapes(store: dict, path: str) -> list[dict]:
    """Each block kernel on the inputs the path gave it (one per shape and
    dtype), against its plain version at the kernel phase's tolerance (bf16)
    or the f32 phase's (f32)."""
    out = []
    for (name, shape, causal, dtype), (x, p, args, softmax) in sorted(
            store.items(), key=lambda kv: str(kv[0])):
        pf = fb.BlockParams(*(t.float() for t in p))
        fb.set_block_tuning(softmax=softmax)
        if name == "fused_block_fwd":
            got, want = fb.fused_block_apply(x, p, *args), fb.block_ref(x.float(), pf, *args)
        else:
            got, want = fb.fused_block_canon_t(x, p, *args), fb.canon_t_ref(x.float(), pf, *args)
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            ok, extra = f32_agree(got, want)
        else:
            ok = bool(torch.isfinite(got).all()) and bool((err <= ATOL + RTOL * want.abs()).all())
            extra = {}
        check(ok, f"kernel {name} at the {path} path's shape {shape} ({dtype}) disagrees with "
                  f"its plain version")
        out.append({"name": name, "shape": list(shape), "causal": causal, "dtype": str(dtype),
                    "softmax": softmax, "max_abs_err": float(err.max()),
                    "max_abs_plain": float(want.abs().max()), **extra, "ok": ok})
    fb.set_block_tuning(softmax="fast")
    return out


def r_objective(trainer: R_Trainer, x, y) -> dict:
    """The R_Trainer's objective on (x, y) and its gradient norm, no update:
    the r_t statistics it logged and, for the variable-frame engine, the
    first sample's per-slot cums / r_t / actives of the same rollout."""
    model = trainer.model
    model.train()
    model.zero_grad(set_to_none=True)
    loss, rt, rt_var, calls, rollout = trainer._adaptive_loss(x, y)
    loss.backward()
    gnorm = float(global_norm(model.parameters()))
    model.zero_grad(set_to_none=True)
    out = {"loss": float(loss.detach()), "grad_norm": gnorm, "rt": float(rt),
           "rt_var": float(rt_var), "calls": float(calls)}
    if trainer.vf:
        out.update(cums=rollout["cums"][:, 0].tolist(), actives=rollout["actives"][:, 0].tolist(),
                   rts=[float(r) for r in rollout["rts"][:, 0]])
    return out


def r_eval_loss(trainer: R_Trainer, x, y) -> float:
    """MSE of the trainer's engine's rollout of (x, y) with dropout off."""
    apply = lambda w: trainer.model(w, trainer.train_out_T)  # noqa: E731
    with torch.no_grad():
        if trainer.vf:
            pred = rollout_adaptive_train_vf(apply, x, trainer.n_steps_output, trainer.k)[0]
        else:
            pred = rollout_adaptive_train(apply, x, trainer.n_steps_output)[0]
        return float(MSE()(pred.float(), y).mean())


def r_epoch(trainer: R_Trainer, loader, eval_batch, want_per_call: dict, remat: bool) -> dict:
    """One epoch through ``train_one_epoch`` with the model calls and the
    launches counted (each call launches ``want_per_call``, twice under
    remat: forward and the recompute in backward), then the same batches
    step by step under CUDA events; the rollout's MSE on ``eval_batch``
    before and after."""
    loader.set_epoch(1)
    batches = [(b["input"], b["output"]) for b in loader]
    before = r_eval_loss(trainer, *eval_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with counted_calls(trainer.model) as calls:
        epoch_loss, logs = trainer.train_one_epoch(1, loader)
        torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps, n_calls = len(batches), calls[0]
    factor = 2 if remat else 1
    want = {k: factor * n_calls * want_per_call.get(k, 0) for k in launches}
    tag = "remat" if remat else "no remat"
    check(launches == want, f"R_Trainer epoch ({tag}) launches {launches}, want {want} for "
                            f"{n_calls} model calls")
    # The trainer's log: model calls per 4 target frames, calls * B / 4.
    logged = logs["steps"] * 4 / batches[0][0].shape[0] * steps
    check(abs(logged - n_calls) <= 1e-9 * n_calls,
          f"R_Trainer epoch ({tag}) logged {logged} model calls, made {n_calls}")
    after = r_eval_loss(trainer, *eval_batch)
    ms = []
    for x, y in batches:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_step(x, y)
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    check(np.isfinite(epoch_loss) and np.isfinite(after), "R_Trainer loss is not finite")
    return {"steps": steps, "epoch_train_loss": epoch_loss, "logs": logs,
            "model_calls_per_step": n_calls / steps,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "launches_per_model_call": {k: v / max(n_calls, 1) for k, v in launches.items()},
            "first_batch_loss_before": before, "first_batch_loss_after": after,
            "seconds_per_step_median": sorted(ms)[len(ms) // 2] / 1e3,
            "seconds_per_step_all": [m / 1e3 for m in ms],
            "peak_memory_allocated_gb": peak / 2**30}


def rt_near_integers(run: dict) -> list:
    """The r_t of the consuming slots within bf16 rounding (2^-8 relative)
    of an integer, with their distance: where a floor on the card and on the
    CPU may differ."""
    return [{"rt": r, "distance": abs(r - round(r))}
            for r, a in zip(run["rts"], run["actives"])
            if a and abs(r - round(r)) <= 2.0 ** -8 * abs(r)]


def phase_adaptive_train(dev, workdir: Path) -> dict:
    """The adaptive training path (``R_Trainer``, ``R_Evaler``) on the card:
    (a) ``configs/tante_adaptive.yaml``'s one-frame engine, (b) the flagship
    recipe's variable-frame engine (``scripts/train_flagship.py:92-107``) from
    the trained asset, (c) the validation loop and ``R_Evaler``; then each
    block kernel on the inputs the path gave it, one per shape (B 8, 4 and
    1), against its plain version."""
    inputs: dict = {}
    with captured_block_inputs(inputs):
        res = adaptive_train_runs(dev, workdir)
    res["kernels_at_the_path_shapes"] = kernels_at_path_shapes(inputs, "adaptive")
    check({k[0] for k in inputs} == {"fused_block_fwd", "fused_block_canon_t_fwd"},
          f"adaptive path: block kernels reached {sorted({k[0] for k in inputs})}")
    emit(res)
    return res


def adaptive_train_runs(dev, workdir: Path) -> dict:
    mse = MSE()
    sched = lambda: LinearWarmupCosineAnnealingLR(  # noqa: E731
        warmup_epochs=2, max_epochs=34, lr=5e-5, warmup_start_lr=1e-5)
    per_call = {"fused_block_fwd": 6, "fused_block_canon_t_fwd": 3}

    # (a) the config: B=8, 4 one-frame calls a step, rt_eps 0.5, rt_n 2.
    n_out = 4
    dm = WaveDataModule(
        batch_size=BATCH, n_steps_input=IN_T, n_steps_output=n_out, eval_steps_output=8,
        data_workers=4, seed=0, device=dev,
        waves=dict(resolution=RES, n_trajectories=4, n_steps=16, with_pressure=True, seed=0))
    md = dm.train_dataset.metadata

    def config_trainer(dropout: float, folder: str, model=None, device=None) -> R_Trainer:
        model = model or flagship(False, torch.float32, dev, md, dropout=dropout)
        return R_Trainer(str(workdir / folder), "channels_first_default", model, dm,
                         AdamW(lr=5e-5, weight_decay=1e-5), mse, L2RE(), max_epoch=34,
                         lr_scheduler=sched(), enable_amp=device is None, n_steps_output=n_out,
                         n_steps_rollout=8, rt_eps=0.5, rt_n=2, seed=0, device=device)

    loader = dm.train_dataloader()
    loader.set_epoch(1)
    first = next(iter(loader))
    x0, y0 = first["input"], first["output"]
    tr = config_trainer(0.1, "r_dropout")
    one_frame = {"dropout_0.1": r_epoch(tr, loader, (x0, y0), {}, remat=False)}
    del tr
    tr = config_trainer(0.0, "r_kernels")
    init = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    gpu = r_objective(tr, x0[:1], y0[:1])
    one_frame["dropout_0"] = r_epoch(tr, loader, (x0, y0), per_call, remat=False)
    cpu_model = flagship(False, torch.float32, "cpu", md, dropout=0.0)
    cpu_model.load_state_dict(init)
    cpu = r_objective(config_trainer(0.0, "r_cpu", cpu_model, "cpu"), x0[:1].cpu(), y0[:1].cpu())
    del tr
    for run in one_frame.values():
        check(run["first_batch_loss_after"] < run["first_batch_loss_before"],
              f"R_Trainer (one frame) loss on the first batch did not fall: "
              f"{run['first_batch_loss_before']} -> {run['first_batch_loss_after']}")
        check(run["model_calls_per_step"] == n_out, "one-frame engine: a slot without a call")
    check(abs(gpu["loss"] - cpu["loss"]) <= TRAIN_LOSS_REL_TOL * cpu["loss"],
          f"R_Trainer first loss {gpu['loss']} on the card vs {cpu['loss']} in f32 on the CPU")
    check(abs(gpu["grad_norm"] - cpu["grad_norm"]) <= TRAIN_GNORM_REL_TOL * cpu["grad_norm"],
          f"R_Trainer first gradient norm {gpu['grad_norm']} vs {cpu['grad_norm']} on the CPU")
    one_frame["first_step_one_sample"] = {"card": gpu, "cpu_f32": cpu,
                                          "loss_rel_tol": TRAIN_LOSS_REL_TOL,
                                          "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL}

    # (b) the flagship recipe from the trained asset: B=4, 16 slots of 8-frame
    # Taylor blocks, the band anchored at 8, growth supervision.
    b_vf, n_vf, k_vf = 4, 16, 8
    recipe = dict(train_out_T=float(k_vf), rt_band_hi=float(k_vf), rt_eps=3.0,
                  rt_supervision=0.05, rt_sup_mode="growth")
    dm_vf = WaveDataModule(
        batch_size=b_vf, n_steps_input=IN_T, n_steps_output=n_vf, eval_steps_output=n_vf,
        data_workers=4, seed=0, device=dev,
        waves=dict(resolution=RES, n_trajectories=2, n_steps=IN_T + n_vf + 4,
                   with_pressure=True, seed=0))
    md_vf = dm_vf.train_dataset.metadata
    asset = dict(np.load(ASSET))

    def recipe_trainer(folder: str, device=None, asset_weights=True, **kw) -> R_Trainer:
        model = flagship(False, torch.float32, device or dev, md_vf, dropout=0.0)
        if asset_weights:
            load_jax_params(model, asset)
        return R_Trainer(str(workdir / folder), "channels_first_default", model, dm_vf,
                         AdamW(lr=5e-5, weight_decay=1e-5), mse, L2RE(), max_epoch=34,
                         lr_scheduler=sched(), enable_amp=device is None, n_steps_output=n_vf,
                         n_steps_rollout=n_vf, rt_n=2, seed=0, device=device, **recipe, **kw)

    loader_vf = dm_vf.train_dataloader()
    loader_vf.set_epoch(1)
    first = next(iter(loader_vf))
    xv, yv = first["input"], first["output"]
    tr_vf = recipe_trainer("r_vf")
    check(tr_vf.gradient_checkpointing, "the variable-frame R_Trainer's default is not remat")
    gpu_vf = r_objective(tr_vf, xv[:1], yv[:1])
    cpu_vf = r_objective(recipe_trainer("r_vf_cpu", "cpu"), xv[:1].cpu(), yv[:1].cpu())
    check(gpu_vf["cums"] == cpu_vf["cums"],
          f"vf first step: cums {gpu_vf['cums']} on the card vs {cpu_vf['cums']} on the CPU")
    check(abs(gpu_vf["loss"] - cpu_vf["loss"]) <= TRAIN_LOSS_REL_TOL * cpu_vf["loss"],
          f"vf first loss {gpu_vf['loss']} on the card vs {cpu_vf['loss']} on the CPU")
    check(abs(gpu_vf["grad_norm"] - cpu_vf["grad_norm"])
          <= TRAIN_GNORM_REL_TOL * cpu_vf["grad_norm"],
          f"vf first gradient norm {gpu_vf['grad_norm']} vs {cpu_vf['grad_norm']} on the CPU")
    vf = {"remat": r_epoch(tr_vf, loader_vf, (xv, yv), per_call, remat=True)}
    tr_off = recipe_trainer("r_vf_off", gradient_checkpointing=False)
    vf["no_remat"] = r_epoch(tr_off, loader_vf, (xv, yv), per_call, remat=False)
    del tr_off
    for label, run in vf.items():
        check(0 < run["model_calls_per_step"] <= n_vf, f"vf ({label}): calls per step "
                                                       f"{run['model_calls_per_step']}")
    vf["first_step_one_sample"] = {
        "card": gpu_vf, "cpu_f32": cpu_vf, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
        "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL,
        "rt_within_bf16_rounding_of_an_integer": {
            "card": rt_near_integers(gpu_vf), "cpu_f32": rt_near_integers(cpu_vf)}}
    # JAX's ~58 GB warning is for every slot a real call: seeded weights emit
    # one or two frames a call at init; one step with remat and one without.
    vf["seeded_weights"] = {}
    for label, remat in (("remat", True), ("no_remat", False)):
        tr_w = recipe_trainer(f"r_vf_seeded_{label}", asset_weights=False,
                              gradient_checkpointing=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with counted_calls(tr_w.model) as n:
            start.record()
            reported = float(tr_w.train_step(xv, yv)[3])
            stop.record()
            stop.synchronize()
        launches, calls = launch_counts(), n[0]
        factor = 2 if remat else 1
        check(launches == {k: factor * calls * per_call.get(k, 0) for k in launches}
              and reported == calls,
              f"vf step, seeded weights ({label}): launches {launches} for {calls} calls "
              f"(the step reports {reported})")
        vf["seeded_weights"][label] = {
            "model_calls": calls, "seconds": start.elapsed_time(stop) / 1e3,
            "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches}
        del tr_w

    # (c) validation (out_T = 16, 9 block launches per model call) and R_Evaler
    # on the asset (16 steps, K = 8) against Predictor.rollout_adaptive.
    val_loader = dm_vf.val_dataloader()
    torch.cuda.synchronize()
    reset_counts()
    with counted_calls(tr_vf.model) as n:
        val_loss = tr_vf.validation_loop(val_loader)
        torch.cuda.synchronize()
    launches, n_val = launch_counts(), n[0]
    want = {k: n_val * per_call.get(k, 0) for k in launches}
    check(launches == want, f"R_Trainer validation launches {launches}, want {want}")
    saved_rt = (workdir / "r_vf" / "saved_rt.txt").read_text().split()
    check(np.isfinite(val_loss) and len(saved_rt) == 1, "R_Trainer validation / saved_rt.txt")
    del tr_vf

    fns = [MSE(), L2RE(), NNMSE(), VRMSE()]
    model = flagship(False, torch.float32, dev, md_vf)
    load_jax_params(model, asset)
    evaler = R_Evaler(str(workdir / "r_eval"), "channels_first_default", model, dm_vf, *fns,
                      enable_amp=True, n_steps_rollout=n_vf, out_T_max=k_vf, batch_size=b_vf)
    test_loader = dm_vf.test_dataloader()
    reset_counts()
    report = evaler.Eval()
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    pred = Predictor.from_numpy(flagship(False, torch.bfloat16, dev, md_vf), asset)
    own = {name: [] for name in evaler.loss_names}
    pred_calls = []
    with torch.no_grad():
        for batch in test_loader:
            y = evaler._rollout(batch["input"])
            for name, fn in zip(evaler.loss_names, fns):
                own[name].append(float(fn(y.to(batch["output"].dtype), batch["output"]).mean()))
            pred_calls.append(pred.rollout_adaptive(batch["input"], n_vf, k_vf)[2])
    check(report["model_calls_per_rollout"] == float(np.mean(pred_calls)),
          f"R_Evaler {report['model_calls_per_rollout']} calls per rollout, Predictor "
          f"{pred_calls}")
    for name in evaler.loss_names:
        got, want_m = report["metrics"][name], float(np.mean(own[name]))
        check(np.isfinite(got) and abs(got - want_m) <= METRIC_REL_TOL * abs(want_m),
              f"R_Evaler {name} {got} vs the metric function on the same rollouts {want_m}")
    n_eval_calls = sum(pred_calls)
    check(eval_launches == {k: n_eval_calls * per_call.get(k, 0) for k in eval_launches},
          f"R_Evaler launches {eval_launches} for {n_eval_calls} model calls")

    res = {"phase": "adaptive_train", "dtype": "bf16 compute, f32 weights",
           "one_frame": {"config": "configs/tante_adaptive.yaml (B8, n_steps_output 4, rt_eps "
                                   "0.5, rt_n 2, value clip, AdamW 5e-5 / 1e-5, warmup-cosine)",
                         "weights": "seeded init (torch seed 0)", **one_frame},
           "variable_frame": {"recipe": "scripts/train_flagship.py:92-107 (B4, n_steps_output "
                                        "16, train_out_T 8, rt_band_hi 8, rt_eps 3, "
                                        "rt_supervision 0.05 growth)",
                              "weights": "trained (tante_tpu/assets/tante_flagship.npz)",
                              "slots_per_step": n_vf,
                              "card_memory_gb": torch.cuda.get_device_properties(0).total_memory
                              / 2**30, **vf},
           "validation": {"loss": val_loss, "model_calls": n_val, "launches": launches,
                          "launches_per_model_call": {k: v / max(n_val, 1)
                                                      for k, v in launches.items()},
                          "saved_rt": float(saved_rt[0])},
           "r_evaler": {"report": report, "test_batches": len(test_loader),
                        "predictor_n_calls": pred_calls, "launches": eval_launches,
                        "metric_functions_on_the_same_rollouts": {
                            k: float(np.mean(v)) for k, v in own.items()},
                        "metric_rel_tol": METRIC_REL_TOL}}
    return res


# ---------------------------------------------------------------------------
# The paper's entry points: the train / eval CLIs, Predictor.from_experiment
# ---------------------------------------------------------------------------

CLI_CONFIGS = ("tante", "tante_adaptive")
# The fewest wave trajectories that give an epoch 2 train steps of B 8 at 4 in /
# 4 out (2 x 9 windows of 16 frames); validation 1 batch (2 x 5 windows of 12
# frames), test 2 batches at the eval CLI's 4-step window.
CLI_WAVES = dict(resolution=list(RES), n_trajectories=2, n_steps=16, with_pressure=True, seed=0)
# The shipped configs set no enable_amp: TANTE runs in f32, its blocks on
# the f32 kernels.  A user's choice of bf16 (the Trainer's and the Evaler's
# compute dtype) is these two overrides; the phase runs it once, for
# configs/tante.yaml.
CLI_AMP = ["trainer.enable_amp=true", "evaler.enable_amp=true"]
CLI_REL_TOL = 1e-6  # eval CLI against the Evaler by hand: the same computation


def h5py_imports() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def cli_config_dir(workdir: Path, h5: bool) -> tuple[str, list, str]:
    """(config dir, data overrides, route): copies of the two shipped configs,
    every key but ``data`` as shipped.  Without h5py the data node is the
    in-memory ``WaveDataModule`` at the bench's field; with it, the configs'
    own data node over a ``make_well_dataset`` tree and the native loader."""
    import yaml

    from tante_tpu_torch.config import CONFIG_DIR
    from tante_tpu_torch.data.synthetic import make_well_dataset

    cdir = workdir / "cli_configs"
    cdir.mkdir(exist_ok=True)
    for name in CLI_CONFIGS:
        with open(os.path.join(CONFIG_DIR, name + ".yaml")) as f:
            cfg = yaml.safe_load(f)
        if not h5:
            cfg["data"] = {"_target_": "tante_tpu_torch.data.WaveDataModule",
                           "batch_size": BATCH, "n_steps_input": IN_T, "n_steps_output": 4,
                           "eval_steps_output": 8, "data_workers": 4,
                           "dataset_name": "synthetic_waves", "waves": CLI_WAVES}
        with open(cdir / f"{name}.yaml", "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
    if not h5:
        return str(cdir), [], "in-memory WaveDataModule (h5py does not import)"
    base = workdir / "cli_well"
    make_well_dataset(str(base), dataset_name="synthetic_waves",
                      **{k: v for k, v in CLI_WAVES.items() if k != "resolution"},
                      resolution=tuple(RES))
    return (str(cdir), [f"data.base_path={base}", "data.dataset_name=synthetic_waves",
                        "data.use_wellpack=true", f"data.wellpack_cache_dir={base / 'wpk'}"],
            "HDF5 TanteDataModule, native WellPack loader")


@contextlib.contextmanager
def cli_counts(log: list, dtype: torch.dtype):
    """Each epoch and validation loop of a Trainer / R_Trainer as it runs:
    its kind, epoch, seconds (synchronised), block launches in ``dtype`` and
    in any other, and TANTE model calls (a global forward hook)."""
    calls = [0]
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, *_: calls.__setitem__(0, calls[0] + isinstance(m, TANTE)))
    saved = []

    def wrap(cls, name, kind):
        fn = cls.__dict__[name]

        def counted(self, *args, **kw):
            # train_one_epoch(epoch, loader), validation_loop(loader, epoch=...)
            epoch, loader = args if kind == "train" else (kw.get("epoch", 0), args[0])
            torch.cuda.synchronize()
            reset_counts()
            n0, t0 = calls[0], time.perf_counter()
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            log.append({"kind": kind, "epoch": epoch, "seconds": time.perf_counter() - t0,
                        "batches": len(loader), "model_calls": calls[0] - n0,
                        "launches": launch_counts(dtype),
                        "other_dtype_launches": other_launches(dtype)})
            return out

        saved.append((cls, name, fn))
        setattr(cls, name, counted)

    for cls in (Trainer, R_Trainer):
        wrap(cls, "train_one_epoch", "train")
        wrap(cls, "validation_loop", "validation")
    try:
        yield calls
    finally:
        hook.remove()
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def want_launches(calls: int) -> dict:
    return {"fused_block_fwd": 6 * calls, "fused_block_canon_t_fwd": 3 * calls,
            "fused_chain_apply": 0, "fused_group_apply": 0}


def launched(dtype: torch.dtype, calls: int) -> bool:
    """Since the last reset: ``calls`` TANTE model calls' block launches,
    all in ``dtype``."""
    return launch_counts(dtype) == want_launches(calls) and not other_launches(dtype)


def cli_run(name: str, dev, workdir: Path, cdir: str, data_ov: list,
            dtype: torch.dtype = torch.float32) -> dict:
    """train 1 epoch -> train to 2 (resume) -> eval --choose=best against the
    Evaler by hand -> from_experiment on the card against a Predictor built
    by hand from the same state.pt.  ``dtype`` bf16: the config with the
    ``CLI_AMP`` overrides, one epoch and no resume."""
    from tante_tpu_torch.cli import eval as cli_eval
    from tante_tpu_torch.cli import train as cli_train
    from tante_tpu_torch.config import instantiate, load_config
    from tante_tpu_torch.utils.checkpoint import STATE_FILE

    bf16 = dtype == torch.bfloat16
    tag = f"{name} ({dtype})"
    experiment = f"CLI_{name}" + ("_bf16" if bf16 else "")
    ov = [f"root_path={workdir / 'cli_runs'}", f"experiment={experiment}",
          *(CLI_AMP if bf16 else []), *data_ov]
    folder = workdir / "cli_runs" / "experiments" / experiment
    args = [f"--config-name={name}", f"--config-dir={cdir}"]
    res: dict = {"config": f"configs/{name}.yaml, data node replaced", "overrides": ov,
                 "dtype": str(dtype)}

    # 1-2: one epoch, then a rerun to max_epoch 2 resumes from recent/.
    for epochs in (1,) if bf16 else (1, 2):
        log: list = []
        with cli_counts(log, dtype):
            t0 = time.perf_counter()
            trainer = cli_train.main([*args, f"trainer.max_epoch={epochs}", *ov])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        train = [r for r in log if r["kind"] == "train"]
        val = [r for r in log if r["kind"] == "validation"]
        check(trainer.device.type == "cuda", f"{tag}: the train CLI ran on {trainer.device}")
        check([r["epoch"] for r in train] == [epochs],
              f"{tag}: max_epoch={epochs} trained epochs {[r['epoch'] for r in train]}")
        check(all(r["launches"] == want_launches(0) and not r["other_dtype_launches"]
                  for r in train),
              f"{tag}: train steps launched block kernels at dropout 0.1: {train}")
        check(all(r["launches"] == want_launches(r["model_calls"])
                  and not r["other_dtype_launches"] and r["model_calls"] > 0 for r in val),
              f"{tag}: validation launches {val}, want 6 + 3 {dtype} a model call")
        check(trainer.model.dtype == dtype,
              f"{tag}: the train CLI computes in {trainer.model.dtype}, want {dtype}")
        res[f"train_max_epoch_{epochs}"] = {
            "device": str(trainer.device), "wall_s": wall, "epochs": log,
            "steps_per_epoch": trainer.steps_per_epoch,
            "parameters": sum(p.numel() for p in trainer.model.parameters()),
            "starting_epoch": trainer.starting_epoch}
        del trainer
    for path in ("metrics.jsonl", "recent/" + STATE_FILE, "best/" + STATE_FILE,
                 "extended_config.yaml", "saved_loss.txt") + (
                     ("saved_rt.txt",) if name == "tante_adaptive" else ()):
        check((folder / path).exists(), f"{tag}: the train CLI wrote no {path}")

    # 3: the eval CLI against the Evaler built by hand on the same checkpoint.
    reset_counts()
    report = cli_eval.main([*args, "--choose=best", *ov])
    torch.cuda.synchronize()
    eval_launches, eval_other = launch_counts(dtype), other_launches(dtype)
    cfg = load_config(name, config_dir=cdir, overrides=ov)
    cfg.data.eval_steps_output = cfg.evaler.n_steps_rollout
    dm = instantiate(cfg.data, seed=cfg.seed)
    md = dm.train_dataset.metadata
    if cfg.data.get("use_wellpack"):
        # TanteDataModule drops back to the Python loader without the native
        # library: the HDF5 route must not.
        from tante_tpu_torch.data.wellpack import WellPackLoader

        loader = dm.test_dataloader()
        check(isinstance(loader, WellPackLoader),
              f"{tag}: use_wellpack=true gave a {type(loader).__name__}")
        res["test_loader"] = type(loader).__name__
    evaler = instantiate(cfg.evaler, checkpoint_folder=str(folder),
                         model=instantiate(cfg.model, dset_metadata=md, seed=cfg.seed),
                         datamodule=dm, batch_size=cfg.data.batch_size,
                         checkpoint_path=str(folder / "best"))
    by_hand = evaler.Eval(mode="common")
    for metric, got in report["metrics"].items():
        want = by_hand["metrics"][metric]
        check(np.isfinite(got) and abs(got - want) <= CLI_REL_TOL * abs(want),
              f"{tag}: eval CLI {metric} {got} vs the Evaler by hand {want}")
    n_eval_batches = len(dm.test_dataloader())
    eval_calls = (report["model_calls_per_rollout"] * n_eval_batches
                  if name == "tante_adaptive" else cfg.evaler.n_steps_rollout * n_eval_batches)
    check(eval_launches == want_launches(int(eval_calls)) and not eval_other,
          f"{tag}: eval CLI launches {eval_launches} ({eval_other} in other dtypes) for "
          f"{eval_calls} model calls")
    res["eval"] = {"report": report, "evaler_by_hand": by_hand["metrics"],
                   "rel_tol": CLI_REL_TOL, "test_batches": n_eval_batches,
                   "model_calls": eval_calls, "launches": eval_launches}

    # 4: from_experiment with no device serves on the card.
    x = torch.from_numpy(wave_input())
    pred = Predictor.from_experiment(name, experiment=experiment, choose="best",
                                     overrides=ov, config_dir=cdir)
    check(pred.device.type == "cuda" and next(pred.model.parameters()).is_cuda,
          f"{tag}: from_experiment serves on {pred.device}")
    model = instantiate(cfg.model, dset_metadata=md, seed=cfg.seed, device="cpu")
    model.load_state_dict(torch.load(folder / "best" / STATE_FILE, map_location="cpu",
                                     weights_only=True)["params"])
    ref = Predictor(set_compute_dtype(model, torch.bfloat16)
                    if cfg.evaler.get("enable_amp", False) else model)
    out: dict = {"device": str(pred.device), "dtype": str(pred.model.dtype)}
    check(pred.model.dtype == dtype, f"{tag}: from_experiment serves in {pred.model.dtype}, "
                                     f"want {dtype}")
    if name == "tante":
        reset_counts()
        frames = pred.rollout(x, N_STEPS)
        torch.cuda.synchronize()
        out["launches_per_rollout"] = launch_counts(dtype)
        check(launched(dtype, N_STEPS),
              f"{tag}: from_experiment rollout launches {out['launches_per_rollout']}")
        out["equals_predictor_by_hand_bit_for_bit"] = bool(
            torch.equal(frames, ref.rollout(x, N_STEPS)))
    else:
        n = cfg.evaler.n_steps_rollout
        reset_counts()
        frames, rt, n_calls = pred.rollout_adaptive(x, n)
        torch.cuda.synchronize()
        out["launches_per_rollout"] = launch_counts(dtype)
        check(launched(dtype, n_calls),
              f"{tag}: from_experiment adaptive launches {out['launches_per_rollout']} for "
              f"{n_calls} calls")
        evaler.calls = []
        evaler._rollout(x.to(evaler.device))
        out.update(n_calls=n_calls, r_evaler_calls=int(evaler.calls[0][1]), rt=rt.tolist())
        check(n_calls == out["r_evaler_calls"],
              f"{tag}: from_experiment made {n_calls} calls, R_Evaler {out['r_evaler_calls']}")
        out["equals_predictor_by_hand_bit_for_bit"] = bool(
            torch.equal(frames, ref.rollout_adaptive(x, n)[0]))
    check(bool(torch.isfinite(frames).all()), f"{tag}: from_experiment frames not finite")
    check(out["equals_predictor_by_hand_bit_for_bit"],
          f"{tag}: from_experiment differs from the Predictor by hand")
    res["from_experiment"] = out
    return res


def phase_cli(dev, workdir: Path) -> dict:
    """The paper's entry points on the card at the flagship's width: for
    ``configs/tante.yaml`` and ``configs/tante_adaptive.yaml`` as shipped
    (f32: the configs set no enable_amp), the train CLI (one epoch, then a
    resume to two), the eval CLI against the Evaler by hand,
    ``Predictor.from_experiment`` with no device; then ``configs/tante.yaml``
    again in bf16 through the ``CLI_AMP`` overrides (one epoch, eval,
    ``from_experiment``); then each block kernel on the inputs the path gave
    it (f32 and bf16) against its plain version."""
    h5 = h5py_imports()
    cdir, data_ov, route = cli_config_dir(workdir, h5)
    res = {"phase": "cli", "h5py": h5, "data_route": route,
           "cuts": ["data: 2 wave trajectories of 16 frames a split (2 train steps an epoch, "
                    "1 validation batch, 2 test batches at the eval CLI's 4 steps)",
                    "epochs: 1, then a resume to 2 (configs: max_epoch 34)"],
           "dtype": "f32, as the configs ship (no enable_amp overrides): the f32 block kernels",
           "bf16": "configs/tante.yaml with " + " ".join(CLI_AMP) + ": the bf16 block kernels"}
    inputs: dict = {}
    with captured_block_inputs(inputs):
        for name in CLI_CONFIGS:
            res[name] = cli_run(name, dev, workdir, cdir, data_ov)
        res["tante_bf16"] = cli_run("tante", dev, workdir, cdir, data_ov, torch.bfloat16)
    res["kernels_at_the_path_shapes"] = kernels_at_path_shapes(inputs, "cli")
    reached = {(k[0], k[3]) for k in inputs}
    check(reached == {(n, dt) for n in ("fused_block_fwd", "fused_block_canon_t_fwd")
                      for dt in (torch.float32, torch.bfloat16)},
          f"cli path: block kernels reached {sorted(map(str, reached))}")
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The native WellPack loader feeding the card
# ---------------------------------------------------------------------------

# 8 trajectories of 48 frames: 41 windows each, 41 batches of B 8 an epoch
# (a 302 MB cache).  Each loader is timed over whole epochs for at least
# WELLPACK_WINDOW_S seconds, native and Python in turns, WELLPACK_REPEATS times.
WELLPACK_WAVES = dict(resolution=RES, n_trajectories=8, n_steps=48, with_pressure=True, seed=3)
WELLPACK_WINDOW_S = 3.0
WELLPACK_REPEATS = 3


def epoch_to_card(loader, epoch: int) -> list:
    """Every batch of one epoch on the card (synchronised)."""
    loader.set_epoch(epoch)
    batches = list(loader)
    torch.cuda.synchronize()
    return batches


def timed_window(loader, epoch: int, min_s: float) -> tuple[dict, int]:
    """Whole epochs to the card (each batch dropped as the next arrives, a
    sync after each epoch) until ``min_s`` seconds have passed; the window's
    batches, bytes that reached the card, seconds, and the next epoch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = nbytes = epochs = 0
    while True:
        loader.set_epoch(epoch + epochs)
        epochs += 1
        for batch in loader:
            n += 1
            nbytes += sum(t.numel() * t.element_size() for t in batch.values())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if seconds >= min_s:
            return ({"epochs": epochs, "batches": n, "bytes_to_card": nbytes, "seconds": seconds,
                     "batches_per_s": n / seconds, "gb_per_s": nbytes / seconds / 1e9},
                    epoch + epochs)


def spread(values: list) -> dict:
    return {"median": float(np.median(values)), "min": min(values), "max": max(values),
            "runs": values}


def phase_wellpack(dev, workdir: Path) -> dict:
    """A WellPack cache of the 128x384x4 waves written by the port's cache
    writer, the native loader built with g++ into build/, its batches (B 8,
    4 in, 4 out, shuffled, 4 threads) against the Python DataLoader's on the
    card over two epochs, then each loader timed in turns over windows of
    whole epochs (median and spread)."""
    from tante_tpu_torch.data import wellpack
    from tante_tpu_torch.data.loader import DataLoader
    from tante_tpu_torch.data.synthetic import WaveDataset, wave_field_names

    arrays = make_well_arrays(splits=("train",), **WELLPACK_WAVES)["train"]
    traj = arrays[0]
    path = wellpack.write_cache(str(workdir / "waves.wpk"), iter(traj), *traj.shape)
    t0 = time.perf_counter()
    # None when g++ or the load failed: the phase then fails, it never
    # falls back to the Python loader.
    lib = wellpack.get_library()
    build_s = time.perf_counter() - t0
    if lib is None:
        raise RuntimeError("the native wellpack library did not build or load (see the log)")
    kw = dict(batch_size=BATCH, shuffle=True, seed=5)
    native = wellpack.WellPackLoader(path, IN_T, 4, num_threads=4, device=dev, **kw)
    python = DataLoader(WaveDataset(arrays, wave_field_names(2, with_pressure=True), IN_T, 4),
                        num_workers=4, device=dev, **kw)
    res = {"phase": "wellpack", "library": str(Path(lib._name).relative_to(ROOT)),
           "library_build_s": build_s, "cache_bytes": os.path.getsize(path),
           "trajectories": traj.shape[0], "frames": traj.shape[1], "batch": BATCH,
           "batches_per_epoch": len(native),
           "cuts": [f"{traj.shape[0]} trajectories of {traj.shape[1]} frames "
                    f"({len(native)} batches an epoch)",
                    f"timing: {WELLPACK_REPEATS} windows a loader of whole epochs, "
                    f">= {WELLPACK_WINDOW_S} s each, native and Python in turns"]}
    # Epochs 1-2 (two shuffles): every batch against the Python loader's; the
    # first epoch of each loader also warms its thread pool and pinned pool.
    for epoch in (1, 2):
        got, want = epoch_to_card(native, epoch), epoch_to_card(python, epoch)
        check(len(got) == len(want) == len(native) > 0,
              f"wellpack: {len(got)} native batches, {len(want)} Python batches")
        err = max(float((a[k] - b[k]).abs().max()) for a, b in zip(got, want)
                  for k in ("input", "output"))
        check(err == 0.0 and all(a[k].is_cuda for a in got for k in a),
              f"wellpack epoch {epoch}: max abs {err} against the Python loader")
        res[f"epoch_{epoch}_max_abs_err_vs_python_loader"] = err
        del got, want
    windows: dict = {"native": [], "python": []}
    epoch = 3
    for _ in range(WELLPACK_REPEATS):
        for name, loader in (("native", native), ("python", python)):
            window, epoch = timed_window(loader, epoch, WELLPACK_WINDOW_S)
            windows[name].append(window)
    native.close()
    for name, runs in windows.items():
        res[name] = {"windows": runs,
                     "batches_per_s": spread([w["batches_per_s"] for w in runs]),
                     "gb_per_s": spread([w["gb_per_s"] for w in runs])}
    ratios = [a["batches_per_s"] / b["batches_per_s"]
              for a, b in zip(windows["native"], windows["python"])]
    res["native_over_python"] = {
        "of_the_medians": res["native"]["batches_per_s"]["median"]
        / res["python"]["batches_per_s"]["median"],
        "per_turn": spread(ratios)}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The FNO path: spectral_mode_matmul, TANTE with the FNO encoder/decoder, FNO
# ---------------------------------------------------------------------------


def spectral_operands(b, modes, ci, co, layout, dev, seed=0):
    """x_re, x_im (B, *modes, Cin) and w_re, w_im (*modes, Cin, Cout) as a
    call site hands them over.  "stored": the weight as the models keep it,
    (Cin, Cout, *modes, 2), through permuted views of its re / im halves;
    "cw": that, and x channel-major; "contiguous": (M, Cin, Cout) weights."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(dev)

    scale = 1.0 / math.sqrt(ci)
    if layout == "contiguous":
        w_re, w_im = normal(*modes, ci, co, scale=scale), normal(*modes, ci, co, scale=scale)
    else:
        w = normal(ci, co, *modes, 2, scale=scale)
        perm = (*range(2, 2 + len(modes)), 0, 1)
        w_re, w_im = w[..., 0].permute(perm), w[..., 1].permute(perm)
    x_re, x_im = normal(b, *modes, ci), normal(b, *modes, ci)
    if layout == "cw":
        x_re, x_im = (t.transpose(-1, -2).contiguous().transpose(-1, -2) for t in (x_re, x_im))
    return x_re, x_im, w_re, w_im


def spectral_bound(b, modes, ci, co) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, flops, bytes): 8*B*M*Cin*Cout f32 flops
    against x in, out and the weight once each, re and im."""
    m = math.prod(modes)
    flops = 8.0 * b * m * ci * co
    nbytes = 4.0 * (2 * b * m * (ci + co) + 2 * m * ci * co)
    t_ops, t_mem = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


# (label, B, modes, Cin, Cout, layout, on a main path).  Both corners of
# spectral_conv2d share the weight and ride in the batch, hence 2 * frames.
SPECTRAL_CASES = [
    ("TANTE-FNO enc 1, per step", 2 * BATCH, (32, 32), 4, 32, "stored", True),
    ("TANTE-FNO enc 2, per step", 2 * BATCH, (8, 8), 64, 128, "stored", True),
    ("TANTE-FNO dec 1", 2 * BATCH, (8, 8), 128, 64, "stored", True),
    ("TANTE-FNO dec 2", 2 * BATCH, (32, 32), 32, 4, "stored", True),
    ("FNO layer, cw", FNO_BATCH, (20, 11), 48, 48, "cw", True),
    ("FNO layer, wc", FNO_BATCH, (20, 11), 48, 48, "stored", True),
    ("TANTE-FNO enc 1, first window", 2 * BATCH * IN_T, (32, 32), 4, 32, "stored", False),
    ("(M, Cin, Cout) weights", FNO_BATCH, (220,), 48, 48, "contiguous", False),
    ("UNO width 38", 4, (32, 33), 38, 76, "stored", False),
    ("ragged B=1", 1, (7,), 4, 4, "contiguous", False),
    ("ragged B=3", 3, (13, 5), 38, 48, "stored", False),
    ("ragged cw", 3, (5, 3), 128, 38, "cw", False),
    ("three mode axes", 9, (4, 3, 5), 48, 128, "stored", False),
]


def phase_spectral_kernel(dev) -> list[dict]:
    results = []
    for i, (label, b, modes, ci, co, layout, main) in enumerate(SPECTRAL_CASES):
        args = spectral_operands(b, modes, ci, co, layout, dev, seed=400 + i)
        run = lambda: fs.spectral_mode_matmul(*args)  # noqa: E731
        plain = lambda: fs.spectral_mode_matmul_ref(*args)  # noqa: E731
        before = fs.spectral_mode_matmul.launches
        got = run()
        torch.cuda.synchronize()
        launched = fs.spectral_mode_matmul.launches - before
        want = plain()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = launched == 1 and all(
            bool(torch.isfinite(g).all())
            and bool(((g - w).abs() <= SPECTRAL_ATOL + SPECTRAL_RTOL * w.abs()).all())
            for g, w in zip(got, want))
        check(ok, f"spectral_mode_matmul {label} disagrees with its plain version")
        res = {"phase": "spectral_kernel", "case": label, "B": b, "modes": list(modes),
               "Cin": ci, "Cout": co, "layout": layout, "main_path": main, "max_abs_err": err,
               "tolerance": f"|k - plain| <= {SPECTRAL_ATOL} + {SPECTRAL_RTOL}*|plain|", "ok": ok}
        if main:
            # The one PyTorch call that computes the same function: a complex
            # einsum on contiguous complex64 operands (made outside the timing).
            xc = torch.complex(args[0], args[1]).reshape(b, -1, ci).contiguous()
            wc = torch.complex(args[2], args[3]).reshape(-1, ci, co).contiguous()
            lib = torch.einsum("bmi,mio->bmo", xc, wc)
            lib_err = max(float((lib.real.reshape(got[0].shape) - got[0]).abs().max()),
                          float((lib.imag.reshape(got[1].shape) - got[1]).abs().max()))
            check(lib_err <= 1e-3, f"spectral_mode_matmul {label} disagrees with the complex einsum")
            b_ms, b_by, flops, nbytes = spectral_bound(b, modes, ci, co)
            library = lambda: torch.einsum("bmi,mio->bmo", xc, wc)  # noqa: E731
            # These calls are shorter on the card than their enqueue on the
            # host: *_ms is the device time (profiler), *_call_ms the time per
            # call of back-to-back calls (CUDA events), which the host paces.
            k_ms, lib_ms = device_ms(run), device_ms(library)
            res.update({
                "kernel_ms": k_ms, "plain_ms": device_ms(plain), "library_ms": lib_ms,
                "kernel_over_library": k_ms / lib_ms,
                "kernel_call_ms": cuda_ms(run, iters=200),
                "plain_call_ms": cuda_ms(plain, iters=50),
                "library_call_ms": cuda_ms(library, iters=100),
                "library_call": "torch.einsum('bmi,mio->bmo') on complex64",
                "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
                "achieved_gbytes_per_s": nbytes / k_ms / 1e6})
        emit(res)
        results.append(res)

    # Gradients of the Function (kernel forward, plain version differentiated)
    # against ordinary autograd through the plain version.
    grad = {}
    for label, b, modes, ci, co, layout, _ in (SPECTRAL_CASES[1], SPECTRAL_CASES[4]):
        args = spectral_operands(b, modes, ci, co, layout, dev, seed=77)
        cot = [torch.randn((b, *modes, co), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(k)) for k in (1, 2)]

        def grads(fn):
            leaves = [t.detach().requires_grad_(True) for t in args]
            o_re, o_im = fn(*leaves)
            ((o_re * cot[0]).sum() + (o_im * cot[1]).sum()).backward()
            return [t.grad for t in leaves]

        before = fs.spectral_mode_matmul.launches
        got = grads(fs.spectral_mode_matmul)
        launched = fs.spectral_mode_matmul.launches - before
        errs = [rel_l2(g, w) for g, w in zip(got, grads(fs.spectral_mode_matmul_ref))]
        ok = launched == 1 and max(errs) <= SPECTRAL_GRAD_TOL
        check(ok, f"spectral_mode_matmul gradients ({label}): rel L2 {errs}, {launched} launches")
        grad[label] = {"rel_l2_x_re_x_im_w_re_w_im": errs, "launches_forward_and_backward": launched,
                       "ok": ok}
    emit({"phase": "spectral_grad", "rel_l2_tolerance": SPECTRAL_GRAD_TOL, "cases": grad})
    return results


def fno_model(dtype, device, md=None, layout="cw") -> FNO:
    return FNO(dset_metadata=md or metadata(), dtype=dtype, layout=layout, device=device,
               **FNO_KW)


def phase_fno_serving(dev) -> dict:
    """``Predictor.rollout`` on TANTE with the FNO encoder/decoder at flagship
    width and on FNO at ``configs/fno.yaml`` width, seeded weights."""
    out = {}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(BATCH, IN_T, *RES, FIELDS)).astype(np.float32)).to(dev)

    def serve(label, pred, ref_pred, x, want_blocks, want_spectral, derive):
        batch = x.shape[0]
        roll = lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)  # noqa: E731
        for _ in range(2):
            roll()
        torch.cuda.synchronize()
        reset_counts()
        y = roll()
        torch.cuda.synchronize()
        blocks, spectral = launch_counts(), fs.spectral_mode_matmul.launches
        check(blocks == want_blocks, f"{label}: block launches {blocks}, want {want_blocks}")
        check(spectral == want_spectral,
              f"{label}: {spectral} spectral_mode_matmul launches, want {want_spectral}")
        finite = bool(torch.isfinite(y).all())
        check(finite and tuple(y.shape) == (batch, N_STEPS, *RES, FIELDS),
              f"{label}: output shape / finiteness")
        tm = timed_rollouts(roll)
        prof = trace(roll, top=6)
        prof.update(host_split(roll))
        # The same weights in f32 on the CPU, one sample, 2 steps.
        ref = ref_pred.rollout(x[:1].cpu(), 2)
        got = pred.rollout(x[:1], 2).float().cpu()
        u = x[:1, -1:].cpu() if derive else 0.0
        err = rel_l2(got - u, ref - u)
        check(err <= ROLLOUT_REL_TOL, f"{label} vs CPU f32: rel L2 {err}")
        frames = batch * N_STEPS
        res = {"phase": "fno_serving", "model": label, "batch": batch, "n_steps": N_STEPS,
               "dtype": "bf16 (mode space and spectral weights f32)",
               "weights": "seeded (numpy seed 0)", "output_shape": list(y.shape),
               "finite": finite, "block_launches_per_rollout": blocks,
               "spectral_mode_matmul_launches_per_rollout": spectral,
               "ms_per_rollout": 1e3 * tm["median_s"], "frames_per_s": frames / tm["median_s"],
               "frames_per_s_range": [frames / tm["max_s"], frames / tm["min_s"]],
               "timed_rollouts": tm["calls"],
               ("change_vs_cpu_f32_rel_l2" if derive else "frames_vs_cpu_f32_rel_l2"): err,
               "rel_l2_tolerance": ROLLOUT_REL_TOL, "trace": prof}
        emit(res)
        return res

    # TANTE, FNO encoder/decoder, on physical frames (no Morton route).  Mode
    # mixing per rollout: the first window's encode (2 spectral layers), then
    # per step the decoder (2) and the encode of the new frame (2):
    # 2 + 16 * 4 = 66.  The backbone is the fixed lane's: 6 + 3 blocks a call.
    kw = dict(enc_dec_type="fno", modes1=FNO_MODES, modes2=FNO_MODES)
    model = flagship(True, torch.bfloat16, dev, **kw)
    flat = seeded_jax_params(model, seed=0)
    out["tante_fno"] = serve(
        "TANTE(enc_dec_type='fno', deg=True), embed 256, modes 32, patch_scale 8",
        Predictor.from_numpy(model, flat),
        Predictor.from_numpy(flagship(True, torch.float32, "cpu", **kw), flat, device="cpu"), x,
        {"fused_block_fwd": 6 * N_STEPS, "fused_block_canon_t_fwd": 3 * N_STEPS,
         "fused_chain_apply": 0, "fused_group_apply": 0},
        2 + N_STEPS * 4, derive=True)
    del model

    # FNO: one mode mixing per layer per model call: 16 * 4 = 64, no block.
    none = dict.fromkeys(launch_counts(), 0)
    for layout in ("cw", "wc"):
        model = fno_model(torch.bfloat16, dev, layout=layout)
        flat = seeded_jax_params(model, seed=0)
        out[f"fno_{layout}"] = serve(
            f"FNO(hidden 48, modes 20, 4 layers, layout='{layout}')",
            Predictor.from_numpy(model, flat),
            Predictor.from_numpy(fno_model(torch.float32, "cpu", layout=layout), flat,
                                 device="cpu"),
            x[:FNO_BATCH], none, N_STEPS * FNO_KW["n_layers"], derive=False)
    return out


# ---------------------------------------------------------------------------
# Overlapping patch convs and the packed enc/dec API
# ---------------------------------------------------------------------------

OVERLAP = 0.5      # stride 1 at every stage of the flagship pyramid (0.25 rounds to stride 2)
FNO_OVERLAP = 0.25  # FNO_PATCH_MAP[8] = (4, 2): stage 0 stride 3, pad 1
# The overlap Trainer step (f32 both sides): loss and gradient norm of one
# sample against the CPU, relative.
OVERLAP_LOSS_REL_TOL, OVERLAP_GNORM_REL_TOL = 1e-3, 1e-2


@contextlib.contextmanager
def labelled_ops(model: TANTE):
    """Named ranges for ``torch.profiler`` while the block is open: each
    conv, transposed conv, pool and resize the patch convs call
    (``op.<function>``), each encode and each decoder call of ``model``."""
    from torch.profiler import record_function

    def label(fn, name):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    decoders = [getattr(model, f"decoders_{i}") for i in range(model.taylor_order)]
    model.encode = label(model.encode, "model.encode")  # the instance's, over the method
    for d in decoders:
        d.forward = label(d.forward, "model.decode")
    try:
        with wrapped_patch_ops(lambda n, fn: label(fn, f"op.{n}")):
            yield
    finally:
        del model.encode
        for d in decoders:
            del d.forward


def labelled_ranges(fn, model: TANTE, top: int = 10) -> dict:
    """One call of ``fn`` under ``torch.profiler`` with ``labelled_ops``:
    per named range its device ms (the kernels launched inside it) and
    count; the PyTorch operators that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with labelled_ops(model), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = {e.key: {"device_ms": e.device_time_total / 1e3, "count": e.count}
              for e in cpu if e.key.startswith(("op.", "model."))}
    ops = sorted((e for e in cpu if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)
    return {"ranges": ranges,
            "top_operators": [{"name": e.key, "count": e.count,
                               "self_device_ms": e.self_device_time_total / 1e3}
                              for e in ops[:top]]}


def overlap_lane(label: str, pred: Predictor, x: torch.Tensor, dtype, want_blocks: dict,
                 want_spectral: int, ref: torch.Tensor, tol: float) -> dict:
    """``Predictor.rollout`` B 8 x 16 steps: exact launches of the block
    kernels in ``dtype`` (none in another) and of the mode-mixing kernel,
    shape and finiteness, frames/s, the trace (device time, busy share, top
    kernels) and the named ranges; the first two calls of one sample
    against ``ref`` (the f32 model on the CPU) within ``tol``."""
    f32 = dtype == torch.float32
    roll = lambda: pred.rollout(x, N_STEPS, out_dtype=None if f32 else torch.bfloat16)  # noqa: E731
    for _ in range(2):
        roll()
    torch.cuda.synchronize()
    reset_counts()
    y = roll()
    torch.cuda.synchronize()
    blocks, other = launch_counts(dtype), other_launches(dtype)
    spectral = fs.spectral_mode_matmul.launches
    check(blocks == want_blocks and not other,
          f"{label}: block launches {blocks} ({other} in other dtypes), want {want_blocks}")
    check(spectral == want_spectral,
          f"{label}: {spectral} spectral_mode_matmul launches, want {want_spectral}")
    finite = bool(torch.isfinite(y).all())
    check(finite and tuple(y.shape) == (BATCH, N_STEPS, *RES, FIELDS),
          f"{label}: output shape / finiteness")
    tm = timed_rollouts(roll)
    prof = traced(roll, label, top=12, f32=f32)
    prof.update(host_split(roll))
    prof.update(labelled_ranges(roll, pred.model))
    u = x[:1, -1:].cpu()
    err = rel_l2(pred.rollout(x[:1], 2).float().cpu() - u, ref - u)
    check(err <= tol, f"{label} vs CPU f32: rel L2 {err}")
    return {"lane": label, "dtype": str(dtype)[6:], "output_shape": list(y.shape),
            "finite": finite, "launches_per_rollout": blocks,
            "other_dtype_launches_per_rollout": other,
            "spectral_mode_matmul_launches_per_rollout": spectral, **lane_speed(tm),
            "change_vs_cpu_f32_rel_l2": err, "rel_l2_tolerance": tol, "trace": prof}


def overlap_train_step(dev, workdir: Path) -> dict:
    """One ``Trainer`` step at overlap 0.5 in f32 (``configs/tante.yaml`` as
    shipped: no enable_amp; dropout 0, so the blocks run their kernels
    forward): the first loss and gradient norm of one sample against the
    same weights in f32 on the CPU, then steps on B 8: seconds a step (CUDA
    events), launches a step, peak memory."""
    n_out = 4
    dm = WaveDataModule(
        batch_size=BATCH, n_steps_input=IN_T, n_steps_output=n_out, eval_steps_output=n_out,
        data_workers=2, seed=0, device=dev,
        waves=dict(resolution=RES, n_trajectories=4, n_steps=16, with_pressure=True, seed=0))
    md = dm.train_dataset.metadata
    model = flagship(True, torch.float32, dev, md, dropout=0.0, overlap_ratio=OVERLAP)
    load_jax_params(model, seeded_jax_params(model, seed=0))
    cpu_model = flagship(True, torch.float32, "cpu", md, dropout=0.0, overlap_ratio=OVERLAP)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    trainer = Trainer(str(workdir / "overlap"), "channels_first_default", model, dm,
                      AdamW(lr=5e-5, weight_decay=1e-5), MSE(), L2RE(), max_epoch=1,
                      n_steps_output=n_out, seed=0)
    loader = dm.train_dataloader()
    loader.set_epoch(1)
    batches = [tuple(b[k] for k in ("input", "output")) for b in loader]
    x0, y0 = batches[0]

    loss, gnorm = loss_and_gnorm(model, x0[:1], y0[:1], n_out)
    loss_cpu, gnorm_cpu = loss_and_gnorm(cpu_model, x0[:1].cpu(), y0[:1].cpu(), n_out)
    check(abs(loss - loss_cpu) <= OVERLAP_LOSS_REL_TOL * loss_cpu,
          f"overlap train: first loss {loss} on the card vs {loss_cpu} in f32 on the CPU")
    check(abs(gnorm - gnorm_cpu) <= OVERLAP_GNORM_REL_TOL * gnorm_cpu,
          f"overlap train: gradient norm {gnorm} on the card vs {gnorm_cpu} on the CPU")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for x, y in batches:
        reset_counts()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        losses.append(float(trainer.train_step(x, y)))
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    launches = launch_counts(torch.float32)
    want = {"fused_block_fwd": 6 * n_out, "fused_block_canon_t_fwd": 3 * n_out,
            "fused_chain_apply": 0, "fused_group_apply": 0}
    check(launches == want and not other_launches(torch.float32),
          f"overlap train: launches a step {launches}, want {want} in f32")
    check(all(np.isfinite(losses)), f"overlap train: losses {losses}")
    return {"batch": BATCH, "n_steps_output": n_out, "dtype": "f32 (no enable_amp)",
            "steps": len(ms), "losses": losses, "launches_per_step": launches,
            "seconds_per_step_median": sorted(ms[1:])[len(ms[1:]) // 2] / 1e3,
            "seconds_per_step_all": [m / 1e3 for m in ms],
            "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "first_step_one_sample": {
                "loss": loss, "loss_cpu_f32": loss_cpu, "loss_rel_tol": OVERLAP_LOSS_REL_TOL,
                "grad_norm": gnorm, "grad_norm_cpu_f32": gnorm_cpu,
                "grad_norm_rel_tol": OVERLAP_GNORM_REL_TOL}}


def packed_api(dev, x: torch.Tensor) -> dict:
    """``encode`` / ``head`` with ``packed=True`` at the flagship width, bf16,
    overlap 0: against the plain calls on the same input (equal bits, and
    the largest difference), 6 + 3 block launches a ``head`` call; then the
    fixed lane's Morton rollout with its encode / decode ranges named, the
    reference for the overlap lanes' conv pyramids."""
    model = flagship(True, torch.bfloat16, dev)
    pred = Predictor.from_numpy(model, seeded_jax_params(model, seed=0))
    model = pred.model
    p0 = 2
    check(model.packed_io_ok(), "flagship: packed_io_ok() is False at overlap 0")
    with torch.inference_mode():
        lat = model.encode(x)
        lat_p = model.encode(model_convs.pack_patches(x, p0), packed=True)
        u = x[:, -1:]
        frames = model.head(lat, u)
        torch.cuda.synchronize()
        reset_counts()
        frames_p = model.head(lat, model_convs.pack_patches(u, p0), packed=True)
        torch.cuda.synchronize()
        launches = launch_counts()
    want = {"fused_block_fwd": 6, "fused_block_canon_t_fwd": 3, "fused_chain_apply": 0,
            "fused_group_apply": 0}
    check(launches == want, f"packed head launches {launches}, want {want}")
    packed_frames = model_convs.pack_patches(frames, p0)
    enc_diff = float((lat_p.float() - lat.float()).abs().max())
    head_diff = float((frames_p.float() - packed_frames.float()).abs().max())
    # The same operations on the same operands: nothing but equal bits passes.
    enc_equal, head_equal = torch.equal(lat_p, lat), torch.equal(frames_p, packed_frames)
    check(enc_equal and head_equal,
          f"packed API vs plain: encode {enc_diff}, head {head_diff} apart (want equal bits)")
    roll = lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)  # noqa: E731
    roll()
    return {"dtype": "bf16", "overlap_ratio": 0.0, "packed_io_ok": True,
            "encode_equals_plain_bit_for_bit": enc_equal, "encode_max_abs_diff": enc_diff,
            "head_equals_packed_plain_bit_for_bit": head_equal, "head_max_abs_diff": head_diff,
            "head_launches_per_call": launches,
            "morton_rollout": {"morton_io_ok": model.morton_io_ok(),
                               **trace(roll, top=6), **labelled_ranges(roll, model)}}


def phase_overlap(dev, workdir: Path) -> dict:
    """Overlapping patch convs at full width: (a) the flagship at overlap
    0.5 in bf16 and (b) in f32 through ``Predictor.rollout`` (96 + 48 block
    launches a rollout, the first calls against the f32 CPU model), (c) one
    f32 ``Trainer`` step at overlap 0.5, (d) TANTE-FNO (modes 32) at overlap
    0.25 in bf16 (66 mode-mixing + 96 + 48 launches), (e) the packed
    enc/dec API at overlap 0 against the plain calls."""
    t0 = time.perf_counter()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(BATCH, IN_T, *RES, FIELDS)).astype(np.float32)).to(dev)
    blocks = {"fused_block_fwd": 6 * N_STEPS, "fused_block_canon_t_fwd": 3 * N_STEPS,
              "fused_chain_apply": 0, "fused_group_apply": 0}
    out = {}
    cpu_model = flagship(True, torch.float32, "cpu", overlap_ratio=OVERLAP)
    flat = seeded_jax_params(cpu_model, seed=0)
    ref = Predictor.from_numpy(cpu_model, flat, device="cpu").rollout(x[:1].cpu(), 2)
    for key, dtype, tol in (("bf16", torch.bfloat16, ROLLOUT_REL_TOL),
                            ("f32", torch.float32, F32_ROLLOUT_REL_TOL)):
        pred = Predictor.from_numpy(flagship(True, dtype, dev, overlap_ratio=OVERLAP), flat)
        check(not pred.model.morton_io_ok() and not pred.model.packed_io_ok(),
              "overlap: a packed gate is open")
        out[key] = overlap_lane(f"overlap {OVERLAP} {key}", pred, x, dtype, blocks, 0, ref, tol)
        out[key]["t_s"] = time.perf_counter() - t0
        del pred
    out["train"] = overlap_train_step(dev, workdir)
    out["train"]["t_s"] = time.perf_counter() - t0
    kw = dict(enc_dec_type="fno", modes1=FNO_MODES, modes2=FNO_MODES, overlap_ratio=FNO_OVERLAP)
    model = flagship(True, torch.bfloat16, dev, **kw)
    flat = seeded_jax_params(model, seed=0)
    ref = Predictor.from_numpy(flagship(True, torch.float32, "cpu", **kw), flat,
                               device="cpu").rollout(x[:1].cpu(), 2)
    out["fno"] = overlap_lane(f"TANTE-FNO overlap {FNO_OVERLAP} bf16",
                              Predictor.from_numpy(model, flat), x, torch.bfloat16, blocks,
                              2 + N_STEPS * 4, ref, ROLLOUT_REL_TOL)
    out["fno"]["t_s"] = time.perf_counter() - t0
    del model
    out["packed_api"] = packed_api(dev, x)
    res = {"phase": "overlap", "batch": BATCH, "n_steps": N_STEPS,
           "weights": "seeded (numpy seed 0)", "overlap_ratio": OVERLAP,
           "fno_overlap_ratio": FNO_OVERLAP, **out, "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def phase_fno_train_eval(dev, workdir: Path) -> dict:
    """``Trainer`` on FNO (``configs/fno.yaml``: B=4, 4 rollout steps per train
    step, 8 per evaluation; AdamW at a constant 1e-3 so that eight steps move
    the loss visibly) over in-memory waves, then ``Evaler`` on what it saved."""
    n_out, n_roll, layers = 4, 8, FNO_KW["n_layers"]
    dm = WaveDataModule(
        batch_size=FNO_BATCH, n_steps_input=IN_T, n_steps_output=n_out, eval_steps_output=n_roll,
        data_workers=4, seed=0, device=dev,
        waves=dict(resolution=RES, n_trajectories=2, n_steps=16, with_pressure=True, seed=0))
    md = dm.train_dataset.metadata
    mse = MSE()
    model = fno_model(torch.float32, dev, md)
    init_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    trainer = Trainer(str(workdir / "fno"), "channels_first_default", model, dm,
                      AdamW(lr=1e-3, weight_decay=1e-5), mse, L2RE(), max_epoch=2,
                      enable_amp=True, n_steps_output=n_out, n_steps_rollout=n_roll, seed=0)
    loader = dm.train_dataloader()
    loader.set_epoch(1)
    first = list(loader)[0]
    x0, y0 = first["input"], first["output"]

    def eval_loss() -> float:
        with torch.no_grad():
            return float(mse(rollout_fixed(model, x0, n_out, 1).float(), y0).mean())

    loss_gpu, gnorm_gpu = loss_and_gnorm(model, x0[:1], y0[:1], n_out)
    cpu_model = fno_model(torch.float32, "cpu", md)
    cpu_model.load_state_dict(init_state)
    loss_cpu, gnorm_cpu = loss_and_gnorm(cpu_model, x0[:1].cpu(), y0[:1].cpu(), n_out)
    check(abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_REL_TOL * loss_cpu,
          f"FNO first loss {loss_gpu} on the card vs {loss_cpu} in f32 on the CPU")
    check(abs(gnorm_gpu - gnorm_cpu) <= TRAIN_GNORM_REL_TOL * gnorm_cpu,
          f"FNO first gradient norm {gnorm_gpu} on the card vs {gnorm_cpu} in f32 on the CPU")

    before = eval_loss()
    epochs = []
    for epoch in (1, 2):
        loader.set_epoch(epoch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        epoch_loss, _ = trainer.train_one_epoch(epoch, loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        steps = len(loader)
        per_step = fs.spectral_mode_matmul.launches / steps
        # Forward only (backward differentiates the plain version): one mode
        # mixing per layer per rollout step.
        check(per_step == n_out * layers and sum(launch_counts().values()) == 0,
              f"FNO train step: {per_step} spectral launches, want {n_out * layers}")
        epochs.append({"steps": steps, "epoch_train_loss": epoch_loss,
                       "seconds_per_step": seconds / steps,
                       "spectral_mode_matmul_launches_per_step": per_step,
                       "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30})
    after = eval_loss()
    check(np.isfinite(after) and after < before,
          f"FNO loss on the first batch did not fall: {before} -> {after}")
    split = host_split(lambda: trainer.train_step(x0, y0))
    split["trace"] = trace(lambda: trainer.train_step(x0, y0), top=6)

    val = trainer.validation_loop(dm.val_dataloader())
    trainer.save_model(2, val, "recent")
    fns = [MSE(), L2RE(), NNMSE(), VRMSE()]
    evaler = Evaler(str(workdir / "fno"), "channels_first_default", fno_model(torch.float32, dev, md),
                    dm, *fns, enable_amp=True, checkpoint_path=str(workdir / "fno" / "recent"),
                    n_steps_rollout=n_roll)
    same_weights = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), evaler.model.state_dict().values()))
    check(same_weights, "the Evaler did not load the Trainer's weights")
    test_loader = dm.test_dataloader()
    reset_counts()
    report = evaler.Eval()
    torch.cuda.synchronize()
    eval_launches = fs.spectral_mode_matmul.launches
    check(eval_launches == len(test_loader) * n_roll * layers,
          f"Evaler: {eval_launches} spectral launches for {len(test_loader)} batches")
    # Each reported metric is the port's metric function on the same rollout.
    own = {name: [] for name in evaler.loss_names}
    with torch.no_grad():
        for batch in test_loader:
            y = rollout_fixed(evaler.model, batch["input"], n_roll, 1).to(batch["output"].dtype)
            for name, fn in zip(evaler.loss_names, fns):
                own[name].append(float(fn(y, batch["output"]).mean()))
    for name in evaler.loss_names:
        got, want = report["metrics"][name], float(np.mean(own[name]))
        check(np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want),
              f"Evaler {name} {got} vs the metric function on the same rollouts {want}")
        check(np.isfinite(report["variance"][name]), f"Evaler variance of {name} is not finite")
    res = {"phase": "fno_train_eval", "model": "FNO(hidden 48, modes 20, 4 layers, layout='cw')",
           "batch": FNO_BATCH, "n_steps_output": n_out, "n_steps_rollout": n_roll,
           "dtype": "bf16 compute, f32 weights", "optimizer": "AdamW lr 1e-3, weight decay 1e-5",
           "first_step_one_sample": {
               "loss": loss_gpu, "loss_cpu_f32": loss_cpu, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
               "grad_norm": gnorm_gpu, "grad_norm_cpu_f32": gnorm_cpu,
               "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL},
           "first_batch_loss_before": before, "first_batch_loss_after": after,
           "epochs": epochs, "train_step": split, "validation_loss": val,
           "evaler": {"report": report, "test_batches": len(test_loader),
                      "spectral_mode_matmul_launches": eval_launches,
                      "metric_functions_on_the_same_rollouts": {
                          k: float(np.mean(v)) for k, v in own.items()}}}
    emit(res)
    return res

# ---------------------------------------------------------------------------
# The attention family: packed_attention, AViT, CViT
# ---------------------------------------------------------------------------

# AViT at configs/avit.yaml width (embed 384, 6 heads, 12 blocks, drop path
# 0.2, in_T 4) and CViT at configs/cvit.yaml width, on 256 x 256 frames of 8
# fields (the configs' active_matter geometry; the synthetic waves cannot make
# its 11 fields).  Both axial attentions of an AViT block have L = 16 and
# heads * L = 96 <= 128: 24 packed_attention launches per model call.
WELL_RES, WELL_B = (256, 256), 4
WELL_WAVES = dict(resolution=WELL_RES, n_trajectories=1, n_steps=16, with_t2=True,
                  with_pressure=True, seed=0)
AVIT_KW = dict(in_T=IN_T, patch_size=(16, 16), processor_blocks=12, embed_dim=384, num_heads=6,
               drop_path=0.2)
CVIT_KW = dict(in_T=IN_T, out_steps=4, patch_size=(1, 16, 16), grid_size=(128, 128),
               latent_dim=512, emb_dim=512, depth=10, num_heads=8, dec_emb_dim=512,
               dec_num_heads=8, dec_depth=1, num_mlp_layers=1, mlp_ratio=1,
               embedding_type="grid")
# Kernel vs plain: f32 sums in another order; in bf16 the plain version rounds
# its AV product to bf16 where the kernel accumulates in f32 and rounds once.
PACKED_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
PACKED_GRAD_TOL = 1e-5  # the Function's backward IS the plain version's
AVIT_CALL_REL_TOL = 1e-3  # f32 on the card vs f32 on the CPU, first model call
AVIT_LOSS_REL_TOL, AVIT_GNORM_REL_TOL = 1e-3, 1e-2
CVIT_REL_TOL = 5e-2  # bf16 on the card vs f32 on the CPU
METRIC_REL_TOL = 1e-5


def packed_bound(s, heads, l, d, causal, dtype) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, flops, bytes): q, k, v read and the output
    written once; 4 * D flops per admitted (query, key) pair of a head, over
    the peak of the operands' type (f32 outside the tensor cores, bf16 in)."""
    pairs = l * (l + 1) / 2 if causal else l * l
    flops = 4.0 * s * heads * pairs * d
    nbytes = 4.0 * s * heads * l * d * torch.finfo(dtype).bits / 8
    t_ops = flops / (PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS)
    t_mem = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def packed_cases() -> list[tuple]:
    """(label, S, heads, L, D, dtype, causal, form).  ``form`` "packed" is the
    (S, P, D) signature; "row" and "column" are AViT's launches, on its main
    path: ``packed_head_attention`` on strided q / k / v slices of one
    (B', H, W, heads, 3D) projection, and on their (H, W)-transposed views."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("AViT axial attention, row views", 256, 6, 16, 64, f32, False, "row"),
             ("AViT axial attention, column views", 256, 6, 16, 64, f32, False, "column"),
             ("AViT axial attention (256, 96, 64)", 256, 6, 16, 64, f32, False, "packed")]
    for dtype in (f32, bf16):
        for causal in (False, True):
            cases += [("tests/test_pallas_kernels.py (10, 128, 32)", 10, 8, 16, 32, dtype, causal,
                       "packed"),
                      ("tests/test_pallas_kernels.py (7, 16, 16)", 7, 4, 4, 16, dtype, causal,
                       "packed")]
    cases += [("TransformerBlock (1536, 128, 32)", 1536, 8, 16, 32, bf16, causal, "packed")
              for causal in (False, True)]
    return cases


def packed_operands(i, s, heads, l, d, dtype, causal, form, dev):
    """(kernel, plain, SDPA) closures on the case's inputs; outputs compare
    after ``.reshape(S, heads * L, D)`` (the same element order for all three)."""
    rng = np.random.default_rng(500 + i)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if form == "packed":
        q, k, v = (torch.from_numpy(rng.normal(size=(s, heads * l, d)).astype(np.float32))
                   .to(dev, dtype) for _ in range(3))
        q = q * d**-0.5
        q4, k4, v4 = (t.view(s, heads, l, d) for t in (q, k, v))
        return (lambda: fa.packed_attention(q, k, v, l, causal),
                lambda: fa.packed_attention_ref(q, k, v, l, causal),
                lambda: sdpa(q4, k4, v4, is_causal=causal, scale=1.0))
    side = math.isqrt(s)  # B' = H = W = L: the (B', H, W) grid of an AViT block
    fused = torch.from_numpy(rng.normal(size=(side, side, l, heads, 3 * d)).astype(np.float32))
    q, k, v = fused.to(dev, dtype).chunk(3, dim=-1)  # (B', H, W, heads, D) strided slices
    if form == "column":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    q5, k5, v5 = (t.transpose(-3, -2) for t in (q, k, v))  # (B', H, heads, W, D) views
    return (lambda: fa.packed_head_attention(q, k, v, causal),
            lambda: fa._head_ref(q, k, v, causal),
            lambda: sdpa(q5, k5, v5, is_causal=causal).transpose(-3, -2))


def phase_packed_kernel(dev) -> list[dict]:
    """The kernel against its plain version on the same inputs; the times of
    kernel, plain version and SDPA (the yardstick: the same function on the
    (S, heads, L, D) view) by CUDA events over 100 calls queued behind a
    spin of the card, L2-warm (back to back) and L2-cold (a 128 MB write
    before each call), beside the bound and its share of the cold time; no
    operand copied on AViT's views."""
    results = []
    scrub = torch.empty(SCRUB_BYTES // 4, device=dev)
    for i, (label, s, heads, l, d, dtype, causal, form) in enumerate(packed_cases()):
        p = heads * l
        run, plain, library = packed_operands(i, s, heads, l, d, dtype, causal, form, dev)
        before, copies = fa.packed_attention.launches, fa.packed_attention.copies
        got = run()
        torch.cuda.synchronize()
        launched = fa.packed_attention.launches - before
        copied = fa.packed_attention.copies - copies
        want = plain()
        err = (got.float() - want.float()).abs()
        atol, rtol = PACKED_TOL[dtype]
        equal = torch.equal(run(), got)
        ok = (launched == 1 and copied == 0 and equal and bool(torch.isfinite(got).all())
              and bool((err <= atol + rtol * want.float().abs()).all()))
        check(ok, f"packed_attention {label} {dtype} causal={causal} disagrees with its plain "
                  f"version, copied {copied} operands or differs between two launches (max abs "
                  f"err {float(err.max())})")
        lib_err = float((library().reshape(s, p, d).float()
                         - want.reshape(s, p, d).float()).abs().max())
        b_ms, b_by, flops, nbytes = packed_bound(s, heads, l, d, causal, dtype)
        k_ms, k_cold = event_ms(run), event_ms(run, flush=scrub.zero_)
        res = {"phase": "packed_kernel", "case": label, "form": form, "S": s, "P": p, "L": l,
               "D": d, "heads": heads, "dtype": str(dtype).replace("torch.", ""),
               "causal": causal, "main_path": form != "packed", "max_abs_err": float(err.max()),
               "tolerance": f"|k - plain| <= {atol} + {rtol}*|plain|", "ok": ok,
               "operands_copied": copied, "two_launches_equal": equal,
               "times_are": "CUDA events over 100 calls queued behind a spin of the card; "
                            "cold: a 128 MB write before each call",
               "kernel_ms": k_ms, "kernel_cold_ms": k_cold, "plain_ms": event_ms(plain),
               "library_ms": event_ms(library),
               "library_cold_ms": event_ms(library, flush=scrub.zero_),
               "library_call": "torch.nn.functional.scaled_dot_product_attention on the "
                               "(S, heads, L, D) view", "library_max_abs_err": lib_err,
               "kernel_call_ms": cuda_ms(run, iters=100), "plain_call_ms": cuda_ms(plain, 20),
               "library_call_ms": cuda_ms(library, iters=100), "bound_us": 1e3 * b_ms,
               "bound_by": b_by, "bound_share_cold": b_ms / k_cold,
               "warm_beats_hbm_bound_l2_served": k_ms < b_ms, "flops": flops, "bytes": nbytes,
               "achieved_gbytes_per_s_cold": nbytes / k_cold / 1e6}
        emit(res)
        results.append(res)
    return results


def phase_packed_grad(dev) -> dict:
    """Gradients through the Function (kernel forward, plain backward)
    against autograd through the plain version, f32: the packed form at the
    AViT shape (causal), and AViT's operands (strided q / k / v slices of one
    projection, row and column views)."""
    rng = np.random.default_rng(77)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    s, heads, l, d = 256, 6, 16, 64
    packed = [normal(s, heads * l, d) for _ in range(3)]
    fused = normal(16, 16, 16, heads, 3 * d)  # (B', H, W, heads, 3D): q | k | v per head

    def axial(fn, leaf):
        q, k, v = leaf.chunk(3, dim=-1)
        return fn(q, k, v) + fn(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)

    cases = {
        "packed (256, 96, 64), causal": (
            packed, lambda a, b, c: fa.packed_attention(a, b, c, l, True),
            lambda a, b, c: fa.packed_attention_ref(a, b, c, l, True), 1),
        "AViT row + column views of one projection": (
            [fused], lambda f: axial(fa.packed_head_attention, f),
            lambda f: axial(lambda a, b, c: fa._head_ref(a, b, c, False), f), 2),
    }
    out = {}
    for label, (args, kernel, plain, want_launches) in cases.items():
        def grads(fn):
            leaves = [t.detach().requires_grad_(True) for t in args]
            y = fn(*leaves)
            (y * torch.cos(y.detach())).sum().backward()
            return [t.grad for t in leaves]

        before = fa.packed_attention.launches
        got = grads(kernel)
        torch.cuda.synchronize()
        launched = fa.packed_attention.launches - before
        errs = [rel_l2(g, w) for g, w in zip(got, grads(plain))]
        ok = launched == want_launches and max(errs) <= PACKED_GRAD_TOL
        check(ok, f"packed_attention gradients ({label}): rel L2 {errs}, {launched} launches")
        out[label] = {"rel_l2": errs, "launches_forward_and_backward": launched, "ok": ok}
    res = {"phase": "packed_grad", "dtype": "f32", "rel_l2_tolerance": PACKED_GRAD_TOL,
           "cases": out}
    emit(res)
    return res


def well_datamodule(dev) -> WaveDataModule:
    return WaveDataModule(batch_size=WELL_B, n_steps_input=IN_T, n_steps_output=4,
                          eval_steps_output=8, data_workers=4, seed=0, device=dev,
                          waves=WELL_WAVES)


def well_history(dev) -> torch.Tensor:
    """(4, 4, 256, 256, 8) f32: the first frames of four wave trajectories."""
    arrays = make_well_arrays(splits=("train",), **{**WELL_WAVES, "n_trajectories": WELL_B})
    return torch.from_numpy(np.ascontiguousarray(arrays["train"][0][:, :IN_T])).to(dev)


def attention_counts() -> dict:
    """Launches of every wrapper since the last reset (the eight kernels)."""
    return {**launch_counts(), "spectral_mode_matmul": fs.spectral_mode_matmul.launches,
            "packed_attention": fa.packed_attention.launches, **tp_counts()}


def serve_lane(label, pred, x, want_packed, frames_out_dtype=None) -> dict:
    """``Predictor.rollout`` of 16 steps: the launches of one rollout (every
    other wrapper 0), frames/s, the profile."""
    roll = lambda: pred.rollout(x, N_STEPS, out_dtype=frames_out_dtype)  # noqa: E731
    roll()
    torch.cuda.synchronize()
    reset_counts()
    y = roll()
    torch.cuda.synchronize()
    launches = attention_counts()
    want = {**dict.fromkeys(launches, 0), "packed_attention": want_packed}
    check(launches == want, f"{label}: launches {launches}, want {want}")
    copies = fa.packed_attention.copies
    check(copies == 0, f"{label}: the attention wrapper copied {copies} operands")
    finite = bool(torch.isfinite(y).all())
    check(finite and tuple(y.shape) == (x.shape[0], N_STEPS, *x.shape[2:]),
          f"{label}: output shape / finiteness")
    tm = timed_rollouts(roll)
    prof = trace(roll, top=6)
    prof.update(host_split(roll))
    frames = x.shape[0] * N_STEPS
    return {"launches_per_rollout": launches, "packed_attention_copies": copies,
            "output_shape": list(y.shape), "finite": finite,
            "ms_per_rollout": 1e3 * tm["median_s"], "frames_per_s": frames / tm["median_s"],
            "frames_per_s_range": [frames / tm["max_s"], frames / tm["min_s"]],
            "timed_rollouts": tm["calls"], "trace": prof}


def timed_epoch(trainer: Trainer, loader) -> dict:
    """One epoch through ``train_one_epoch`` with the launches counted, then
    the same batches step by step under CUDA events."""
    loader.set_epoch(1)
    batches = [(b["input"], b["output"]) for b in loader]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    epoch_loss, logs = trainer.train_one_epoch(1, loader)
    torch.cuda.synchronize()
    launches = attention_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = []
    for x, y in batches:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_step(x, y)
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    split = host_split(lambda: trainer.train_step(*batches[0]))
    split["trace"] = trace(lambda: trainer.train_step(*batches[0]), top=6)
    check(np.isfinite(epoch_loss), "training loss is not finite")
    steps = len(batches)
    return {"steps": steps, "epoch_train_loss": epoch_loss,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "seconds_per_step_median": sorted(ms)[len(ms) // 2] / 1e3,
            "seconds_per_step_all": [m / 1e3 for m in ms],
            "peak_memory_allocated_gb": peak / 2**30, **split}


def evaler_report(label, evaler: Evaler, fns, test_loader, rollout, want_packed) -> dict:
    """The Evaler's report, its launches, and each metric against the metric
    function on the same rollouts (``rollout(x, y)``)."""
    reset_counts()
    report = evaler.Eval()
    torch.cuda.synchronize()
    launches = fa.packed_attention.launches
    check(launches == want_packed, f"{label} Evaler: {launches} packed launches, want "
                                   f"{want_packed}")
    own = {name: [] for name in evaler.loss_names}
    with torch.no_grad():
        for batch in test_loader:
            y = rollout(batch["input"], batch["output"]).to(batch["output"].dtype)
            for name, fn in zip(evaler.loss_names, fns):
                own[name].append(float(fn(y, batch["output"]).mean()))
    for name in evaler.loss_names:
        got, want = report["metrics"][name], float(np.mean(own[name]))
        check(np.isfinite(got) and abs(got - want) <= METRIC_REL_TOL * abs(want),
              f"{label} Evaler {name} {got} vs the metric function on the same rollouts {want}")
        check(np.isfinite(report["variance"][name]), f"{label} Evaler variance of {name}")
    return {"report": report, "test_batches": len(test_loader), "packed_attention_launches":
            launches, "metric_functions_on_the_same_rollouts": {
                k: float(np.mean(v)) for k, v in own.items()}}


def avit_model(device, md, **kw) -> AViT:
    return AViT(dset_metadata=md, device=device, **{**AVIT_KW, **kw})


def phase_avit(dev, workdir: Path) -> dict:
    """AViT at configs/avit.yaml width, f32 (AViT has no compute dtype):
    ``Predictor.rollout`` (16 steps = 4 calls, 96 packed launches), ``Trainer``
    (24 forward launches a step), ``Evaler`` on the saved weights."""
    dm = well_datamodule(dev)
    md = dm.train_dataset.metadata
    x = well_history(dev)
    model = avit_model(dev, md)
    per_call = 2 * AVIT_KW["processor_blocks"]  # row and column attention of every block
    calls = math.ceil(N_STEPS / model.output_length)
    flat = seeded_jax_params(model, seed=0)  # LayerScale gammas around 1
    pred = Predictor.from_numpy(model, flat)
    serving = serve_lane("avit", pred, x, want_packed=per_call * calls)
    # The first model call against the same weights in f32 on the CPU.
    cpu = Predictor.from_numpy(avit_model("cpu", md), flat, device="cpu")
    with torch.no_grad():
        got, ref = pred.model(x[:1]).cpu(), cpu.model(x[:1].cpu())
    u = x[:1, -1:].cpu()
    err, change_err = rel_l2(got, ref), rel_l2(got - u, ref - u)
    check(err <= AVIT_CALL_REL_TOL and change_err <= AVIT_CALL_REL_TOL,
          f"AViT first call vs CPU f32: rel L2 {err} (change {change_err})")
    del pred, model, cpu

    # Training: the config's drop path 0.2 (the kernel runs: drop path acts on
    # whole residual branches), AdamW 5e-5 / 1e-5, no AMP, 4 rollout steps.
    mse, fns = MSE(), [MSE(), L2RE(), NNMSE(), VRMSE()]
    loader = dm.train_dataloader()
    loader.set_epoch(1)
    batch0 = next(iter(loader))
    x0, y0 = batch0["input"][:1], batch0["output"][:1]

    # drop path 0: the first loss and gradient norm on the card and on the CPU
    one = {}
    for device in (dev, "cpu"):
        m = avit_model(device, md, drop_path=0.0)
        load_jax_params(m, flat)
        one[str(device)] = loss_and_gnorm(m, x0.to(device), y0.to(device), 4, 4)
        del m
    (loss_gpu, gnorm_gpu), (loss_cpu, gnorm_cpu) = one[str(dev)], one["cpu"]
    check(abs(loss_gpu - loss_cpu) <= AVIT_LOSS_REL_TOL * loss_cpu,
          f"AViT first loss {loss_gpu} on the card vs {loss_cpu} in f32 on the CPU")
    check(abs(gnorm_gpu - gnorm_cpu) <= AVIT_GNORM_REL_TOL * gnorm_cpu,
          f"AViT first gradient norm {gnorm_gpu} on the card vs {gnorm_cpu} on the CPU")

    model = avit_model(dev, md)
    load_jax_params(model, flat)
    trainer = Trainer(str(workdir / "avit"), "channels_first_default", model, dm,
                      AdamW(lr=5e-5, weight_decay=1e-5), mse, L2RE(), max_epoch=1,
                      n_steps_output=4, n_steps_rollout=8, seed=0)
    train = timed_epoch(trainer, loader)
    copies = fa.packed_attention.copies
    want = {**dict.fromkeys(train["launches_per_step"], 0.0), "packed_attention": float(per_call)}
    check(train["launches_per_step"] == want,
          f"AViT train step launches {train['launches_per_step']}, want {want}")
    val = trainer.validation_loop(dm.val_dataloader())
    trainer.save_model(1, val, "recent")
    evaler = Evaler(str(workdir / "avit"), "channels_first_default", avit_model(dev, md), dm,
                    *fns, checkpoint_path=str(workdir / "avit" / "recent"), n_steps_rollout=8)
    test_loader = dm.test_dataloader()
    ev = evaler_report("AViT", evaler, fns, test_loader,
                       lambda xb, yb: rollout_fixed(evaler.model, xb, 8, 4),
                       want_packed=len(test_loader) * 2 * per_call)
    copies += fa.packed_attention.copies + serving["packed_attention_copies"]
    check(copies == 0, f"AViT: the attention wrapper copied {copies} operands")
    res = {"phase": "avit", "packed_attention_copies": copies,
           "config": "configs/avit.yaml width: " + json.dumps(AVIT_KW),
           "data": f"B={WELL_B} of {WELL_RES[0]}x{WELL_RES[1]}x{md.n_fields} synthetic waves "
                   "(with_t2, with_pressure); active_matter's 11 fields cut to 8",
           "dtype": "f32 (AViT has no compute dtype)",
           "weights": "seeded (numpy seed 0), LayerScale gammas around 1", "serving": serving,
           "first_call_vs_cpu_f32_rel_l2": err, "first_call_change_vs_cpu_f32_rel_l2": change_err,
           "rel_l2_tolerance": AVIT_CALL_REL_TOL,
           "first_step_one_sample_drop_path_0": {
               "loss": loss_gpu, "loss_cpu_f32": loss_cpu, "loss_rel_tol": AVIT_LOSS_REL_TOL,
               "grad_norm": gnorm_gpu, "grad_norm_cpu_f32": gnorm_cpu,
               "grad_norm_rel_tol": AVIT_GNORM_REL_TOL},
           "train_drop_path_0.2": train, "validation_loss": val, "evaler": ev}
    emit(res)
    return res


def cvit_model(device, dtype, md) -> CViT:
    return CViT(dset_metadata=md, dtype=dtype, device=device, **CVIT_KW)


def phase_cvit(dev, workdir: Path) -> dict:
    """CViT at configs/cvit.yaml width in bf16: ``Predictor.rollout`` on the
    full grid, ``Trainer(cvit=True, num_query_points=1024)``, ``Evaler(cvit=True)``.
    Every attention here is unpacked (8 heads x 256 tokens > 128) or a
    cross-attention: this lane launches no hand-written kernel."""
    dm = well_datamodule(dev)
    md = dm.train_dataset.metadata
    x = well_history(dev)
    model = cvit_model(dev, torch.bfloat16, md)
    flat = seeded_jax_params(model, seed=0)
    pred = Predictor.from_numpy(model, flat)
    serving = serve_lane("cvit", pred, x, want_packed=0, frames_out_dtype=torch.bfloat16)
    # The first call's frames at 2048 pixels against the f32 model on the CPU
    # (queries are independent: the point output at those sites).
    h, w = WELL_RES
    sites = np.random.default_rng(0).permutation(h * w)[:2048]
    coords = torch.from_numpy(full_grid_coords(h, w)[sites])
    cpu = Predictor.from_numpy(cvit_model("cpu", torch.float32, md), flat, device="cpu")
    with torch.no_grad():
        got = pred.model(x[:1]).float().cpu().reshape(1, 4, h * w, -1)[:, :, sites]
        ref = cpu.model(x[:1].cpu(), coords)
    err = rel_l2(got, ref)
    check(err <= CVIT_REL_TOL, f"CViT first frames vs CPU f32: rel L2 {err}")
    del pred, model, cpu

    mse, fns = MSE(), [MSE(), L2RE(), NNMSE(), VRMSE()]
    model = cvit_model(dev, torch.float32, md)
    load_jax_params(model, flat)
    trainer = Trainer(str(workdir / "cvit"), "channels_first_default", model, dm,
                      AdamW(lr=5e-5, weight_decay=1e-5), mse, L2RE(), max_epoch=1,
                      enable_amp=True, n_steps_output=4, n_steps_rollout=8, cvit=True,
                      num_query_points=1024, seed=0)
    train = timed_epoch(trainer, dm.train_dataloader())
    check(all(v == 0 for v in train["launches_per_step"].values()),
          f"CViT train step launched kernels: {train['launches_per_step']}")
    t0 = time.perf_counter()
    val = trainer.validation_loop(dm.val_dataloader())
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    check(np.isfinite(val), f"CViT validation loss {val}")
    trainer.save_model(1, val, "recent")
    evaler = Evaler(str(workdir / "cvit"), "channels_first_default",
                    cvit_model(dev, torch.float32, md), dm, *fns, enable_amp=True,
                    checkpoint_path=str(workdir / "cvit" / "recent"), n_steps_rollout=8,
                    cvit=True, num_query_points=1024)
    ev = evaler_report("CViT", evaler, fns, dm.test_dataloader(),
                       lambda xb, yb: cvit_full_grid_rollout(evaler.model, xb, yb.shape, 8, 1024),
                       want_packed=0)
    res = {"phase": "cvit", "config": "configs/cvit.yaml width: " + json.dumps(CVIT_KW),
           "data": f"B={WELL_B} of {WELL_RES[0]}x{WELL_RES[1]}x{md.n_fields} synthetic waves",
           "dtype": "bf16 compute (f32 weights; RBF logits, embeddings and latents f32)",
           "hand_written_kernels": "none: 8 heads x 256 tokens > 128, every attention takes "
                                   "the unpacked or the cross-attention branch",
           "serving": serving, "first_frames_vs_cpu_f32_rel_l2": err,
           "rel_l2_tolerance": CVIT_REL_TOL, "train_enable_amp": train,
           "validation_loss": val, "validation_seconds": val_s, "evaler": ev}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The rest of the zoo: AFNO, DPOT, UNetConvNext, AttentionUNet at their
# shipped configs' widths, f32 as shipped.  None of them reaches a Pallas
# kernel in JAX, so none launches a hand-written kernel here.
# ---------------------------------------------------------------------------

ZOO_CONFIGS = ("afno", "dpot", "unet_convnext", "unet_att")
ZOO_CALL_REL_TOL = 1e-3   # f32 on the card (TF32 off) vs f32 on the CPU, first model call
ZOO_LOSS_REL_TOL, ZOO_GNORM_REL_TOL = 1e-3, 1e-2  # AViT's f32 rule
ZOO_STATS_REL_TOL = 1e-3  # AttentionUNet's running statistics after that step, per tensor
# Model calls of the first-step check.  AttentionUNet's gradient grows ~10x a
# rollout step at initialisation, and f32 decides it only so far: against
# float64 its gradient norm is off by 4.7e-4 after one call and 1.1e-1 after
# four (tante_tpu_torch/tools/zoo_conditioning.py --batch 1, on the CPU), so
# its check takes one call; the others take the Trainer's four.
ZOO_CHECK_CALLS = {"afno": 4, "dpot": 4, "unet_convnext": 4, "unet_att": 1}


def zoo_model(name: str, device, md):
    """The model of ``configs/<name>.yaml`` as shipped (its ``model`` node)."""
    from tante_tpu_torch.config import instantiate, load_config

    return instantiate(load_config(name).model, dset_metadata=md, device=device)


def first_step(model, x, y, calls: int) -> dict:
    """One sample's first training loss (``calls`` rollout steps, train mode:
    batch statistics, which move the running ones) and gradient norm, and the
    model's buffers after it."""
    pred = rollout_fixed(lambda w: model(w, deterministic=False), x, calls,
                         int(model.output_length))
    loss = MSE()(pred, y[:, :calls]).mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    gnorm = float(global_norm(model.parameters()))
    model.zero_grad(set_to_none=True)
    return {"loss": float(loss.detach()), "grad_norm": gnorm,
            "buffers": {k: b.detach().float().cpu() for k, b in model.named_buffers()}}


def zoo_cli(name: str, dev, workdir: Path, cdir: Path) -> dict:
    """``cli.train.main`` for one epoch on a copy of ``configs/<name>.yaml``
    whose only change is the data node (the in-memory waves of this phase),
    then ``Predictor.from_experiment`` with no device against a Predictor
    built by hand from the same ``state.pt``, on a 16-step rollout."""
    import yaml

    from tante_tpu_torch.cli import train as cli_train
    from tante_tpu_torch.config import CONFIG_DIR, instantiate, load_config
    from tante_tpu_torch.utils.checkpoint import STATE_FILE

    with open(os.path.join(CONFIG_DIR, name + ".yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"] = {"_target_": "tante_tpu_torch.data.WaveDataModule", "batch_size": WELL_B,
                   "n_steps_input": IN_T, "n_steps_output": 4, "eval_steps_output": 8,
                   "data_workers": 4, "dataset_name": "synthetic_waves",
                   "waves": {**WELL_WAVES, "resolution": list(WELL_RES)}}
    with open(cdir / f"{name}.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    experiment = f"ZOO_{name}"
    ov = [f"root_path={workdir / 'zoo_runs'}", f"experiment={experiment}", "trainer.max_epoch=1"]
    folder = workdir / "zoo_runs" / "experiments" / experiment
    t0 = time.perf_counter()
    trainer = cli_train.main([f"--config-name={name}", f"--config-dir={cdir}", *ov])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(trainer.device.type == "cuda", f"zoo {name}: the train CLI ran on {trainer.device}")
    for path in ("metrics.jsonl", "recent/" + STATE_FILE, "best/" + STATE_FILE, "saved_loss.txt"):
        check((folder / path).exists(), f"zoo {name}: the train CLI wrote no {path}")
    res = {"wall_s": wall, "steps_per_epoch": trainer.steps_per_epoch,
           "model": type(trainer.model).__name__}
    del trainer
    pred = Predictor.from_experiment(name, experiment=experiment, choose="best", overrides=ov,
                                     config_dir=str(cdir))
    check(pred.device.type == "cuda" and next(pred.model.parameters()).is_cuda,
          f"zoo {name}: from_experiment serves on {pred.device}")
    c = load_config(name, config_dir=str(cdir), overrides=ov)
    md = instantiate(c.data, seed=c.seed).train_dataset.metadata
    model = instantiate(c.model, dset_metadata=md, seed=c.seed, device="cpu")
    state = torch.load(folder / "best" / STATE_FILE, map_location="cpu", weights_only=True)
    model.load_state_dict(state["params"])
    ref = Predictor(model)
    own = pred.model.state_dict()
    res["state_equal"] = all(torch.equal(own[k].cpu(), v) for k, v in state["params"].items())
    check(res["state_equal"] and set(own) == set(state["params"]),
          f"zoo {name}: from_experiment's weights differ from state.pt")
    if name == "unet_att":  # the checkpoint carries the trained BatchNorm statistics
        moved = not torch.equal(state["params"]["Conv1.BatchNorm_0.var"], torch.ones(64))
        res["batch_stats_in_checkpoint_moved"] = moved
        check(moved, "zoo unet_att: the checkpoint's BatchNorm statistics are the init's")
    x = well_history(dev)
    frames = pred.rollout(x, N_STEPS)
    res["device"] = str(pred.device)
    res["equals_predictor_by_hand_bit_for_bit"] = bool(torch.equal(frames, ref.rollout(x, N_STEPS)))
    check(res["equals_predictor_by_hand_bit_for_bit"] and bool(torch.isfinite(frames).all()),
          f"zoo {name}: from_experiment differs from the Predictor by hand")
    return res


def zoo_lane(name: str, dev, workdir: Path, dm, x) -> dict:
    md = dm.train_dataset.metadata
    model = zoo_model(name, dev, md)
    n_params = sum(p.numel() for p in model.parameters())
    n_buffers = sum(b.numel() for b in model.buffers())
    flat = seeded_jax_params(model, seed=0)  # norm scales and LayerScale gammas around 1
    pred = Predictor.from_numpy(model, flat)
    serving = serve_lane(f"zoo {name}", pred, x, want_packed=0)  # every wrapper 0
    cpu = Predictor.from_numpy(zoo_model(name, "cpu", md), flat, device="cpu")
    with torch.no_grad():
        got, ref = pred.model(x[:1]).cpu(), cpu.model(x[:1].cpu())
    err = rel_l2(got, ref)
    check(err <= ZOO_CALL_REL_TOL, f"zoo {name}: first call vs CPU f32: rel L2 {err}")
    del pred, model, cpu

    loader = dm.train_dataloader()
    loader.set_epoch(1)
    batch0 = next(iter(loader))
    one = {}
    for device in (dev, "cpu"):
        m = zoo_model(name, device, md)
        load_jax_params(m, flat)
        one[str(device)] = first_step(m, batch0["input"][:1].to(device),
                                      batch0["output"][:1].to(device), ZOO_CHECK_CALLS[name])
        del m
    gpu, cpu1 = one[str(dev)], one["cpu"]
    check(abs(gpu["loss"] - cpu1["loss"]) <= ZOO_LOSS_REL_TOL * cpu1["loss"],
          f"zoo {name}: first loss {gpu['loss']} on the card vs {cpu1['loss']} on the CPU")
    check(abs(gpu["grad_norm"] - cpu1["grad_norm"]) <= ZOO_GNORM_REL_TOL * cpu1["grad_norm"],
          f"zoo {name}: first gradient norm {gpu['grad_norm']} vs {cpu1['grad_norm']} on the CPU")
    stats_err = max((rel_l2(gpu["buffers"][k], v) for k, v in cpu1["buffers"].items()),
                    default=None)
    if name == "unet_att":
        check(stats_err is not None and stats_err <= ZOO_STATS_REL_TOL,
              f"zoo unet_att: running statistics after the first step vs the CPU: {stats_err}")

    mse, fns = MSE(), [MSE(), L2RE(), NNMSE(), VRMSE()]
    model = zoo_model(name, dev, md)
    load_jax_params(model, flat)
    trainer = Trainer(str(workdir / name), "channels_first_default", model, dm,
                      AdamW(lr=5e-5, weight_decay=1e-5), mse, L2RE(), max_epoch=1,
                      n_steps_output=4, n_steps_rollout=8, seed=0)
    train = timed_epoch(trainer, loader)
    check(all(v == 0 for v in train["launches_per_step"].values()),
          f"zoo {name}: train steps launched kernels {train['launches_per_step']}")
    val = trainer.validation_loop(dm.val_dataloader())
    check(np.isfinite(val), f"zoo {name}: validation loss {val}")
    trainer.save_model(1, val, "recent")
    del trainer, model
    evaler = Evaler(str(workdir / name), "channels_first_default", zoo_model(name, dev, md), dm,
                    *fns, checkpoint_path=str(workdir / name / "recent"), n_steps_rollout=8)
    chunk = int(evaler.model.output_length)
    ev = evaler_report(f"zoo {name}", evaler, fns, dm.test_dataloader(),
                       lambda xb, yb: rollout_fixed(evaler.model, xb, 8, chunk), want_packed=0)
    del evaler
    return {"config": f"configs/{name}.yaml", "parameters": n_params,
            "buffers": n_buffers,
            "serving": serving, "first_call_vs_cpu_f32_rel_l2": err,
            "rel_l2_tolerance": ZOO_CALL_REL_TOL,
            "first_step_one_sample": {
                "model_calls": ZOO_CHECK_CALLS[name], "loss": gpu["loss"], "loss_cpu_f32": cpu1["loss"],
                "loss_rel_tol": ZOO_LOSS_REL_TOL, "grad_norm": gpu["grad_norm"],
                "grad_norm_cpu_f32": cpu1["grad_norm"], "grad_norm_rel_tol": ZOO_GNORM_REL_TOL,
                "running_stats_vs_cpu_worst_rel_l2": stats_err,
                "running_stats_rel_tol": ZOO_STATS_REL_TOL if name == "unet_att" else None},
            "train": train, "validation_loss": val, "evaler": ev}


def phase_zoo(dev, workdir: Path) -> dict:
    """AFNO, DPOT, UNetConvNext and AttentionUNet at their shipped configs'
    widths, f32, on the AViT lane's data: ``Predictor.rollout`` (16 steps;
    0 hand-written launches), the first call against f32 on the CPU;
    ``Trainer`` (AdamW 5e-5 / 1e-5, 4 rollout steps), one sample's first
    loss and gradient norm (and AttentionUNet's running statistics) against
    the CPU; ``Evaler`` on the saved weights; then ``cli.train`` for one
    epoch and ``Predictor.from_experiment`` for each config."""
    dm = well_datamodule(dev)
    x = well_history(dev)
    res = {"phase": "zoo",
           "data": f"B={WELL_B} of {WELL_RES[0]}x{WELL_RES[1]}x{dm.train_dataset.metadata.n_fields}"
                   " synthetic waves; active_matter's 11 fields cut to 8",
           "dtype": "f32 as shipped (the configs set no enable_amp), TF32 off",
           "hand_written_kernels": "none: no zoo model reaches a Pallas kernel in JAX; every "
                                   "wrapper's launch count is held at 0 on every path here",
           "weights": "seeded (numpy seed 0)"}
    t0 = time.perf_counter()
    for name in ZOO_CONFIGS:
        t1 = time.perf_counter()
        res[name] = zoo_lane(name, dev, workdir, dm, x)
        res[name]["lane_seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    cdir = workdir / "zoo_configs"
    cdir.mkdir(exist_ok=True)
    res["cli"] = {name: zoo_cli(name, dev, workdir, cdir) for name in ZOO_CONFIGS}
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res


# ---------------------------------------------------------------------------
# The tensor-parallel path: fused_block_apply_tp's half kernels; dp / tp / sp
# through Trainer(mesh=...) on two ranks of one process group
# ---------------------------------------------------------------------------

TP_SIZES = (2, 4)
TP_CASES = [("H", (1536, 16, C), False), ("W", (512, 48, C), False),
            ("T", (BATCH * 16 * 48, IN_T, C), True)]  # T: rows of the rearranged tensor
PARALLEL_WORLD = 2          # ranks of the process group, both on cuda:0 (gloo)
PARALLEL_TIMEOUT_S = 300    # the parent's bound on the two ranks
PARALLEL_TRAIN_B = 2        # global batch of the parallel Trainer runs (dp 2: 1 a rank)
# Batch of the long-axes model's tp forward (cut from 8): at B 2 each C-block
# all-reduce is 0.4 GB in bf16 and 0.8 GB in f32, which gloo carries through
# the host, two a C block.
LONG_TP_BATCH = 2


def tp_halves(p: fb.BlockParams):
    return (fb.AttnHalfParams(*(getattr(p, f) for f in fb.AttnHalfParams._fields)),
            fb.MlpHalfParams(*(getattr(p, f) for f in fb.MlpHalfParams._fields)))


def half_bound(kind: str, rows: int, l: int, causal: bool, p) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, flops, bytes) of one half on one shard:
    matmuls (attention: q/k/v C x C/tp and the C/tp x C out-projection, plus
    4 * C/tp per admitted (query, key) pair; MLP: fc1 and fc2 over the
    hidden shard) against x in + the partial out + the shard's weights, in
    the shard's dtype.  bf16 at the bf16 tensor-core peak; f32 as three TF32
    products a product (3xTF32, ``bound_f32``)."""
    if kind == "attn":
        ca = p.wq.shape[-1]
        pairs = rows * (l + 1) / 2 if causal else rows * l
        flops = 2 * rows * 4 * C * ca + 4 * ca * pairs
    else:
        flops = 2 * rows * 2 * C * p.w1.shape[-1]
    elem = p[0].element_size()
    nbytes = 2 * rows * C * elem + sum(t.numel() * t.element_size() for t in p)
    t_ops = 3 * flops / PEAK_TF32_FLOPS if elem == 4 else flops / PEAK_BF16_FLOPS
    t_mem = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def tp_recombine(x, p: fb.BlockParams, attn_parts, mlp_fn) -> torch.Tensor:
    """The block from the shards' partials, as ``fused_block_apply_tp`` adds
    them: the all-reduced partial in bf16, then bias and residual in bf16."""
    out = torch.stack(attn_parts).sum(0).to(torch.bfloat16)
    xm = x + (out + p.bo)
    h2 = torch.stack([part.float() for part in mlp_fn(xm)]).sum(0).to(torch.bfloat16)
    return xm + (h2 + p.b2)


# The half kernels' symbols in a profile, demangled or not: the Hopper
# kernel's first template argument is the head dim (0: the MLP half); the
# first design's are attn_half_kernel / mlp_half_kernel.
_HALF_SYMBOLS = {
    "attn": (re.compile(r"half_sm90_kernel(?:<(?:16|32|64),|ILi(?:16|32|64)E)"),
             re.compile(r"attn_half_kernel")),
    "mlp": (re.compile(r"half_sm90_kernel(?:<0,|ILi0E)"), re.compile(r"mlp_half_kernel")),
}


def half_in_turns(kind: str, label: str, run, first, iters: int = 10) -> dict:
    """The Hopper half (``run``) and the first design's (``first``) on the
    same inputs, in turns: Hopper, first, first, Hopper; each kernel's own
    device time (events per call from the wrappers' launch counters) and the
    wrapper's whole device time per call (the first design's wrapper also
    prescales wq and bq: two more kernels)."""
    hopper, before = _HALF_SYMBOLS[kind]
    wrappers = {"attn": (fb.attn_half_apply, fb.block_tile_attn_half),
                "mlp": (fb.mlp_half_apply, fb.block_tile_mlp_half)}[kind]
    counters = [lambda w=w: w.launches.total() for w in wrappers]

    def hop():
        return device_split(run, hopper, iters, counters[0], f"{label} {kind} half")

    def fst():
        return device_split(first, before, iters, counters[1], f"{label} {kind} first design")

    k1, b1, b2, k2 = hop(), fst(), fst(), hop()

    def mean(a, b, key):  # over the windows the profiler saw (else CUDA events)
        seen = [r[key] for r in (a, b) if r["kernel_events"] is not None]
        return sum(seen) / len(seen) if seen else (a[key] + b[key]) / 2

    return {"kernel_ms": mean(k1, k2, "kernel_ms"), "call_ms": mean(k1, k2, "call_ms"),
            "first_design_ms": mean(b1, b2, "kernel_ms"),
            "first_design_call_ms": mean(b1, b2, "call_ms"),
            "kernel_ms_turns": [k1["kernel_ms"], k2["kernel_ms"]],
            "first_design_ms_turns": [b1["kernel_ms"], b2["kernel_ms"]],
            "events_launches_calls": [[r["kernel_events"], r["launches_counted"], r["calls"]]
                                      for r in (k1, b1, b2, k2)],
            "symbols": sorted(set(k1["symbols"]) | set(k2["symbols"])),
            "first_design_symbols": sorted(set(b1["symbols"]) | set(b2["symbols"])),
            "hopper_call_kernels": sorted(set(k1["all_symbols"]) | set(k2["all_symbols"]))}


# The channel block at tp 8 (expanded width 128, 8 heads, MLP ratio 1):
# 16-wide MLP shards, zero-padded to one 64-column pass.
NARROW_MLP_SHAPE = (1536 * 16, EXPANDED)  # rows (a C block's tokens of two frames), width


def narrow_mlp_check(dev, dtype) -> dict:
    """The MLP half on every 16-wide shard of a 128-wide block at tp 8
    against its plain version (bf16 at the halves' limits, f32 within
    ``F32_HALF_REL_L2_TOL``), one launch a shard; the shards' partials
    summed against the unsplit MLP; shard 0 timed (CUDA events)."""
    rows, c = NARROW_MLP_SHAPE
    f32 = dtype == torch.float32
    p = block_params(650, dev, dtype, c)
    gen = torch.Generator(device=dev)
    gen.manual_seed(65)
    x = torch.randn((rows, c), generator=gen, device=dev).to(dtype)
    shards = [tp_halves(shard_block(p, 8, r))[1] for r in range(8)]
    before = fb.mlp_half_apply.launches[dtype]
    worst, total = {"max_abs_err": 0.0, "rel_l2": 0.0, "max_err_over_limit": 0.0}, 0
    ok = True
    for mp in shards:
        got = fb.mlp_half_apply(x, mp)
        torch.cuda.synchronize()
        mpf = fb.MlpHalfParams(*(t.float() for t in mp))
        want = fb.mlp_half_ref(x.float(), mpf)
        err = (got.float() - want).abs()
        worst["max_abs_err"] = max(worst["max_abs_err"], float(err.max()))
        worst["rel_l2"] = max(worst["rel_l2"], rel_l2(got, want))
        if f32:
            ok &= worst["rel_l2"] <= F32_HALF_REL_L2_TOL
        else:
            limit = HALF_ATOL + HALF_RTOL * want.abs()
            worst["max_err_over_limit"] = max(worst["max_err_over_limit"],
                                              float((err / limit).max()))
            ok &= bool((err <= limit).all()) and worst["rel_l2"] <= HALF_REL_L2_TOL
        ok &= bool(torch.isfinite(got).all())
        total = total + got.float()
    launched = fb.mlp_half_apply.launches[dtype] - before
    pf = f32_params(p)
    whole = gelu_tanh_f32(fb.ln(x.float(), pf.ln2_scale, pf.ln2_bias) @ pf.w1 + pf.b1) @ pf.w2
    recombined = rel_l2(total, whole)
    ok &= recombined <= (F32_RECOMBINED_REL_L2_TOL if f32 else HALF_REL_L2_TOL)
    name = "f32" if f32 else "bf16"
    check(ok and launched == 8, f"16-wide MLP half ({name}, tp 8): {worst}, recombined rel L2 "
                                f"{recombined}, {launched} launches for 8 shards")
    res = {"phase": "tp_kernel_f32" if f32 else "tp_kernel", "case": "16-wide MLP half, tp 8",
           "dtype": name, "shape": [rows, c], "local_width": c // 8,
           "plan": fb.half_plan("mlp", 1, c, c // 8, dtype)._asdict(), **worst,
           "recombined_vs_unsplit_mlp_rel_l2": recombined, "launches": launched,
           "ok": ok and launched == 8,
           "kernel_ms": cuda_ms(lambda: fb.mlp_half_apply(x, shards[0]), 20)}
    emit(res)
    return res


def phase_tp_kernel(dev) -> list[dict]:
    """Both Hopper half kernels on every shard at the flagship's H, W and
    causal T shapes for tp = 2 and 4, and at H for tp = 8 (32-wide shards,
    zero-padded to one 64-column group), against their plain versions; the
    shards' partials recombined against the unsplit f32 block and the
    unsplit kernel; shard 0's kernels timed in turns with the first design's
    (``block_tile_attn_half`` / ``block_tile_mlp_half``), each kernel's own
    device time apart from its wrapper's, and the plain versions; launches
    and weight re-layouts counted; gradients through each half's Function at
    tp = 2."""
    out = []
    cases = [(tp, *case) for tp in TP_SIZES for case in TP_CASES]
    cases.append((8, *TP_CASES[0]))
    for tp, label, shape, causal in cases:
        i = [c[0] for c in TP_CASES].index(label)
        p = block_params(500 + i, dev)
        pf = f32_params(p)
        x = torch.from_numpy(np.random.default_rng(50 + i).normal(size=shape).astype(
            np.float32)).to(dev, torch.bfloat16)
        rows, l, heads = shape[0] * shape[1], shape[1], HEADS // tp
        errs = {k: {"max_abs_err": 0.0, "rel_l2": 0.0, "plain_rms": 0.0} for k in ("attn", "mlp")}
        ok = True
        attn_parts = []
        before = tp_counts()
        shards = [tp_halves(shard_block(p, tp, r)) for r in range(tp)]
        for r in range(tp):
            ap, mp = shards[r]
            apf, mpf = tp_halves(shard_block(pf, tp, r))
            for kind, got, want in (
                    ("attn", fb.attn_half_apply(x, ap, l, heads, causal),
                     fb.attn_half_ref(x.float(), apf, l, heads, causal)),
                    ("mlp", fb.mlp_half_apply(x, mp), fb.mlp_half_ref(x.float(), mpf))):
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                e = errs[kind]
                e["max_abs_err"] = max(e["max_abs_err"], float(err.max()))
                e["rel_l2"] = max(e["rel_l2"], rel_l2(got, want))
                e["plain_rms"] = max(e["plain_rms"], float(want.square().mean().sqrt()))
                ok &= (bool(torch.isfinite(got).all())
                       and bool((err <= HALF_ATOL + HALF_RTOL * want.abs()).all())
                       and e["rel_l2"] <= HALF_REL_L2_TOL)
                if kind == "attn":
                    attn_parts.append(got.float())
        launched = {k: v - before[k] for k, v in tp_counts().items()}
        check(launched == {"attn_half_fwd": tp, "mlp_half_fwd": tp},
              f"tp={tp} {label}: {launched} half launches for {tp} shards")
        mlp_fn = lambda xm: [fb.mlp_half_apply(xm, mp) for _, mp in shards]  # noqa: E731,B023
        y = tp_recombine(x, p, attn_parts, mlp_fn).float()
        want = fb.block_ref(x.float(), pf, l, HEADS, causal)
        unsplit = fb.fused_block_apply(x, p, l, HEADS, causal).float()
        e_ref, e_kernel = (y - want).abs(), (y - unsplit).abs()
        ok_block = (bool((e_ref <= ATOL + RTOL * want.abs()).all())
                    and bool((e_kernel <= ATOL + RTOL * unsplit.abs()).all()))
        check(ok, f"tp={tp} {label}: a half kernel disagrees with its plain version")
        check(ok_block, f"tp={tp} {label}: the recombined halves disagree with the block")
        ap, mp = shards[0]  # re-laid by their launches above
        apf, mpf = tp_halves(shard_block(pf, tp, 0))
        xf = x.float()
        res = {"phase": "tp_kernel", "tp": tp, "case": label, "shape": list(shape),
               "causal": causal, "local_heads": heads, "local_width": C // tp,
               "plans": {"attn": fb.half_plan("attn", l, C, C // tp)._asdict(),
                         "mlp": fb.half_plan("mlp", 1, C, C // tp)._asdict()},
               "tolerance": f"|k - plain| <= {HALF_ATOL} + {HALF_RTOL}*|plain| and rel L2 "
                            f"<= {HALF_REL_L2_TOL}; recombined block: {ATOL} + {RTOL}*|plain|",
               "ok": ok and ok_block, "launches": launched,
               "recombined_vs_block_ref_max_abs_err": float(e_ref.max()),
               "recombined_vs_unsplit_kernel_max_abs_err": float(e_kernel.max())}
        relays = fb.relaid_weights.count
        for kind, run, first, plain, hp in (
                ("attn", lambda: fb.attn_half_apply(x, ap, l, heads, causal),
                 lambda: fb.block_tile_attn_half(x, ap, l, heads, causal),
                 lambda: fb.attn_half_ref(xf, apf, l, heads, causal), ap),
                ("mlp", lambda: fb.mlp_half_apply(x, mp), lambda: fb.block_tile_mlp_half(x, mp),
                 lambda: fb.mlp_half_ref(xf, mpf), mp)):
            b_ms, b_by, flops, nbytes = half_bound(kind, rows, l, causal, hp)
            turns = half_in_turns(kind, f"tp={tp} {label}", run, first)
            strays = [k for k in turns["hopper_call_kernels"] if _HALF_SYMBOLS[kind][1].search(k)]
            check(bool(turns["symbols"]) and not strays,
                  f"tp={tp} {label}: the {kind} wrapper's profile shows the Hopper kernels "
                  f"{turns['symbols']} and first-design kernels {strays}")
            windows = turns["events_launches_calls"]
            seen = [w for w in windows if w[0] is not None]  # the rest: no device events
            check(all(ev and n == calls for ev, n, calls in seen)
                  and any(w[0] is not None for w in windows[::3])
                  and any(w[0] is not None for w in windows[1:3]),
                  f"tp={tp} {label}: {kind} half kernel events, launches counted and calls per "
                  f"profiled window {windows}")
            first_err = float((run().float() - first().float()).abs().max())
            res[kind] = {**errs[kind], **turns, "hopper_vs_first_design_max_abs_err": first_err,
                         "plain_ms": device_ms(plain, iters=5), "bound_us": 1e3 * b_ms,
                         "bound_by": b_by, "flops": flops, "bytes": nbytes,
                         "achieved_tflops": flops / turns["kernel_ms"] / 1e9,
                         "bound_share": b_ms / turns["kernel_ms"]}
        res["relays_over_timed_calls"] = fb.relaid_weights.count - relays
        check(res["relays_over_timed_calls"] == 0,
              f"tp={tp} {label}: {res['relays_over_timed_calls']} re-layouts of unchanged weights")
        if tp == 2 and label == "H":
            # What a weight version costs: a Trainer re-lays each half once
            # per optimizer step (host clock around synchronised re-layouts).
            plan_a, plan_m = fb.half_plan("attn", l, C, C // tp), fb.half_plan("mlp", 1, C, C // tp)
            for kind, make in (("attn", lambda: fb._arrange_attn_half(ap, heads, plan_a)),
                               ("mlp", lambda: fb._arrange_mlp_half(mp, plan_m))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    for _ in range(10):
                        make()
                torch.cuda.synchronize()
                res[kind]["relayout_ms"] = 1e3 * (time.perf_counter() - t0) / 10
            res["grad"] = tp_half_grads(x, p, l, heads, causal)
            res["relays_through_copy_to_tp_views"] = tp_view_relays(x, p, l, heads, causal)
        emit(res)
        out.append(res)
    narrow_mlp_check(dev, torch.bfloat16)
    return out


# The f32 halves against their f32 plain versions (TF32 off) and, recombined,
# against the unsplit f32 block kernel: 3xTF32 products in another
# summation order, nothing rounded below f32 (the f32 block kernels read
# ~1e-7).
F32_HALF_REL_L2_TOL = F32_RECOMBINED_REL_L2_TOL = 1e-6
_HALF_F32_SYMBOLS = {"attn": re.compile(r"half_sm90_f32_kernel(?:<(?:16|32|64),|ILi(?:16|32|64)E)"),
                     "mlp": re.compile(r"half_sm90_f32_kernel(?:<0,|ILi0E)")}


def phase_tp_kernel_f32(dev) -> list[dict]:
    """Both f32 half kernels (``*_sm90_f32_fwd``, ``fused_half_sm90_f32.cu``)
    on every shard at the flagship's H, W and causal T shapes for tp = 2 and
    4, on f32 inputs: relative L2 and max abs error against the f32 plain
    halves; the shards' partials recombined (summed in f32, then bias and
    residual, as ``fused_block_apply_tp`` adds them) against the unsplit f32
    block kernel and the f32 plain block; launches counted (f32 only);
    shard 0's kernels' own device time against the 3xTF32 bound and the
    FFMA peak, the plain halves' time; weight re-layouts over the timed
    calls (none)."""
    out = []
    for tp in TP_SIZES:
        for i, (label, shape, causal) in enumerate(TP_CASES):
            p = block_params(600 + i, dev, torch.float32)
            x = torch.from_numpy(np.random.default_rng(60 + i).normal(size=shape).astype(
                np.float32)).to(dev)
            rows, l, heads = shape[0] * shape[1], shape[1], HEADS // tp
            shards = [tp_halves(shard_block(p, tp, r)) for r in range(tp)]
            errs = {k: {"max_abs_err": 0.0, "rel_l2": 0.0, "plain_rms": 0.0} for k in ("attn", "mlp")}
            reset_counts()
            attn_parts = []
            for ap, mp in shards:
                for kind, got, want in (
                        ("attn", fb.attn_half_apply(x, ap, l, heads, causal),
                         fb.attn_half_ref(x, ap, l, heads, causal)),
                        ("mlp", fb.mlp_half_apply(x, mp), fb.mlp_half_ref(x, mp))):
                    torch.cuda.synchronize()
                    e = errs[kind]
                    e["max_abs_err"] = max(e["max_abs_err"], float((got - want).abs().max()))
                    e["rel_l2"] = max(e["rel_l2"], rel_l2(got, want))
                    e["plain_rms"] = max(e["plain_rms"], float(want.square().mean().sqrt()))
                    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
                          f"f32 tp={tp} {label}: the {kind} half's partial is not finite f32")
                    if kind == "attn":
                        attn_parts.append(got)
            launched = {"attn_half_fwd": dict(fb.attn_half_apply.launches),
                        "mlp_half_fwd": dict(fb.mlp_half_apply.launches)}
            check(launched == {"attn_half_fwd": {torch.float32: tp},
                               "mlp_half_fwd": {torch.float32: tp}},
                  f"f32 tp={tp} {label}: half launches {launched}, want {tp} f32 each")
            ok = all(e["rel_l2"] <= F32_HALF_REL_L2_TOL for e in errs.values())
            check(ok, f"f32 tp={tp} {label}: a half kernel disagrees with its plain version {errs}")
            xm = x + (torch.stack(attn_parts).sum(0) + p.bo)
            y = xm + (torch.stack([fb.mlp_half_apply(xm, mp) for _, mp in shards]).sum(0) + p.b2)
            unsplit = fb.fused_block_apply(x, p, l, HEADS, causal)
            want = fb.block_ref(x, p, l, HEADS, causal)
            recombined = {"vs_unsplit_f32_kernel_rel_l2": rel_l2(y, unsplit),
                          "vs_f32_plain_block_rel_l2": rel_l2(y, want),
                          "vs_unsplit_f32_kernel_max_abs_err": float((y - unsplit).abs().max())}
            ok_block = max(recombined["vs_unsplit_f32_kernel_rel_l2"],
                           recombined["vs_f32_plain_block_rel_l2"]) <= F32_RECOMBINED_REL_L2_TOL
            check(ok_block, f"f32 tp={tp} {label}: the recombined halves disagree with the "
                            f"unsplit f32 block: {recombined}")
            res = {"phase": "tp_kernel_f32", "tp": tp, "case": label, "shape": list(shape),
                   "causal": causal, "local_heads": heads, "local_width": C // tp,
                   "plans": {"attn": fb.half_plan("attn", l, C, C // tp, torch.float32)._asdict(),
                             "mlp": fb.half_plan("mlp", 1, C, C // tp, torch.float32)._asdict()},
                   "tolerance": f"rel L2 <= {F32_HALF_REL_L2_TOL} against the f32 plain half "
                                f"(TF32 off); recombined block: rel L2 <= "
                                f"{F32_RECOMBINED_REL_L2_TOL}",
                   "ok": ok and ok_block, "launches": {k: v.get(torch.float32, 0)
                                                       for k, v in launched.items()},
                   "recombined": recombined}
            ap, mp = shards[0]  # re-laid by their launches above
            relays = fb.relaid_weights.count
            for kind, run, plain, hp, wrapper in (
                    ("attn", lambda: fb.attn_half_apply(x, ap, l, heads, causal),
                     lambda: fb.attn_half_ref(x, ap, l, heads, causal), ap, fb.attn_half_apply),
                    ("mlp", lambda: fb.mlp_half_apply(x, mp), lambda: fb.mlp_half_ref(x, mp), mp,
                     fb.mlp_half_apply)):
                b_ms, b_by, flops, nbytes = half_bound(kind, rows, l, causal, hp)
                split = device_split(run, _HALF_F32_SYMBOLS[kind], 10,
                                     lambda w=wrapper: w.launches[torch.float32],
                                     f"f32 tp={tp} {label} {kind} half")
                check(split["kernel_events"] is None or bool(split["symbols"]),
                      f"f32 tp={tp} {label}: no {kind} f32 half kernel in the profile "
                      f"{split['all_symbols']}")
                res[kind] = {**errs[kind], "kernel_ms": split["kernel_ms"],
                             "call_ms": split["call_ms"], "symbols": split["symbols"],
                             "events_launches_calls": [split["kernel_events"],
                                                       split["launches_counted"], split["calls"]],
                             "plain_ms": device_ms(plain, iters=5), "bound_us": 1e3 * b_ms,
                             "bound_by": b_by, "ffma_bound_us": 1e6 * flops / PEAK_F32_FLOPS,
                             "flops": flops, "bytes": nbytes,
                             "achieved_tflops": flops / split["kernel_ms"] / 1e9,
                             "bound_share": b_ms / split["kernel_ms"]}
            res["relays_over_timed_calls"] = fb.relaid_weights.count - relays
            check(res["relays_over_timed_calls"] == 0,
                  f"f32 tp={tp} {label}: {res['relays_over_timed_calls']} re-layouts of unchanged "
                  "weights")
            emit(res)
            out.append(res)
    narrow_mlp_check(dev, torch.float32)
    return out


# The long attention half (fused_half_long_sm90.cu) at the flagship's long
# blocks under tp: (label, axis of LONG_CASES or (sequences, L, width),
# causal, softmax, tp, timed).  tp 2 runs every shard (and is recombined into
# the block), tp 4 shard 0 (at C a 32-wide shard, padded to one group), the
# C block at tp 8 every 16-wide shard (one head of 16 and three zero heads;
# recombined); causal L 100 and the "safe" softmax are checks only.
TP_LONG_CASES = [
    *((axis, axis, False, "fast", 2, True) for axis in "LXAC"),
    *((f"{axis} tp 4", axis, False, "fast", 4, False) for axis in "LXAC"),
    ("C tp 8", "C", False, "fast", 8, False),
    ("causal L 100", (64, 100, C), True, "fast", 2, False),
    ("causal L 100 safe", (64, 100, C), True, "safe", 2, False),
    ("L 100 safe", (64, 100, C), False, "safe", 2, False),
]
TP_LONG_GRAD_SHAPE = (64, 100, C)  # the gradient check through the half's Function


def half_long_bounds(rows: int, l: int, c: int, ca: int, width: int, causal: bool,
                     dtype) -> dict:
    """The least time of the long attention half on these inputs, per kernel
    and whole: operations (q|k|v 2*M*C*3*CA, attention 4*CA per admitted
    (query, key) pair, out-projection 2*M*CA*C) at the dtype's tensor-core
    rate (f32: 3xTF32), bytes (each input read once, each output written
    once) at the memory rate; the larger of the two.  The qkv kernel reads x
    and the q|k|v weights and writes the workspace (3 W values a token); the
    attention kernel reads the workspace and wo and writes the partial; the
    half as a function reads x and its weights and writes the partial
    ("half"), and with the workspace's write and read ("half_with_workspace",
    what this split moves)."""
    e = 4 if dtype == torch.float32 else 2
    m = rows * l
    pairs = rows * l * (l + 1) / 2 if causal else rows * l * l
    w_qkv, w_o = (2 * c + 3 * c * ca + 3 * ca) * e, ca * c * e
    ws = 3 * m * width * e
    f_qkv, f_attn = 2 * m * c * 3 * ca, 4 * ca * pairs + 2 * m * ca * c
    parts = {"qkv": (f_qkv, m * c * e + w_qkv + ws), "attn": (f_attn, ws + m * c * e + w_o),
             "half": (f_qkv + f_attn, 2 * m * c * e + w_qkv + w_o),
             "half_with_workspace": (f_qkv + f_attn, 2 * m * c * e + w_qkv + w_o + 2 * ws)}
    out = {}
    for k, (flops, nbytes) in parts.items():
        t_ops = 3 * flops / PEAK_TF32_FLOPS if e == 4 else flops / PEAK_BF16_FLOPS
        t_mem = nbytes / PEAK_HBM_BYTES
        out[k] = {"bound_us": 1e6 * max(t_ops, t_mem),
                  "bound_by": "operations" if t_ops >= t_mem else "bytes",
                  "flops": flops, "bytes": nbytes}
    return out


def dropped_keys_half_ref(x: torch.Tensor, p: fb.AttnHalfParams, l: int, heads: int,
                          causal: bool, keys: int) -> torch.Tensor:
    """``attn_half_ref`` in f32 whose attention sees only the first ``keys``
    keys of each sequence: the control of tp_kernel_long's bf16 limit."""
    d = p.wq.shape[-1] // heads
    xn = fb.ln(x, p.ln1_scale, p.ln1_bias)
    q = ((xn @ p.wq) + p.bq) * d**-0.5
    k, v = (xn @ p.wk) + p.bk, (xn @ p.wv) + p.bv
    q, k, v = (t.reshape(-1, l, heads, d) for t in (q, k, v))
    logits = torch.einsum("blhd,bmhd->bhlm", q, k[:, :keys])
    if causal:
        m = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))[:, :keys]
        logits = torch.where(m, logits, torch.full_like(logits, -1e30))
    attn = torch.einsum("bhlm,bmhd->blhd", torch.softmax(logits, dim=-1), v[:, :keys])
    return attn.reshape(*x.shape[:-1], -1) @ p.wo


def half_long_agree(got: torch.Tensor, want: torch.Tensor, f32: bool) -> tuple[bool, dict]:
    """A long half's partial against the plain half: f32 as ``f32_agree``;
    bf16 within HALF_ATOL + HALF_RTOL |plain| elementwise and HALF_REL_L2_TOL
    over the partial."""
    if f32:
        return f32_agree(got, want)
    err = (got.float() - want).abs()
    limit = HALF_ATOL + HALF_RTOL * want.abs()
    rel = rel_l2(got, want)
    ok = (bool(torch.isfinite(got).all()) and bool((err <= limit).all())
          and rel <= HALF_REL_L2_TOL)
    return ok, {"max_abs_err": float(err.max()), "rel_l2": rel,
                "max_err_over_limit": float((err / limit).max()),
                "plain_rms": float(want.square().mean().sqrt()),
                "tolerance": f"|k - plain| <= {HALF_ATOL} + {HALF_RTOL}*|plain|, rel L2 <= "
                             f"{HALF_REL_L2_TOL}"}


def phase_tp_kernel_long(dev, dtype) -> list[dict]:
    """The long attention half (``attn_half_apply`` at L > 64: the qkv kernel
    into the shard's workspace, then the attention kernel and out-projection
    partial) on the flagship's L, X, A and C blocks, every shard at tp 2 and
    shard 0 at tp 4, in ``dtype``, with wq and wk LONG_QK_SCALE wider: bf16
    against the f32 plain half from the same bf16 inputs (the halves'
    limits; a control, the plain half without its last key block, must fail
    them at every flagship shape), f32 against the f32 plain half (TF32 off;
    F32_REL_L2_TOL / F32_MAX_ABS_SHARE); at C the plain half runs on the
    first LONG_C_PLAIN_SEQS sequences.  Exactly one launch of each kernel a
    call and none of another kernel; two launches bit-equal.  At tp 2 the
    shards' partials + bo, then the MLP halves + b2, against the unsplit long
    block (``fused_block_long``).  Shard 0 at tp 2 timed (CUDA events): each
    kernel alone, the whole half, the plain half (at C on its sequences,
    scaled and labelled so), beside the bounds (``half_long_bounds``).  Then
    the gradients through the half's Function at TP_LONG_GRAD_SHAPE."""
    f32 = dtype == torch.float32
    name = "f32" if f32 else "bf16"
    t0 = time.perf_counter()
    out = []
    gen = torch.Generator(device=dev)
    for i, (label, shape, causal, softmax, tp, timed) in enumerate(TP_LONG_CASES):
        rows, l, c = LONG_CASES[shape] if isinstance(shape, str) else shape
        p = block_params(800 + i, dev, dtype, c, qk_scale=LONG_QK_SCALE)
        gen.manual_seed(80 + i)
        x = torch.randn((rows, l, c), generator=gen, device=dev).to(dtype)
        heads, ca = HEADS // tp, c // tp
        n_plain = min(rows, LONG_C_PLAIN_SEQS)
        fb.set_block_tuning(softmax=softmax)
        every = tp in (2, 8)  # every shard, recombined into the block
        shards = [tp_halves(shard_block(p, tp, r)) for r in range(tp if every else 1)]
        plan = fb.half_long_plan(c, ca, heads, dtype)
        work = fb.half_long_attn_work(x, plan, l, ca)
        res = {"phase": "tp_kernel_long", "dtype": name, "case": label, "shape": [rows, l, c],
               "tp": tp, "shards_checked": len(shards), "local_heads": heads, "local_width": ca,
               "causal": causal, "softmax": softmax, "plain_sequences": n_plain,
               "plan": plan._asdict(), "attn_work": work,
               "attn_workspace_reads": fb.long_attn_reads(plan, rows, l, plan.width, causal,
                                                          softmax == "safe", dtype, work["big"])}
        ok, launched, repeat_equal, acc, worst = True, True, True, None, {}
        for r, (ap, _) in enumerate(shards):
            reset_counts()
            got = fb.attn_half_apply(x, ap, l, heads, causal)
            torch.cuda.synchronize()
            others = sum(n for fn in fb.WRAPPERS if fn not in HALF_LONG_WRAPPERS.values()
                         for n in fn.launches.values())
            launched &= (half_long_counts(dtype) == {k: 1 for k in HALF_LONG_WRAPPERS}
                         and not others)
            repeat_equal &= bool(torch.equal(got, fb.attn_half_apply(x, ap, l, heads, causal)))
            qkv = long_qkv_check(x, ap, plan, n_plain, (heads, ca))
            check(qkv["ok"], f"tp_kernel_long {label} {name} shard {r}: the qkv workspace "
                             f"disagrees: {qkv}")
            ok &= qkv["ok"]
            res.setdefault("qkv_workspace", []).append(qkv)
            apf = fb.AttnHalfParams(*(t.float() for t in ap))
            want = fb.attn_half_ref(x[:n_plain].float(), apf, l, heads, causal)
            good, agree = half_long_agree(got[:n_plain], want, f32)
            good &= bool(torch.isfinite(got).all())
            if not f32 and r == 0:
                # The control: the plain half without the last key block the
                # kernel streams.
                cut = fb.LONG_KEY_BLOCK * ((l - 1) // fb.LONG_KEY_BLOCK)
                ctl = dropped_keys_half_ref(x[:n_plain].float(), apf, l, heads, causal, cut)
                agree["control_keys_dropped"] = l - cut
                agree["control_max_err_over_limit"] = float(
                    ((ctl - want).abs() / (HALF_ATOL + HALF_RTOL * want.abs())).max())
                del ctl
                if isinstance(shape, str):
                    check(agree["control_max_err_over_limit"] > 1,
                          f"tp_kernel_long {label}: the bf16 limit does not see a dropped key "
                          "block")
            ok &= good
            for k, v in agree.items():
                if isinstance(v, float) and k != "max_abs_plain":
                    worst[k] = max(worst.get(k, v), v)
                else:
                    worst.setdefault(k, v)
            if every:  # the partials summed in f32 in shard order
                acc = got.float() if acc is None else acc.add_(got.float())
            del want, got
        check(launched, f"tp_kernel_long {label} {name}: not one launch of each long-half kernel "
                        "a call, or another kernel launched")
        check(repeat_equal, f"tp_kernel_long {label} {name}: two launches differ")
        check(ok, f"tp_kernel_long {label} {name} disagrees with the plain half: {worst}")
        res.update({**worst, "ok": ok and launched and repeat_equal, "launches_one_each": launched,
                    "repeat_equal": repeat_equal})
        if every:
            # The block from the shards, as fused_block_apply_tp adds them.
            xm = x + (acc.to(dtype) + p.bo).to(dtype)
            del acc
            acc = None
            for _, mp in shards:
                h = fb.mlp_half_apply(xm, mp).float()
                acc = h if acc is None else acc.add_(h)
                del h
            y = xm + (acc.to(dtype) + p.b2).to(dtype)
            del acc, xm
            unsplit = fb.fused_block_long(x, p, l, HEADS, causal)
            if f32:
                good, rec = f32_agree(y, unsplit)
            else:
                err = (y.float() - unsplit.float()).abs()
                lim = ATOL + RTOL * unsplit.float().abs()
                good = bool(torch.isfinite(y).all()) and bool((err <= lim).all())
                rec = {"max_abs_err": float(err.max()),
                       "tolerance": f"|tp - unsplit| <= {ATOL} + {RTOL}*|unsplit|"}
                del err, lim
            check(good, f"tp_kernel_long {label} {name}: the recombined shards disagree with "
                        f"fused_block_long: {rec}")
            res["recombined_vs_fused_block_long"] = {**rec, "ok": good}
            res["ok"] = res["ok"] and good
            del y, unsplit
        res["bounds"] = bounds = half_long_bounds(rows, l, c, ca, -(-ca // 64) * 64, causal,
                                                  dtype)
        if timed:
            ap = shards[0][0]
            apf = fb.AttnHalfParams(*(t.float() for t in ap))
            w = fb.half_long_weights(ap, heads, plan)
            ws = fb.half_long_qkv_fwd(x, w, plan, l, ca)
            iters = 3 if label == "C" else 10
            res["qkv_ms"] = cuda_ms(lambda: fb.half_long_qkv_fwd(x, w, plan, l, ca), iters)
            res["qkv_bound_share"] = bounds["qkv"]["bound_us"] / 1e3 / res["qkv_ms"]
            res["qkv_gb_per_s"] = bounds["qkv"]["bytes"] / res["qkv_ms"] / 1e6
            res["attn_ms"] = cuda_ms(
                lambda: fb.half_long_attn_fwd(x, ws, w, plan, l, ca, heads, causal), iters)
            res["kernel_ms"] = cuda_ms(lambda: fb.attn_half_apply(x, ap, l, heads, causal), iters)
            del ws
            plain_ms = cuda_ms(lambda: fb.attn_half_ref(x[:n_plain].float(), apf, l, heads,
                                                        causal), iters=3, warmup=1)
            res["plain_ms"] = plain_ms * rows / n_plain
            if n_plain < rows:
                res["plain_ms_is"] = (f"the plain half on {n_plain} sequences ({plain_ms} ms), "
                                      f"scaled by {rows}/{n_plain}")
            res["bound_share"] = bounds["half"]["bound_us"] / 1e3 / res["kernel_ms"]
            res["achieved_tflops"] = bounds["half"]["flops"] / res["kernel_ms"] / 1e9
        emit(res)
        out.append(res)
        del x, shards, p
        torch.cuda.empty_cache()
    fb.set_block_tuning(softmax="fast")
    # Gradients through the half's Function (kernel forward, plain backward)
    # at a long shape, against f32 autograd (tp_half_grads: shard 1 of tp 2).
    grad = {}
    if not f32:
        p = block_params(899, dev, dtype, C, qk_scale=LONG_QK_SCALE)
        x = torch.from_numpy(np.random.default_rng(89).normal(size=TP_LONG_GRAD_SHAPE).astype(
            np.float32)).to(dev, dtype)
        reset_counts()
        grad = tp_half_grads(x, p, TP_LONG_GRAD_SHAPE[1], HEADS // 2, False)
        grad["long_half_launches"] = half_long_counts(dtype)
        check(grad["long_half_launches"] == {k: 1 for k in HALF_LONG_WRAPPERS},
              f"tp_kernel_long grad: long-half launches {grad['long_half_launches']}")
    emit({"phase": "tp_kernel_long", "dtype": name, "grad": grad,
          "grad_shape": list(TP_LONG_GRAD_SHAPE), "seconds": time.perf_counter() - t0})
    return out


class _StandInGroup:
    """A process group for ``_CopyToTP.apply`` in one process (its forward
    only keeps it)."""


def tp_view_relays(x, p, l, heads, causal) -> dict:
    """The halves as ``fused_block_apply_tp`` calls them: the LayerNorm
    parameters as new ``copy_to_tp`` views on every call.  Three calls
    re-lay each half once (the cache keys on the view's base) and give equal
    partials; an in-place update re-lays again and moves the result with
    the weights."""
    from tante_tpu_torch.parallel.collectives import _CopyToTP

    shard = shard_block(p, 2, 1)
    g = _StandInGroup()

    def call():
        ap, mp = tp_halves(shard)
        ap = ap._replace(ln1_scale=_CopyToTP.apply(ap.ln1_scale, g),
                         ln1_bias=_CopyToTP.apply(ap.ln1_bias, g))
        mp = mp._replace(ln2_scale=_CopyToTP.apply(mp.ln2_scale, g),
                         ln2_bias=_CopyToTP.apply(mp.ln2_bias, g))
        ys = fb.attn_half_apply(x, ap, l, heads, causal), fb.mlp_half_apply(x, mp)
        torch.cuda.synchronize()
        return ys

    r0 = fb.relaid_weights.count
    first = call()
    same = all(all(torch.equal(a, b) for a, b in zip(first, call())) for _ in range(2))
    relays_3_calls = fb.relaid_weights.count - r0
    with torch.no_grad():  # an optimizer step: a new version of two weights
        shard.wq.mul_(1.5)
        shard.w1.mul_(1.5)
    moved = call()
    relays_after_update = fb.relaid_weights.count - r0 - relays_3_calls
    apf, mpf = tp_halves(f32_params(shard))
    wants = fb.attn_half_ref(x.float(), apf, l, heads, causal), fb.mlp_half_ref(x.float(), mpf)
    err = max(float((got.float() - want).abs().max()) for got, want in zip(moved, wants))
    close = all(bool(((got.float() - want).abs() <= HALF_ATOL + HALF_RTOL * want.abs()).all())
                for got, want in zip(moved, wants))
    check(relays_3_calls == 2 and same and relays_after_update == 2,
          f"copy_to_tp views: {relays_3_calls} re-layouts over three calls (want 2), equal "
          f"{same}, {relays_after_update} after an in-place update (want 2)")
    check(close, f"copy_to_tp views after an update: max abs error {err}")
    return {"calls": 3, "relays": relays_3_calls, "partials_equal": same,
            "relays_after_in_place_update": relays_after_update,
            "max_abs_err_after_update": err, "ok": close}


def tp_half_grads(x, p, l, heads, causal) -> dict:
    """Gradients of sum(y**2) through each half's Function (kernel forward,
    plain backward, bf16) against autograd of the f32 plain half, shard 1."""
    def grads(x, half, kernel):
        x = x.detach().requires_grad_(True)
        ps = type(half)(*(t.detach().requires_grad_(True) for t in half))
        if isinstance(half, fb.AttnHalfParams):
            fn = fb.attn_half_apply if kernel else fb.attn_half_ref
            y = fn(x, ps, l, heads, causal)
        else:
            y = (fb.mlp_half_apply if kernel else fb.mlp_half_ref)(x, ps)
        (y.float() ** 2).sum().backward()
        return dict(zip(("x", *half._fields), (x.grad, *(t.grad for t in ps))))

    out = {}
    shard = shard_block(p, 2, 1)
    for half, half_f in zip(tp_halves(shard), tp_halves(f32_params(shard))):
        got, want = grads(x, half, True), grads(x.float(), half_f, False)
        errs = {n: float(torch.linalg.norm(g.float() - want[n])
                         / torch.linalg.norm(want["bq" if n == "bk" else n]))
                for n, g in got.items()}
        worst = max(errs, key=errs.get)
        name = "attn" if isinstance(half, fb.AttnHalfParams) else "mlp"
        check(errs[worst] <= GRAD_REL_TOL, f"tp half {name} grad: {worst} rel L2 {errs[worst]}")
        out[name] = {"worst_tensor": worst, "worst_rel_l2": errs[worst], "x_rel_l2": errs["x"],
                     "rel_l2_tolerance": GRAD_REL_TOL}
    return out


def tp_counts() -> dict:
    return {"attn_half_fwd": fb.attn_half_apply.launches.total(),
            "mlp_half_fwd": fb.mlp_half_apply.launches.total()}


def half_counts() -> dict:
    """The tp halves' launches since the last reset, by wrapper and dtype
    ("bf16" / "f32")."""
    return {name: {"bf16": fn.launches[torch.bfloat16], "f32": fn.launches[torch.float32]}
            for name, fn in (("attn_half_fwd", fb.attn_half_apply),
                             ("mlp_half_fwd", fb.mlp_half_apply))}


def parallel_data(dev, batch, n_in, fno=False) -> WaveDataModule:
    """In-memory waves at the flagship resolution; the same on every rank."""
    return WaveDataModule(
        batch_size=batch, n_steps_input=n_in, n_steps_output=2, eval_steps_output=2,
        data_workers=2, seed=0, device=dev,
        waves=dict(resolution=RES, n_trajectories=2, n_steps=10 if fno else 8,
                   with_pressure=True, seed=0))


def parallel_trainer(dev, workdir: Path, folder: str, kind: str, mesh=None, dropout=0.0,
                     amp=True):
    """A Trainer on the flagship TANTE (bf16 over f32 weights, AdamW 5e-5; f32
    throughout with ``amp=False``, as configs/tante.yaml ships) or on FNO at
    configs/fno.yaml width (channels-last), on one rank or on ``mesh``."""
    if kind == "tante":
        dm = parallel_data(dev, PARALLEL_TRAIN_B, IN_T)
        model = flagship(True, torch.float32, dev, dm.train_dataset.metadata, dropout=dropout)
        lr = 5e-5
    else:
        dm = parallel_data(dev, FNO_BATCH, IN_T, fno=True)
        model = fno_model(torch.float32, dev, dm.train_dataset.metadata, layout="wc")
        lr = 1e-3
    trainer = Trainer(str(workdir / folder), "channels_first_default", model, dm,
                      AdamW(lr=lr, weight_decay=1e-5), MSE(), L2RE(), max_epoch=1,
                      enable_amp=amp, n_steps_output=2, n_steps_rollout=2, seed=0, mesh=mesh,
                      device=dev)
    return trainer, dm


def train_steps(trainer: Trainer, dm, steps: int) -> dict:
    """``steps`` train steps of the first epoch's batches: the losses (the
    global batch's), gradient norms, seconds per step (host clock around a
    synchronised step) and the model's buffers (BatchNorm statistics) after
    each step."""
    loader = dm.train_dataloader()
    loader.set_epoch(1)
    losses, norms, seconds, relays, stats, halves = [], [], [], [], [], []
    for step, batch in enumerate(loader):
        if step == steps:
            break
        (x,), y = trainer.formatter.process_input(batch)
        torch.cuda.synchronize()
        reset_counts()
        r0, t0 = fb.relaid_weights.count, time.perf_counter()
        loss = float(trainer.train_step(x, y))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        relays.append(fb.relaid_weights.count - r0)
        halves.append(half_counts())
        losses.append(loss)
        norms.append(float(trainer.last_grad_norm))
        stats.append({k: b.detach().cpu().numpy().copy() for k, b in trainer.model.named_buffers()
                      if k in trainer.model.state_dict()})
    return {"losses": losses, "grad_norms": norms, "seconds_per_step": seconds,
            "relays_per_step": relays, "half_launches_per_step": halves,
            "buffers_per_step": stats}


def validation_call(trainer: Trainer, dm) -> dict:
    """One ``eval_step`` on the first validation batch: its loss, model calls
    and half launches."""
    (x,), y = trainer.formatter.process_input(next(iter(dm.val_dataloader())))
    reset_counts()
    with counted_calls(trainer.model) as n:
        loss = float(trainer.eval_step(x, y))
        torch.cuda.synchronize()
    return {"loss": loss, "model_calls": n[0], "half_launches": half_counts()}


def unet_parallel_trainer(dev, workdir: Path, folder: str, mesh=None):
    """A Trainer on AttentionUNet at configs/unet_att.yaml (depth 5, f32,
    seeded weights) over 256x256x8 waves, global batch 2, one model call a
    step (see UNET_STEP2_LOSS_REL_TOL), on one rank or on ``mesh``."""
    dm = WaveDataModule(batch_size=PARALLEL_TRAIN_B, n_steps_input=IN_T, n_steps_output=1,
                        eval_steps_output=2, data_workers=2, seed=0, device=dev,
                        waves={**WELL_WAVES, "n_trajectories": 2, "n_steps": 8})
    model = zoo_model("unet_att", dev, dm.train_dataset.metadata)
    load_jax_params(model, seeded_jax_params(model, seed=0))
    trainer = Trainer(str(workdir / folder), "channels_first_default", model, dm,
                      AdamW(lr=5e-5, weight_decay=1e-5), MSE(), L2RE(), max_epoch=1,
                      n_steps_output=1, n_steps_rollout=2, seed=0, mesh=mesh, device=dev)
    return trainer, dm


# The adaptive training path under a mesh, f32 as configs/tante_adaptive.yaml
# ships (no enable_amp) and dropout 0 (the kernels): the config's one-frame
# engine from seeded weights and the flagship recipe's variable-frame engine
# (scripts/train_flagship.py:92-107) from the trained asset, remat on and
# off; two steps each.  Cut: B 2 (the config's 8, the recipe's 4).
R_PARALLEL_B, R_PARALLEL_STEPS = 2, 2
VF_RECIPE = dict(train_out_T=8.0, rt_band_hi=8.0, rt_eps=3.0, rt_supervision=0.05,
                 rt_sup_mode="growth")
R_PARALLEL_RUNS = (("one_frame", 4, 8, dict(rt_eps=0.5)),
                   ("vf_remat", 16, 16, VF_RECIPE),
                   ("vf_no_remat", 16, 16, dict(VF_RECIPE, gradient_checkpointing=False)))
# f32 on a mesh against one rank on the same card (TF32 off): 3xTF32 sums of
# the halves and their all-reduce in another order than the unsplit
# kernels', nothing rounded below f32.  Every step's loss, r_t mean and
# gradient norm; the flagship forward's change, relative L2.
F32_MESH_REL_TOL = 1e-4
F32_TP_FORWARD_REL_TOL = 1e-5


def r_parallel_runs(dev, workdir: Path, mesh=None) -> dict:
    """``R_PARALLEL_RUNS`` through R_Trainer on the f32 flagship, on one rank
    or on ``mesh``: per step the loss, r_t mean and spread, calls, gradient
    norm, every sample's cums (variable-frame), model calls, half launches
    and weight re-layouts; then one validation step (its model calls, r_t
    log and half launches)."""
    sched = lambda: LinearWarmupCosineAnnealingLR(  # noqa: E731
        warmup_epochs=2, max_epochs=34, lr=5e-5, warmup_start_lr=1e-5)
    out = {}
    for name, n_out, n_val, kw in R_PARALLEL_RUNS:
        dm = WaveDataModule(
            batch_size=R_PARALLEL_B, n_steps_input=IN_T, n_steps_output=n_out,
            eval_steps_output=n_val, data_workers=2, seed=0, device=dev,
            waves=dict(resolution=RES, n_trajectories=2, n_steps=IN_T + n_val + 4,
                       with_pressure=True, seed=0))
        model = flagship(False, torch.float32, dev, dm.train_dataset.metadata, dropout=0.0)
        load_jax_params(model, seeded_jax_params(model, seed=0) if name == "one_frame"
                        else dict(np.load(ASSET)))
        trainer = R_Trainer(str(workdir / f"r_{name}"), "channels_first_default", model, dm,
                            AdamW(lr=5e-5, weight_decay=1e-5), MSE(), L2RE(), max_epoch=34,
                            lr_scheduler=sched(), n_steps_output=n_out, n_steps_rollout=n_val,
                            rt_n=2, seed=0, mesh=mesh, device=dev, **kw)
        rollouts = []

        def kept(*args, objective=trainer._adaptive_loss):  # keeps the rollout's record
            res = objective(*args)
            rollouts.append(res[4])
            return res

        trainer._adaptive_loss = kept
        loader = dm.train_dataloader()
        loader.set_epoch(1)
        (x,), y = trainer.formatter.process_input(next(iter(loader)))
        steps = []
        for _ in range(R_PARALLEL_STEPS):
            torch.cuda.synchronize()
            reset_counts()
            r0, t0 = fb.relaid_weights.count, time.perf_counter()
            with counted_calls(trainer.model) as n:
                loss, rt, rt_var, calls = (float(v) for v in trainer.train_step(x, y))
                torch.cuda.synchronize()
            cums = rollouts[-1]["cums"]
            steps.append({"loss": loss, "rt": rt, "rt_var": rt_var, "calls": calls,
                          "grad_norm": float(trainer.last_grad_norm),
                          "cums": None if cums is None else cums.T.tolist(),
                          "model_calls": n[0], "half_launches": half_counts(),
                          "block_launches": launch_counts(torch.float32),
                          "relays": fb.relaid_weights.count - r0,
                          "seconds": time.perf_counter() - t0})
        (xv,), yv = trainer.formatter.process_input(next(iter(dm.val_dataloader())))
        reset_counts()
        with counted_calls(trainer.model) as n:
            vloss, rt_log, n_calls = trainer.eval_step(xv, yv)
            torch.cuda.synchronize()
        out[name] = {"steps": steps, "validation": {
            "loss": float(vloss), "n_calls": n_calls, "model_calls": n[0],
            "rt_log": rt_log[:n_calls].tolist(), "half_launches": half_counts(),
            "block_launches": launch_counts(torch.float32)},
            "split_parameters": sum(hasattr(q, "tp_dim") for q in trainer.model.parameters()),
            "remat": trainer.gradient_checkpointing}
        del trainer, model
    return out


def tp_launches(dtype: torch.dtype) -> tuple[dict, int]:
    """Every wrapper's launches since the last reset in ``dtype`` (block,
    canonical T, chain, group, both halves, both long-block and both
    long-half kernels, and the mode mixing), and the sum of theirs in any
    other dtype."""
    wrappers = {**BLOCK_WRAPPERS, "attn_half_fwd": fb.attn_half_apply,
                "mlp_half_fwd": fb.mlp_half_apply, **LONG_WRAPPERS, **HALF_LONG_WRAPPERS}
    counts = {k: fn.launches[dtype] for k, fn in wrappers.items()}
    counts["spectral_mode_matmul"] = fs.spectral_mode_matmul.launches
    other = sum(n for fn in wrappers.values() for dt, n in fn.launches.items() if dt != dtype)
    return counts, other


def tp_forward(model, x, dtype, timed: int = 3) -> dict:
    """One warm call of the model, then one counted call (the launches of
    every wrapper in ``dtype`` and in any other) and ``timed`` timed ones;
    weight re-layouts in the first call and in the next 1 + ``timed``."""
    with torch.no_grad():
        relays = fb.relaid_weights.count
        model(x)  # warm
        torch.cuda.synchronize()
        relays_first = fb.relaid_weights.count - relays
        reset_counts()
        relays = fb.relaid_weights.count
        y = model(x)
        torch.cuda.synchronize()
        counts, other = tp_launches(dtype)
        t0 = time.perf_counter()
        for _ in range(timed):
            model(x)
        torch.cuda.synchronize()
    return {"y": y.float().cpu().numpy(), "launches_per_call": counts,
            "other_dtype_launches": other, "seconds_per_call": (time.perf_counter() - t0) / timed,
            "relays_first_call": relays_first, "next_calls": 1 + timed,
            "relays_next_calls": fb.relaid_weights.count - relays}


def flagship_input(batch=BATCH) -> np.ndarray:
    return np.random.default_rng(0).normal(size=(batch, IN_T, *RES, FIELDS)).astype(np.float32)


def parallel_rank(rank: int, world: int, rdv: str, workdir: str, device: str, results) -> None:
    """One rank of the ``parallel`` phase (a spawned process): joins the gloo
    group, runs the flagship forward and the Trainer runs (TANTE, FNO,
    AttentionUNet) on their meshes, hands its numbers to the parent."""
    import datetime
    import hashlib
    import traceback

    import torch.distributed as dist

    from tante_tpu_torch.parallel import dp_tp_mesh, make_mesh

    out = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        dev = torch.device(device)  # every rank on the parent's card
        torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets it: f32 stays f32
        torch.backends.cudnn.allow_tf32 = False
        workdir = Path(workdir)
        tp_mesh = dp_tp_mesh(world, tp=world, device=dev)

        # 1. The flagship forward, blocks split over tp: bf16, then f32 as
        # configs/tante.yaml ships.
        x = torch.from_numpy(flagship_input()).to(dev)
        for key, dtype in (("forward", torch.bfloat16), ("forward_f32", torch.float32)):
            model = flagship(True, dtype, dev, tp_mesh=tp_mesh)
            load_jax_params(model, seeded_jax_params(model, seed=0), tp_mesh)
            out[key] = tp_forward(model, x, dtype)
            del model
        # 1b. The long-axes model (LONG_AXES: the long attention half at L, X,
        # A and C), blocks split over tp, bf16 then f32; the batch cut to
        # LONG_TP_BATCH (gloo carries each C-block all-reduce through the host).
        for key, dtype in (("long_forward", torch.bfloat16), ("long_forward_f32", torch.float32)):
            model = long_model(dtype, dev, tp_mesh=tp_mesh)
            load_jax_params(model, seeded_jax_params(model, seed=0), tp_mesh)
            out[key] = tp_forward(model, x[:LONG_TP_BATCH], dtype, timed=1)
            del model

        # 2. Trainer at (dp 1, tp 2): dropout 0, then a dropout step; save.
        trainer, dm = parallel_trainer(dev, workdir, "tp", "tante", tp_mesh)
        out["train_tp"] = train_steps(trainer, dm, 2)
        out["train_tp"]["split_parameters"] = sum(
            hasattr(q, "tp_dim") for q in trainer.model.parameters())
        trainer.save_model(1, 0.0, "recent")
        with torch.no_grad():
            out["train_tp"]["y_after"] = trainer.model(x[:2]).float().cpu().numpy()
        del trainer
        trainer, dm = parallel_trainer(dev, workdir, "tp_dropout", "tante", tp_mesh, dropout=0.1)
        train_steps(trainer, dm, 1)
        out["dropout_replicas"] = {
            k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
            for k, v in trainer.model.named_parameters() if not hasattr(v, "tp_dim")}
        del trainer
        # 2b. The same Trainer in f32 (enable_amp=False), dropout 0: the f32
        # halves; then one validation step.
        trainer, dm = parallel_trainer(dev, workdir, "tp_f32", "tante", tp_mesh, amp=False)
        out["train_tp_f32"] = train_steps(trainer, dm, 2)
        out["train_tp_f32"]["validation"] = validation_call(trainer, dm)
        del trainer
        # 2c. R_Trainer at (dp 1, tp 2) in f32: both engines, remat on and off.
        out["r_trainer"] = r_parallel_runs(dev, workdir / "r", tp_mesh)

        # 3. Trainer at (dp 2, tp 1); 4. FNO at (dp 1, sp 2).
        dp_mesh = dp_tp_mesh(world, tp=1, device=dev)
        trainer, dm = parallel_trainer(dev, workdir, "dp", "tante", dp_mesh)
        out["train_dp"] = train_steps(trainer, dm, 2)
        del trainer
        sp_mesh = make_mesh(world, ("dp", "sp"), (1, world), device=dev)
        trainer, dm = parallel_trainer(dev, workdir, "sp", "fno", sp_mesh)
        out["train_sp"] = train_steps(trainer, dm, 2)
        out["train_sp"]["local_field_rows"] = next(iter(dm.train_dataloader()))["input"].shape[2]
        del trainer
        # 5. AttentionUNet at (dp 1, sp 2): halo convs; at (dp 2, sp 1): one sample a rank.
        for key, shape in (("unet_sp", (1, world)), ("unet_dp", (world, 1))):
            mesh = make_mesh(world, ("dp", "sp"), shape, device=dev)
            trainer, dm = unet_parallel_trainer(dev, workdir, key, mesh)
            out[key] = train_steps(trainer, dm, 2)
            batch = next(iter(dm.train_dataloader()))["input"]
            out[key]["local_batch"] = list(batch.shape)
            del trainer
        dist.destroy_process_group()
    except Exception:  # the parent reports it and fails the phase
        out = {"error": traceback.format_exc()}
    results.put((rank, out))


def phase_parallel(dev, workdir: Path) -> dict:
    """Two ranks of one gloo process group share the card (NCCL refuses two
    ranks on one device); each runs ``parallel_rank``.  Their numbers are
    held here against single-rank runs of the same code: the flagship
    forward with its blocks split over tp = 2 (exactly 18 half-kernel
    launches a model call, no single-device kernel), every step's loss and
    gradient norm of Trainer at (dp 1, tp 2), (dp 2, tp 1) and FNO at (dp 1, sp 2), replicas
    equal after a dropout step, the tp checkpoint on one rank, and AttentionUNet
    at (dp 1, sp 2) and (dp 2, sp 1) with its BatchNorm statistics.  Times
    are two ranks sharing one card through gloo: not a tp speed."""
    import multiprocessing

    # Single-rank references, the same seeds.
    x = torch.from_numpy(flagship_input()).to(dev)
    y_single = {}
    for key, dtype in (("forward", torch.bfloat16), ("forward_f32", torch.float32)):
        model = flagship(True, dtype, dev)
        load_jax_params(model, seeded_jax_params(model, seed=0))
        with torch.no_grad():
            y_single[key] = model(x).float().cpu()
        del model
    for key, dtype in (("long_forward", torch.bfloat16), ("long_forward_f32", torch.float32)):
        model = long_model(dtype, dev)
        load_jax_params(model, seeded_jax_params(model, seed=0))
        with torch.no_grad():
            y_single[key] = model(x[:LONG_TP_BATCH]).float().cpu()
        del model
    single = {}
    for name, kind in (("tante", "tante"), ("fno", "fno")):
        trainer, dm = parallel_trainer(dev, workdir / "single", name, kind)
        single[name] = train_steps(trainer, dm, 2)
        del trainer
    trainer, dm = parallel_trainer(dev, workdir / "single", "tante_f32", "tante", amp=False)
    single["tante_f32"] = train_steps(trainer, dm, 2)
    single["tante_f32"]["validation"] = validation_call(trainer, dm)
    del trainer
    single["r_trainer"] = r_parallel_runs(dev, workdir / "single" / "r")
    trainer, dm = unet_parallel_trainer(dev, workdir / "single", "unet")
    single["unet"] = train_steps(trainer, dm, 2)
    del trainer

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # both ranks on this host
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="rdv_", dir=workdir)
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, PARALLEL_WORLD, os.path.join(rdv, "file"), str(workdir / "mesh"),
                               str(dev), results))
             for r in range(PARALLEL_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    ranks = {}
    try:
        while len(ranks) < PARALLEL_WORLD:
            r, got = results.get(timeout=max(1.0, PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)))
            ranks[r] = got
    except queue.Empty:
        check(False, f"parallel: ranks {sorted(set(range(PARALLEL_WORLD)) - set(ranks))} did not "
                     f"finish within {PARALLEL_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: o["error"] for r, o in ranks.items() if "error" in o}
    check(not errors and len(ranks) == PARALLEL_WORLD, f"parallel: rank failures {errors}")
    res = {"phase": "parallel", "world": PARALLEL_WORLD, "backend": "gloo, both ranks on cuda:0",
           "seconds": time.perf_counter() - t0, "errors": errors}
    if errors or len(ranks) < PARALLEL_WORLD:
        emit(res)
        return res
    r0, r1 = ranks[0], ranks[1]

    # 1. forward, bf16 and f32: the flagship (9 blocks, each two short
    # halves), then the long-axes model at B LONG_TP_BATCH (T, H, W, Y on the
    # short attention half, L, X, A, C on the long one's two kernels; eight
    # MLP halves).
    want = {name: 0 for name in (*BLOCK_WRAPPERS, "attn_half_fwd", "mlp_half_fwd",
                                 *LONG_WRAPPERS, *HALF_LONG_WRAPPERS, "spectral_mode_matmul")}
    wants = {"forward": {**want, "attn_half_fwd": 9, "mlp_half_fwd": 9},
             "long_forward": {**want, "attn_half_fwd": 4, "mlp_half_fwd": 8,
                              **{name: 4 for name in HALF_LONG_WRAPPERS}}}
    wants["forward_f32"], wants["long_forward_f32"] = wants["forward"], wants["long_forward"]
    forward = {}
    for key, tol in (("forward", ROLLOUT_REL_TOL), ("forward_f32", F32_TP_FORWARD_REL_TOL),
                     ("long_forward", ROLLOUT_REL_TOL),
                     ("long_forward_f32", F32_TP_FORWARD_REL_TOL)):
        b = LONG_TP_BATCH if key.startswith("long") else BATCH
        u = x[:b, -1:].float().cpu()
        fwd_err = [rel_l2(torch.from_numpy(r[key]["y"]) - u, y_single[key] - u) for r in (r0, r1)]
        check(all(r[key]["launches_per_call"] == wants[key]
                  and not r[key]["other_dtype_launches"] for r in (r0, r1)),
              f"tp {key} launches {r0[key]['launches_per_call']} (and "
              f"{r0[key]['other_dtype_launches']} in the other dtype), want {wants[key]}")
        check(max(fwd_err) <= tol, f"tp=2 {key} vs single rank: rel L2 {fwd_err}")
        check(np.array_equal(r0[key]["y"], r1[key]["y"]), f"tp ranks' {key} outputs differ")
        # Each rank re-lays its blocks' two halves once (9 or 8 blocks), though
        # every call casts the f32 parameters to bf16 anew (bf16) and hands the
        # LayerNorm ones to the halves as new copy_to_tp views; a Trainer
        # re-lays them once per optimizer step.
        blocks = len(LONG_AXES) if key.startswith("long") else 9
        relays = [(r[key]["relays_first_call"], r[key]["relays_next_calls"]) for r in (r0, r1)]
        check(all(r == (2 * blocks, 0) for r in relays),
              f"tp {key} re-layouts (first call, next {r0[key]['next_calls']}) {relays}")
        forward[key] = {
            "batch": b, "dtype": "f32" if key.endswith("f32") else "bf16",
            "weights": "seeded (numpy seed 0)",
            "launches_per_model_call_per_rank": r0[key]["launches_per_call"],
            "other_dtype_launches": r0[key]["other_dtype_launches"],
            "weight_relayouts_per_rank_first_call_then_next_calls": relays,
            "next_calls": r0[key]["next_calls"],
            "change_vs_single_rank_rel_l2": fwd_err, "rel_l2_tolerance": tol,
            "seconds_per_call": [r[key]["seconds_per_call"] for r in (r0, r1)]}
        if key.startswith("long"):
            forward[key].update({"attn_axes": LONG_AXES, "expanded_channel": EXPANDED,
                                 "batch_cut_from": BATCH})

    # 2-4. every step's loss and gradient norm against the single-rank Trainer
    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))

    losses = {}
    for name, ref in (("train_tp", single["tante"]), ("train_dp", single["tante"]),
                      ("train_sp", single["fno"]), ("unet_sp", single["unet"]),
                      ("unet_dp", single["unet"])):
        run = r0[name]
        held = 1 if name.startswith("unet") else None  # see UNET_STEP2_LOSS_REL_TOL
        gaps = {"loss": rel(run["losses"][:held], ref["losses"][:held]),
                "grad_norm": rel(run["grad_norms"][:held], ref["grad_norms"][:held])}
        if held:
            gaps["step_2"] = {"loss": rel(run["losses"][1:], ref["losses"][1:]),
                              "grad_norm": rel(run["grad_norms"][1:], ref["grad_norms"][1:])}
            check(gaps["step_2"]["loss"] <= UNET_STEP2_LOSS_REL_TOL
                  and gaps["step_2"]["grad_norm"] <= UNET_STEP2_GNORM_REL_TOL,
                  f"{name}: second step {gaps['step_2']} vs one rank")
        losses[name] = {"losses": run["losses"], "single_rank_losses": ref["losses"],
                        "grad_norms": run["grad_norms"], "single_rank_grad_norms": ref["grad_norms"],
                        "worst_rel_gap": gaps,
                        "seconds_per_step": run["seconds_per_step"],
                        "relays_per_step": run["relays_per_step"],
                        "single_rank_relays_per_step": ref["relays_per_step"],
                        "single_rank_seconds_per_step": ref["seconds_per_step"]}
        check(gaps["loss"] <= MESH_LOSS_REL_TOL,
              f"{name}: losses {run['losses']} vs {ref['losses']} on one rank")
        check(gaps["grad_norm"] <= MESH_GNORM_REL_TOL,
              f"{name}: gradient norms {run['grad_norms']} vs {ref['grad_norms']} on one rank")
        check(run["losses"] == r1[name]["losses"], f"{name}: the ranks log different losses")
    f32_train = f32_trainer_checks(r0, r1, single)
    r_trainer = r_trainer_checks(r0, r1, single["r_trainer"])
    check(r0["train_tp"]["split_parameters"] == 9 * 10, "tp Trainer: blocks not split")
    check(all(r["train_tp"]["relays_per_step"] == [18, 18] for r in (r0, r1)),
          f"tp Trainer re-layouts per step {[r['train_tp']['relays_per_step'] for r in (r0, r1)]}"
          f", want 18 (9 blocks' two halves, once per optimizer step)")
    check(r0["train_sp"]["local_field_rows"] == RES[0] // PARALLEL_WORLD,
          "sp Trainer: batches are not this rank's H rows")
    # AttentionUNet: the batches are this rank's rows / samples; the BatchNorm
    # statistics are the global batch's, the same on both ranks, and after
    # the first step the single rank's (UNET_STEP2_LOSS_REL_TOL: the second
    # step's are reported).
    want_shape = {"unet_sp": [1, IN_T, WELL_RES[0] // PARALLEL_WORLD, WELL_RES[1], 8],
                  "unet_dp": [1, IN_T, *WELL_RES, 8]}
    unet_stats = {}
    for name in ("unet_sp", "unet_dp"):
        want_b = [PARALLEL_TRAIN_B // (1 if name == "unet_sp" else PARALLEL_WORLD)]
        check(r0[name]["local_batch"] == want_b + want_shape[name][1:],
              f"{name}: a rank's batch is {r0[name]['local_batch']}")
        equal = all(np.array_equal(a[k], b[k]) for a, b in zip(r0[name]["buffers_per_step"],
                                                               r1[name]["buffers_per_step"])
                    for k in a)
        gaps = [max(rel_l2(torch.from_numpy(a[k]), torch.from_numpy(b[k])) for k in b)
                for a, b in zip(r0[name]["buffers_per_step"], single["unet"]["buffers_per_step"])]
        check(equal, f"{name}: the ranks' BatchNorm statistics differ")
        check(gaps[0] <= MESH_STATS_REL_TOL,
              f"{name}: BatchNorm statistics after the first step vs one rank: {gaps[0]}")
        unet_stats[name] = {"equal_on_both_ranks": equal, "worst_rel_l2_vs_one_rank": gaps}
    same = r0["dropout_replicas"] == r1["dropout_replicas"]
    check(same, "replicated parameters differ across tp ranks after a dropout step")

    # 5. the tp checkpoint on one rank
    model = flagship(True, torch.bfloat16, dev, parallel_data(dev, 2, IN_T).train_dataset.metadata)
    restored = torch.load(workdir / "mesh" / "tp" / "recent" / "state.pt", map_location=dev,
                          weights_only=True)
    model.load_state_dict(restored["params"])
    with torch.no_grad():
        y_ckpt = model(x[:2]).float().cpu()
    ckpt_err = rel_l2(torch.from_numpy(r0["train_tp"]["y_after"]) - x[:2, -1:].float().cpu(),
                      y_ckpt - x[:2, -1:].float().cpu())
    check(ckpt_err <= ROLLOUT_REL_TOL, f"tp checkpoint on one rank: rel L2 {ckpt_err}")
    res.update({
        **forward, "trainer_f32": f32_train, "r_trainer_f32": r_trainer,
        "trainer": losses, "loss_rel_tol": MESH_LOSS_REL_TOL,
        "grad_norm_rel_tol": MESH_GNORM_REL_TOL,
        "dropout_0.1_step_replicated_parameters_equal": same,
        "unet_att_batch_stats": unet_stats, "unet_att_first_step_stats_rel_tol": MESH_STATS_REL_TOL,
        "unet_att_second_step_rel_tol": {"loss": UNET_STEP2_LOSS_REL_TOL,
                                          "grad_norm": UNET_STEP2_GNORM_REL_TOL},
        "tp_checkpoint_on_one_rank_rel_l2": ckpt_err,
        "times_are": "two ranks sharing one card through gloo: not a tp speed"})
    emit(res)
    return res


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def f32_trainer_checks(r0: dict, r1: dict, single: dict) -> dict:
    """The f32 Trainer at (dp 1, tp 2) against one rank: every step's loss
    and gradient norm (F32_MESH_REL_TOL), 9 + 9 f32 half launches per model
    call (two a train step, forward; backward recomputes the plain halves)
    and none in bf16, 18 re-layouts a step, and the validation call."""
    run, ref = r0["train_tp_f32"], single["tante_f32"]
    gaps = {"loss": max(rel_gap(a, b) for a, b in zip(run["losses"], ref["losses"], strict=True)),
            "grad_norm": max(rel_gap(a, b) for a, b in zip(run["grad_norms"], ref["grad_norms"],
                                                          strict=True))}
    check(max(gaps.values()) <= F32_MESH_REL_TOL,
          f"f32 tp Trainer vs one rank: {gaps} (losses {run['losses']} vs {ref['losses']})")
    check(run["losses"] == r1["train_tp_f32"]["losses"], "f32 tp Trainer: the ranks' losses differ")
    per_step = {"attn_half_fwd": {"bf16": 0, "f32": 18}, "mlp_half_fwd": {"bf16": 0, "f32": 18}}
    check(all(h == per_step for r in (r0, r1) for h in r["train_tp_f32"]["half_launches_per_step"]),
          f"f32 tp Trainer half launches per step {run['half_launches_per_step']}, want {per_step}")
    check(all(r["train_tp_f32"]["relays_per_step"] == [18, 18] for r in (r0, r1)),
          f"f32 tp Trainer re-layouts per step {run['relays_per_step']}, want 18")
    val, val_ref = run["validation"], ref["validation"]
    calls = val["model_calls"]
    want_val = {k: {"bf16": 0, "f32": 9 * calls} for k in per_step}
    check(val["half_launches"] == want_val and calls == val_ref["model_calls"],
          f"f32 tp validation: {val['half_launches']} half launches for {calls} calls")
    check(rel_gap(val["loss"], val_ref["loss"]) <= F32_MESH_REL_TOL,
          f"f32 tp validation loss {val['loss']} vs {val_ref['loss']} on one rank")
    return {"losses": run["losses"], "single_rank_losses": ref["losses"],
            "grad_norms": run["grad_norms"], "single_rank_grad_norms": ref["grad_norms"],
            "worst_rel_gap": gaps, "rel_tol": F32_MESH_REL_TOL,
            "half_launches_per_step": run["half_launches_per_step"][0],
            "relays_per_step": run["relays_per_step"],
            "seconds_per_step": run["seconds_per_step"],
            "single_rank_seconds_per_step": ref["seconds_per_step"],
            "validation": {"loss": val["loss"], "single_rank_loss": val_ref["loss"],
                           "model_calls": calls, "half_launches": val["half_launches"]}}


def r_trainer_checks(r0: dict, r1: dict, single: dict) -> dict:
    """R_Trainer at (dp 1, tp 2) in f32 against one rank, per run of
    ``R_PARALLEL_RUNS``: every step's loss, r_t mean and gradient norm within
    F32_MESH_REL_TOL, equal calls, cums and model calls; the ranks equal;
    9 + 9 f32 half launches per model call (twice under remat), none in bf16
    and no single-device block launch; 18 re-layouts a step; the validation
    step's calls, r_t log and loss."""
    out = {}
    for name, *_ in R_PARALLEL_RUNS:
        run, other, ref = r0["r_trainer"][name], r1["r_trainer"][name], single[name]
        check(run["split_parameters"] == 9 * 10, f"R_Trainer {name} at tp 2: blocks not split")
        factor = 2 if run["remat"] else 1
        gaps = []
        for i, (a, b, c) in enumerate(zip(run["steps"], ref["steps"], other["steps"], strict=True)):
            g = {k: rel_gap(a[k], b[k]) for k in ("loss", "rt", "grad_norm")}
            gaps.append(g)
            check(max(g.values()) <= F32_MESH_REL_TOL,
                  f"R_Trainer {name} step {i} at tp 2 vs one rank: {g}")
            check(a["calls"] == b["calls"] and a["cums"] == b["cums"]
                  and a["model_calls"] == b["model_calls"],
                  f"R_Trainer {name} step {i}: calls {a['calls']} / {b['calls']}, cums "
                  f"{a['cums']} / {b['cums']}, model calls {a['model_calls']} / "
                  f"{b['model_calls']} at tp 2 / on one rank")
            check(all(a[k] == c[k] for k in ("loss", "rt", "calls", "cums", "grad_norm")),
                  f"R_Trainer {name} step {i}: the tp ranks differ")
            want = {k: {"bf16": 0, "f32": factor * 9 * a["model_calls"]}
                    for k in ("attn_half_fwd", "mlp_half_fwd")}
            check(a["half_launches"] == want and not any(a["block_launches"].values())
                  and a["relays"] == 18,
                  f"R_Trainer {name} step {i}: half launches {a['half_launches']} (want {want}), "
                  f"block launches {a['block_launches']}, {a['relays']} re-layouts (want 18)")
        val, vref = run["validation"], ref["validation"]
        want = {k: {"bf16": 0, "f32": 9 * val["model_calls"]}
                for k in ("attn_half_fwd", "mlp_half_fwd")}
        check(val["n_calls"] == vref["n_calls"] == val["model_calls"]
              and val["half_launches"] == want,
              f"R_Trainer {name} validation at tp 2: {val['n_calls']} calls (one rank "
              f"{vref['n_calls']}), half launches {val['half_launches']}")
        check(rel_gap(val["loss"], vref["loss"]) <= F32_MESH_REL_TOL
              and max((rel_gap(a, b) for a, b in zip(val["rt_log"], vref["rt_log"])),
                      default=0.0) <= F32_MESH_REL_TOL,
              f"R_Trainer {name} validation at tp 2: loss {val['loss']} vs {vref['loss']}, r_t "
              f"{val['rt_log']} vs {vref['rt_log']}")
        out[name] = {
            "steps": [{k: a[k] for k in ("loss", "rt", "rt_var", "calls", "grad_norm", "cums",
                                         "model_calls", "half_launches", "relays", "seconds")}
                      for a in run["steps"]],
            "single_rank_steps": [{k: b[k] for k in ("loss", "rt", "grad_norm", "calls",
                                                     "seconds")} for b in ref["steps"]],
            "worst_rel_gap": {k: max(g[k] for g in gaps) for k in gaps[0]},
            "validation": {"n_calls": val["n_calls"], "loss": val["loss"],
                           "single_rank_loss": vref["loss"],
                           "half_launches": val["half_launches"]},
            "remat": run["remat"]}
    return out


def cli_launches(cli: dict, name: str, runs=CLI_CONFIGS) -> dict:
    """A block wrapper's launches on the paper's entry points (cli phase),
    in each of ``runs``' dtype: per train step (dropout 0.1), per validation
    model call, per from_experiment rollout."""
    out = {}
    for config in runs:
        epochs = cli[config]["train_max_epoch_1"]["epochs"]
        out[config] = {
            "train_step": sum(e["launches"][name] for e in epochs if e["kind"] == "train")
            / sum(e["batches"] for e in epochs if e["kind"] == "train"),
            "validation_model_call": sum(e["launches"][name] for e in epochs
                                         if e["kind"] == "validation")
            / max(1, sum(e["model_calls"] for e in epochs if e["kind"] == "validation")),
            "from_experiment_rollout": cli[config]["from_experiment"]["launches_per_rollout"][
                name]}
    return out


def long_rows(kernels_long: dict[str, list[dict]], long_axes: dict) -> list[dict]:
    """The kernels line's rows of the long entry: each kernel in each dtype,
    its launches per long_axes rollout; ms, bound and plain time are means
    over the flagship's L, X, A and C blocks ("fast" softmax), per axis
    beside them.  The plain version is of the whole block (both entries):
    ``plain_ms`` is the plain block's time."""
    rows = []
    for dt, cases in kernels_long.items():
        main = [c for c in cases if "kernel_ms" in c]
        mean = lambda f: sum(f(c) for c in main) / len(main)  # noqa: E731
        lane = long_axes[dt]
        for name, part in (("fused_block_long_qkv_fwd", "qkv"),
                           ("fused_block_long_attn_fwd", "attn")):
            rows.append({
                "name": name if dt == "bf16" else f"{name} (f32)", "route": "cuda",
                "source": LONG_SOURCE, "entry": LONG_ENTRIES[name].format(
                    "_f32" if dt == "f32" else ""),
                "replaces": "tante_tpu/ops/pallas_block.py:163 (fused_block_apply :208 at L > 64"
                            + (", f32 activations)" if dt == "f32" else ")"),
                "launches": lane["launches_per_rollout"][name],
                "launches_counted_over": f"one long_axes 16-step rollout ({dt})",
                # qkv: its workspace against qkv_reference; attention: the block's output
                "max_abs_err": max((c["qkv_workspace"] if part == "qkv" else c)["max_abs_err"]  # noqa: B023
                                   for c in cases),
                "ms": mean(lambda c: c[f"{part}_ms"]),  # noqa: B023
                "plain_ms": mean(lambda c: c["plain_ms"]),
                "plain_is": "the plain block (block_ref, f32), both entries' work; at C on 512 "
                            "sequences, scaled",
                "bound_ms": mean(lambda c: c["bounds"][part]["bound_us"]) / 1e3,  # noqa: B023
                "bound_by": main[0]["bounds"][part]["bound_by"],
                "library_ms": None,  # no single PyTorch call computes a whole block
                "block_ms": mean(lambda c: c["kernel_ms"]),
                "block_bound_ms": mean(lambda c: c["bounds"]["block"]["bound_us"]) / 1e3,
                "ok": all(c["ok"] for c in cases),
                "per_axis": [{"axis": c["case"], "shape": c["shape"], "ms": c[f"{part}_ms"],
                              "bound_ms": c["bounds"][part]["bound_us"] / 1e3,
                              "bound_by": c["bounds"][part]["bound_by"],
                              "gb_per_s": c["bounds"][part]["bytes"] / c[f"{part}_ms"] / 1e6,
                              "block_ms": c["kernel_ms"],
                              "block_bound_ms": c["bounds"]["block"]["bound_us"] / 1e3,
                              "plain_ms": c["plain_ms"], "max_abs_err": c["max_abs_err"]}
                             for c in main],
            })
    return rows


def half_long_rows(tp_long: dict[str, list[dict]], parallel: dict) -> list[dict]:
    """The kernels line's rows of the long attention half: each kernel in
    each dtype, its launches per long-axes model call on one rank of (dp 1,
    tp 2) (the parallel phase); ms, bound and plain time are means over the
    flagship's L, X, A and C blocks (shard 0 at tp 2, "fast"), per axis
    beside them.  The plain version is of the whole half (both kernels):
    ``plain_ms`` is the plain half's time."""
    rows = []
    for dt, cases in tp_long.items():
        main = [c for c in cases if "kernel_ms" in c]
        mean = lambda f: sum(f(c) for c in main) / len(main)  # noqa: E731
        key = "long_forward_f32" if dt == "f32" else "long_forward"
        per_call = parallel.get(key, {}).get("launches_per_model_call_per_rank", {})
        for name, part in (("attn_half_long_qkv_fwd", "qkv"), ("attn_half_long_attn_fwd", "attn")):
            rows.append({
                "name": name if dt == "bf16" else f"{name} (f32)", "route": "cuda",
                "source": HALF_LONG_SOURCE, "entry": HALF_LONG_ENTRIES[name].format(
                    "_f32" if dt == "f32" else ""),
                "replaces": "tante_tpu/ops/pallas_block.py:730 (_attn_half_kernel :696 at L > 64"
                            + (", f32 activations)" if dt == "f32" else ")"),
                "launches": per_call.get(name, 0),
                "launches_counted_over": f"one {LONG_AXES} model call on one rank of (dp 1, tp 2), "
                                         f"{dt}",
                # qkv: each shard's workspace against qkv_reference; attention: the partial
                "max_abs_err": max(q["max_abs_err"] for c in cases for q in c["qkv_workspace"])
                if part == "qkv" else max(c["max_abs_err"] for c in cases),
                "ms": mean(lambda c: c[f"{part}_ms"]),  # noqa: B023
                "plain_ms": mean(lambda c: c["plain_ms"]),
                "plain_is": "the plain half (attn_half_ref, f32), both kernels' work; at C on 512 "
                            "sequences, scaled",
                "bound_ms": mean(lambda c: c["bounds"][part]["bound_us"]) / 1e3,  # noqa: B023
                "bound_by": main[0]["bounds"][part]["bound_by"],
                "library_ms": None,  # no single PyTorch call computes a half block
                "half_ms": mean(lambda c: c["kernel_ms"]),
                "half_bound_ms": mean(lambda c: c["bounds"]["half"]["bound_us"]) / 1e3,
                "ok": all(c["ok"] for c in cases),
                "per_axis": [{"axis": c["case"], "shape": c["shape"], "ms": c[f"{part}_ms"],
                              "bound_ms": c["bounds"][part]["bound_us"] / 1e3,
                              "bound_by": c["bounds"][part]["bound_by"],
                              "gb_per_s": c["bounds"][part]["bytes"] / c[f"{part}_ms"] / 1e6,
                              "half_ms": c["kernel_ms"],
                              "half_bound_ms": c["bounds"]["half"]["bound_us"] / 1e3,
                              "half_with_workspace_bound_ms":
                                  c["bounds"]["half_with_workspace"]["bound_us"] / 1e3,
                              "plain_ms": c["plain_ms"], "max_abs_err": c["max_abs_err"]}
                             for c in main],
            })
    return rows


def phase_summary(kernels: dict[str, list[dict]], chains: dict[str, dict],
                  kernels_f32: dict[str, list[dict]], chains_f32: dict[str, dict], fixed: dict,
                  fixed_f32: dict, train: dict, adaptive_train: dict, cli: dict,
                  spectral: list[dict], fno: dict, packed: list[dict], avit: dict, cvit: dict,
                  tp: list[dict], tp_f32: list[dict], parallel: dict,
                  kernels_long: dict[str, list[dict]], long_axes: dict,
                  tp_long: dict[str, list[dict]], overlap: dict) -> list[dict]:
    replaces = {"fused_block_fwd": "tante_tpu/ops/pallas_block.py:163",
                "fused_block_canon_t_fwd": "tante_tpu/ops/pallas_block.py:401",
                "fused_chain_apply": "tante_tpu/ops/pallas_block.py:1073",
                "fused_group_apply": "tante_tpu/ops/pallas_block.py:989"}
    out = []
    for name, cases in kernels.items():
        # Headline numbers: mean over the main path's shapes (the H and W
        # blocks for fused_block_fwd; the causal and safe cases are checks).
        main = [c for c in cases if c["case"] in (*MAIN_BLOCK_CASES, "T")]
        mean = lambda k: sum(c[k] for c in main) / len(main)  # noqa: E731
        row = {
            "name": name, "route": "cuda", "source": SM90_SOURCE,
            "replaces": replaces[name],
            "launches": fixed["launches_per_rollout"][name],
            "launches_counted_over": "one fixed 16-step rollout",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_us") / 1e3, "bound_by": main[0]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a whole block
            "ok": all(c["ok"] for c in cases),
            "per_shape": [{k: c.get(k) for k in (
                "case", "shape", "softmax", "kernel_ms", "first_design_ms", "plain_ms", "bound_us",
                "max_abs_err")} for c in cases],
            # The same blocks on the first design's body, in turns on this card.
            "first_design_ms": mean("first_design_ms"),
        }
        if name == "fused_block_canon_t_fwd":
            row["rearranged_fused_block_fwd_ms"] = mean("rearranged_fused_block_fwd_ms")
        # The adaptive training path (R_Trainer): per step, forward (and the
        # recompute in backward under remat).
        row["launches_per_r_trainer_step"] = {
            "one_frame": adaptive_train["one_frame"]["dropout_0"]["launches_per_step"][name],
            "variable_frame_remat":
                adaptive_train["variable_frame"]["remat"]["launches_per_step"][name]}
        # The paper's entry points in bf16 (cli phase, configs/tante.yaml
        # with the CLI_AMP overrides).
        row["launches_on_the_cli_path"] = cli_launches(cli, name, ("tante_bf16",))
        # The overlap phase's rollouts (overlap 0.5, and TANTE-FNO at 0.25).
        row["launches_per_overlap_rollout"] = {
            "flagship": overlap["bf16"]["launches_per_rollout"][name],
            "tante_fno": overlap["fno"]["launches_per_rollout"][name]}
        out.append(row)
    val = train["validation"]
    per_call = {"fused_chain_apply": val["fused_chain=3"]["launches_per_model_call"],
                "fused_group_apply": val["fused_group"]["launches_per_model_call"]}
    for wrapper, c in chains.items():
        out.append({
            "name": f"fused_chain_fwd ({wrapper}, run {c['case']})", "route": "cuda",
            "source": CHAIN_SOURCE, "replaces": replaces[wrapper],
            "launches": int(per_call[wrapper][wrapper]),
            "launches_counted_over": "one model call of the Trainer's validation loop",
            "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_us"] / 1e3, "bound_by": c["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a run of blocks
            "ok": c["ok"],
            "single_block_kernels_in_sequence_ms": c["single_block_kernels_in_sequence_ms"],
            "first_design_ms": c["first_design_ms"],
            "equals_single_block_kernels_in_sequence_bit_for_bit":
                c["equals_single_block_kernels_in_sequence_bit_for_bit"],
        })
    # The f32 entries (configs/tante.yaml as shipped): the single-block and
    # canonical T kernels counted over the fixed_f32 lane's rollout, the
    # chain over its fused_chain=3 rollout (the group's beside it).
    for name, cases in kernels_f32.items():
        main = [c for c in cases if c["case"] in (*MAIN_BLOCK_CASES, "T")]
        mean = lambda k: sum(c[k] for c in main) / len(main)  # noqa: E731
        out.append({
            "name": f"{name} (f32)", "route": "cuda", "source": SM90_SOURCE,
            "entry": F32_ENTRIES[name], "replaces": replaces[name] + " (f32 activations)",
            "launches": fixed_f32["launches_per_rollout"][name],
            "launches_counted_over": "one fixed_f32 16-step rollout (configs/tante.yaml as "
                                     "shipped)",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "rel_l2": max(c["rel_l2"] for c in cases),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_us") / 1e3, "bound_by": main[0]["bound_by"],
            "ffma_bound_ms": mean("ffma_bound_us") / 1e3,
            "library_ms": None,  # no single PyTorch call computes a whole block
            "ok": all(c["ok"] for c in cases),
            "per_shape": [{k: c.get(k) for k in (
                "case", "shape", "softmax", "kernel_ms", "plain_ms", "bound_us", "rel_l2",
                "max_abs_err")} for c in cases],
            "launches_on_the_cli_path": cli_launches(cli, name),
            "launches_per_overlap_rollout": overlap["f32"]["launches_per_rollout"][name],
            "launches_per_overlap_train_step": overlap["train"]["launches_per_step"][name],
        })
    chain, group = chains_f32["fused_chain_apply"], chains_f32["fused_group_apply"]
    fusion = fixed_f32["fusion"]
    out.append({
        "name": f"fused_chain_fwd (f32, run {chain['case']})", "route": "cuda",
        "source": CHAIN_SOURCE, "entry": F32_ENTRIES["fused_chain_fwd"],
        "replaces": replaces["fused_chain_apply"] + " (f32 activations)",
        "launches": fusion["fused_chain=3"]["launches_per_rollout"]["fused_chain_apply"],
        "launches_counted_over": "one fixed_f32 16-step rollout with fused_chain=3",
        "max_abs_err": chain["max_abs_err"], "rel_l2": chain["rel_l2"],
        "ms": chain["kernel_ms"], "plain_ms": chain["plain_ms"],
        "bound_ms": chain["bound_us"] / 1e3, "bound_by": chain["bound_by"],
        "ffma_bound_ms": chain["ffma_bound_us"] / 1e3,
        "library_ms": None,  # no single PyTorch call computes a run of blocks
        "ok": chain["ok"] and group["ok"],
        "single_block_kernels_in_sequence_ms": chain["single_block_kernels_in_sequence_ms"],
        "equals_single_block_kernels_in_sequence_bit_for_bit":
            chain["equals_single_block_kernels_in_sequence_bit_for_bit"],
        "group": {"case": group["case"],
                  "launches": fusion["fused_group"]["launches_per_rollout"]["fused_group_apply"],
                  "launches_counted_over": "one fixed_f32 16-step rollout with fused_group",
                  **{k: group[k] for k in (
                      "kernel_ms", "plain_ms", "single_block_kernels_in_sequence_ms",
                      "rel_l2", "max_abs_err", "equals_single_block_kernels_in_sequence_bit_for_bit")},
                  "bound_ms": group["bound_us"] / 1e3},
    })
    # Headline numbers of the mode-mixing kernel: mean over the shapes the
    # FNO serving paths give it, one launch each per model call.
    main = [c for c in spectral if c["main_path"]]
    mean = lambda k: sum(c[k] for c in main) / len(main)  # noqa: E731
    out.append({
        "name": "spectral_mode_matmul", "route": "cuda", "source": SPECTRAL_SOURCE,
        "replaces": "tante_tpu/ops/pallas_spectral.py:97",
        "launches": fno["tante_fno"]["spectral_mode_matmul_launches_per_rollout"],
        "launches_counted_over": "one 16-step rollout of TANTE with the FNO encoder/decoder",
        "launches_per_fno_rollout": fno["fno_cw"]["spectral_mode_matmul_launches_per_rollout"],
        "launches_per_overlap_rollout":
            overlap["fno"]["spectral_mode_matmul_launches_per_rollout"],
        "max_abs_err": max(c["max_abs_err"] for c in spectral),
        "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_us") / 1e3,
        "bound_by": main[0]["bound_by"], "library_ms": mean("library_ms"),
        "library_call": main[0]["library_call"],
        "times_are": "device time (torch.profiler); *_call_ms: per call, back to back (events)",
        "call_ms": mean("kernel_call_ms"), "plain_call_ms": mean("plain_call_ms"),
        "library_call_ms": mean("library_call_ms"), "ok": all(c["ok"] for c in spectral),
        "shapes_no_slower_than_library": sum(c["kernel_ms"] <= c["library_ms"] for c in main),
        "per_shape": [{k: c[k] for k in ("case", "B", "modes", "Cin", "Cout", "layout",
                                          "kernel_ms", "plain_ms", "library_ms",
                                          "kernel_over_library", "kernel_call_ms",
                                          "plain_call_ms", "library_call_ms", "bound_us",
                                          "bound_by", "max_abs_err")} for c in main],
    })
    # The attention core: its main path is AViT's axial attention (row and
    # column views of one projection, one shape).
    main = [c for c in packed if c["main_path"]]
    mean = lambda k: sum(c[k] for c in main) / len(main)  # noqa: E731
    out.append({
        "name": "packed_attention", "route": "cuda", "source": PACKED_SOURCE,
        "replaces": "tante_tpu/ops/pallas_attention.py:107",
        "launches": avit["serving"]["launches_per_rollout"]["packed_attention"],
        "launches_counted_over": "one 16-step AViT rollout (4 model calls)",
        "launches_per_avit_train_step_forward":
            avit["train_drop_path_0.2"]["launches_per_step"]["packed_attention"],
        "launches_per_cvit_rollout": cvit["serving"]["launches_per_rollout"]["packed_attention"],
        "max_abs_err": max(c["max_abs_err"] for c in packed),
        "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_us") / 1e3,
        "bound_by": main[0]["bound_by"], "library_ms": mean("library_ms"),
        "library_call": main[0]["library_call"],
        "times_are": "CUDA events over 100 calls queued behind a spin of the card, L2-warm; "
                     "cold_ms: a 128 MB write before each call; *_call_ms: per call, back to "
                     "back at the host's pace",
        "cold_ms": mean("kernel_cold_ms"), "library_cold_ms": mean("library_cold_ms"),
        "bound_share_cold": mean("bound_us") / 1e3 / mean("kernel_cold_ms"),
        "copies_on_the_avit_path": avit["packed_attention_copies"],
        "call_ms": mean("kernel_call_ms"), "plain_call_ms": mean("plain_call_ms"),
        "library_call_ms": mean("library_call_ms"), "ok": all(c["ok"] for c in packed),
        "per_shape": [{k: c[k] for k in ("case", "form", "S", "P", "L", "D", "dtype", "causal",
                                          "kernel_ms", "kernel_cold_ms", "plain_ms",
                                          "library_ms", "library_cold_ms", "bound_us",
                                          "bound_by", "bound_share_cold", "max_abs_err")}
                      for c in packed],
    })
    # The tensor-parallel halves: the flagship's H, W and T shapes at tp = 2
    # (the parallel phase's split), one launch each per block and rank.
    main = [c for c in tp if c["tp"] == 2]
    per_call = parallel.get("forward", {}).get("launches_per_model_call_per_rank", {})
    for kind, name, kernel in (("attn", "attn_half_fwd", "_attn_half_kernel :696"),
                               ("mlp", "mlp_half_fwd", "_mlp_half_kernel :704")):
        mean = lambda k: sum(c[kind][k] for c in main) / len(main)  # noqa: E731,B023
        out.append({
            "name": name, "route": "cuda", "source": HALF_SOURCE,
            "replaces": f"tante_tpu/ops/pallas_block.py:730 ({kernel})",
            "launches": per_call.get(name, 0),
            "launches_counted_over": "one flagship model call on one rank of (dp 1, tp 2)",
            "max_abs_err": max(c[kind]["max_abs_err"] for c in tp),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_us") / 1e3, "bound_by": main[0][kind]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a half block
            "times_are": "device time (torch.profiler) of the kernel alone, shard 0, mean over "
                         "H, W, T at tp = 2; call_ms: the wrapper's whole device time",
            "call_ms": mean("call_ms"),
            # The same shards on the first design's body, in turns on this card.
            "first_design_ms": mean("first_design_ms"),
            "first_design_call_ms": mean("first_design_call_ms"),
            "first_design_source": FIRST_DESIGN_SOURCE,
            "achieved_tflops": mean("achieved_tflops"),
            "symbols": sorted({s for c in tp for s in c[kind]["symbols"]}),
            "ok": all(c["ok"] for c in tp),
            "per_shape": [{"tp": c["tp"], "case": c["case"], **{k: c[kind][k] for k in (
                "kernel_ms", "call_ms", "first_design_ms", "first_design_call_ms", "plain_ms",
                "bound_us", "bound_by", "achieved_tflops", "max_abs_err", "rel_l2",
                "plain_rms")}} for c in tp],
        })
    # The f32 halves (configs/tante.yaml / tante_adaptive.yaml as shipped
    # under a tp mesh): counted over the parallel phase's f32 forward, with
    # their launches per f32 Trainer and R_Trainer step beside.
    main = [c for c in tp_f32 if c["tp"] == 2]
    per_call = parallel.get("forward_f32", {}).get("launches_per_model_call_per_rank", {})
    r_runs = parallel.get("r_trainer_f32", {})
    for kind, name, kernel in (("attn", "attn_half_fwd", "_attn_half_kernel :696"),
                               ("mlp", "mlp_half_fwd", "_mlp_half_kernel :704")):
        mean = lambda k: sum(c[kind][k] for c in main) / len(main)  # noqa: E731,B023
        out.append({
            "name": f"{name} (f32)", "route": "cuda", "source": HALF_F32_SOURCE,
            "entry": F32_ENTRIES[name],
            "replaces": f"tante_tpu/ops/pallas_block.py:730 ({kernel}) (f32 activations)",
            "launches": per_call.get(name, 0),
            "launches_counted_over": "one f32 flagship model call on one rank of (dp 1, tp 2)",
            "launches_per_f32_train_step": parallel.get("trainer_f32", {}).get(
                "half_launches_per_step", {}).get(name),
            "launches_per_r_trainer_step": {r: run["steps"][0]["half_launches"][name]
                                            for r, run in r_runs.items()},
            "max_abs_err": max(c[kind]["max_abs_err"] for c in tp_f32),
            "rel_l2": max(c[kind]["rel_l2"] for c in tp_f32),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_us") / 1e3, "bound_by": main[0][kind]["bound_by"],
            "ffma_bound_ms": mean("ffma_bound_us") / 1e3,
            "library_ms": None,  # no single PyTorch call computes a half block
            "times_are": "device time (torch.profiler) of the kernel alone, shard 0, mean over "
                         "H, W, T at tp = 2; call_ms: the wrapper's whole device time",
            "call_ms": mean("call_ms"), "achieved_tflops": mean("achieved_tflops"),
            "ok": all(c["ok"] for c in tp_f32),
            "per_shape": [{"tp": c["tp"], "case": c["case"], **{k: c[kind][k] for k in (
                "kernel_ms", "call_ms", "plain_ms", "bound_us", "ffma_bound_us", "bound_by",
                "achieved_tflops", "max_abs_err", "rel_l2", "plain_rms")}} for c in tp_f32],
        })
    out.extend(long_rows(kernels_long, long_axes))
    out.extend(half_long_rows(tp_long, parallel))
    check(all(k["launches"] > 0 for k in out), "a kernel of the main paths was never launched")
    emit({"kernels": out})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    kernels = phase_kernels(dev)
    chains = phase_chain_kernels(dev)
    phase_grad(dev)
    kernels_f32 = phase_kernels_f32(dev)
    chains_f32 = phase_chain_kernels_f32(dev)
    phase_grad(dev, torch.float32)
    kernels_long = {"bf16": phase_kernels_long(dev, torch.bfloat16),
                    "f32": phase_kernels_long(dev, torch.float32)}
    fixed = phase_fixed(dev)
    adaptive = phase_adaptive(dev)
    fixed_f32 = phase_fixed_f32(dev, fixed, adaptive)
    long_axes = phase_long_axes(dev)
    spectral = phase_spectral_kernel(dev)
    fno = phase_fno_serving(dev)
    packed = phase_packed_kernel(dev)
    phase_packed_grad(dev)
    tp = phase_tp_kernel(dev)
    tp_f32 = phase_tp_kernel_f32(dev)
    tp_long = {"bf16": phase_tp_kernel_long(dev, torch.bfloat16),
               "f32": phase_tp_kernel_long(dev, torch.float32)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        overlap = phase_overlap(dev, Path(workdir))
        train = phase_train(dev, Path(workdir))
        adaptive_train = phase_adaptive_train(dev, Path(workdir))
        cli = phase_cli(dev, Path(workdir))
        phase_wellpack(dev, Path(workdir))
        phase_fno_train_eval(dev, Path(workdir))
        avit = phase_avit(dev, Path(workdir))
        cvit = phase_cvit(dev, Path(workdir))
        phase_zoo(dev, Path(workdir))
        parallel = phase_parallel(dev, Path(workdir))
    phase_summary(kernels, chains, kernels_f32, chains_f32, fixed, fixed_f32, train,
                  adaptive_train, cli, spectral, fno, packed, avit, cvit, tp, tp_f32, parallel,
                  kernels_long, long_axes, tp_long, overlap)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)  # name, power limit: as nvidia-smi prints them
    if FAILURES:
        emit({"failures": FAILURES, "seconds": time.perf_counter() - t0})
        return 1
    emit({"seconds": time.perf_counter() - t0, "notes": NOTES})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
