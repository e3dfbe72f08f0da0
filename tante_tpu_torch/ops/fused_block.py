"""Fused axial transformer block (counterpart of ``tante_tpu/ops/pallas_block.py``).

Five entry points carry every attention block of the TANTE paths:

- ``fused_block_apply(x, p, l, heads, causal)``: the whole pre-LN block on
  ``(S, L, C)`` rows (the H and W blocks, and the T block outside the
  canonical gate).  CUDA kernel ``fused_block_fwd`` (``csrc/fused_block_sm90.cu``
  on the Hopper tile body of ``csrc/block_sm90.cuh``: wgmma, a producer warp
  streaming the weights with ``cp.async.bulk``)
  replaces the Pallas kernel reached by ``fused_block_apply``
  (``pallas_block.py:208``).  Its weights are re-laid once per weight
  version (``sm90_weights``).
- ``fused_block_long(x, p, l, heads, causal)``: the same block at any L
  (``fused_block_apply`` sends L > 64 here: the L, X, A and channel C axes),
  as two CUDA kernels (``csrc/fused_block_long_sm90.cu``): ``long_qkv_fwd``
  (LN1 and q|k|v of token tiles into a workspace laid out head group by
  head group) and ``long_attn_fwd`` (a persistent grid over work items of
  one sequence's 128 (bf16) or 64 query rows: the keys streamed in blocks
  of 64 by a producer warp, then the out-projection, LN2 and MLP of the
  single-block body on the item's rows).  Replaces the Pallas kernel reached by
  ``fused_block_apply`` (``pallas_block.py:208``) at L > 64, where JAX's
  tile holds one whole sequence.
- ``fused_block_canon_t(x5, p, heads)``: the causal T block straight on the
  canonical ``(B, T, H, W, C)`` tensor with no transpose on either side.
  CUDA kernel ``fused_block_canon_t_fwd`` (the same Hopper tile body under
  the T axis's strided row map) replaces ``fused_block_canon_t``
  (``pallas_block.py:368``).

- ``fused_chain_apply(x3, params_seq, axes, heads, dims)``: a run of T/H/W
  blocks in ONE launch, input in the first axis's token order, output in
  the last's; ``fused_group_apply(x5, params_seq, axes, heads)``: the same
  on the canonical tensor, in and out.  CUDA kernel ``fused_chain_fwd``
  (``csrc/fused_chain_sm90.cu``: the Hopper tile body, cooperative and
  persistent, the tiles of all blocks in one schedule, each waiting only for
  the previous block's tiles of its batch elements, one weight ring
  streaming every block's slabs) replaces the Pallas kernel reached by
  ``fused_chain_apply`` / ``fused_group_apply`` (``pallas_block.py:1073`` /
  ``:989``, one body ``_group_kernel``).

- ``fused_block_apply_tp(x, p, l, heads, causal, mesh)``: the block on one
  tensor-parallel rank's weight shards, as two halves with an all-reduce
  after each.  CUDA kernels ``attn_half_fwd`` and ``mlp_half_fwd`` (wrappers
  ``attn_half_apply`` / ``mlp_half_apply``; ``csrc/fused_half_sm90.cu``, the
  same Hopper tile body on a shard zero-padded to whole 64-column groups,
  a persistent grid; the f32 entries ``*_sm90_f32_fwd`` in
  ``csrc/fused_half_sm90_f32.cu`` on the f32 tile body) replace the Pallas
  kernels reached by
  ``fused_block_apply_tp`` (``pallas_block.py:890``, through
  ``_pallas_rowtile``: ``_attn_half_kernel`` / ``_mlp_half_kernel``).  Their
  weights are re-laid once per weight version (``half_weights``), cached
  under the parameters they came from: through the ``copy_to_tp`` views the
  LayerNorm parameters arrive as, and through the compute-dtype copies of
  f32 parameters (``cast_weight``) made on every call.  At L > 64
  ``attn_half_apply`` sends the attention half to ``attn_half_long``: two
  CUDA kernels (``csrc/fused_half_long_sm90.cu``, the long entry's split on
  the halves' padded shard), ``half_long_qkv_fwd`` (LN1 and the shard's
  q|k|v into a workspace) and ``half_long_attn_fwd`` (the long entry's
  attention on a persistent grid of work items over the shard's head
  groups, then the out-projection partial), replacing
  the same Pallas kernel at the lengths where JAX's tile holds one whole
  sequence.

``csrc/fused_block.cu`` holds the first design's tile body (``block_tile``,
wmma), which no model path takes: ``block_tile_canon_t``,
``block_tile_chain``, ``block_tile_attn_half`` and ``block_tile_mlp_half``
launch its entries as the baseline the measurement scripts and GPU tests
time against.  Every source is built on first use by ``_build.py``.  Each
wrapper takes its plain PyTorch version (``block_ref``, ``canon_t_ref``,
``chain_ref``, ``group_ref``, ``attn_half_ref``, ``mlp_half_ref``: the JAX
package's ``_xla_block`` / ``_canon_t_ref`` / ``_chain_ref`` /
``_xla_group`` / ``_xla_attn_half`` / ``_xla_mlp_half``) only for a tensor on
the CPU; a CUDA tensor launches the kernel or raises.  Each wrapper counts
its forward launches in its ``launches`` attribute, a ``collections.Counter``
keyed by the activation dtype.

Gradients: as in the JAX package (``jax.vjp`` of the plain version in every
custom VJP there), no kernel has a backward kernel.  On a CUDA tensor that
needs a gradient the launch is wrapped in one ``torch.autograd.Function``
that saves ``x`` and the parameters and, in backward, recomputes the plain
version under ``torch.enable_grad()`` and pulls the cotangent through it.

Kernel numerics are the Pallas kernel's: ``d**-0.5 * log2(e)`` folded into
``wq``/``bq``, the "fast" softmax ``exp2(min(s, 60*log2(e)))`` with no
max-subtract by default, or under ``set_block_tuning(softmax="safe")`` the
masked f32 softmax with max-subtract ``exp2(s - max)`` (every kernel but the
canonical T block, whose gate then closes, as in the JAX package);
normalisation after the AV product with a ``+1e-30`` guard.  The activation
dtype picks the instantiation, as each Pallas call takes its output dtype
from its input: bf16 activations and weights with f32 LayerNorm, softmax,
GELU and accumulators (q/k/v, attention weights and output, fc1 output and
the residual sums rounded to bf16); or f32 throughout, nothing rounded to
bf16 (the ``*_f32_fwd`` entries on the f32 tile body: each product three
TF32 tensor-core products (3xTF32), 64-row tiles, C <= 256, accurate tanh;
the tp halves' partials in f32 too).  x and
every parameter share one dtype, bf16 or f32.  The Hopper kernels round at the same points under every row
map, so the canonical T kernel equals ``fused_block_apply`` on the
rearranged tensor, and a chain the single-block kernels in sequence, bit
for bit.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from tante_tpu_torch.ops.activations import gelu_tanh_f32

LOG2E = 1.4426950408889634
# Largest sequence the CUDA kernel holds in one tile (whole sequences per
# CTA, scores never leave registers).  The serving path has L = 4, 16, 48.
KERNEL_MAX_L = 64
# C and the MLP width are matmul depths (multiples of 64) and LayerNorm
# widths the kernel holds in registers.
KERNEL_MAX_C = 512
KERNEL_HEAD_DIMS = (16, 32, 64)

# The softmax of the block kernels (``pallas_block.py:_TUNE``): "fast" (the
# default) or "safe".  JAX's ``row_tile`` knob tiles for the TPU and has no
# counterpart here.
_TUNE = {"softmax": "fast"}


def set_block_tuning(softmax: str | None = None):
    """Choose the block kernels' softmax (``pallas_block.py:set_block_tuning``):
    "fast" = exp2 of scores clamped at 60*log2(e), no max-subtract; "safe" =
    masked f32 softmax with max-subtract.  Takes effect on the next call."""
    if softmax is not None:
        if softmax not in ("safe", "fast"):
            raise ValueError(f"softmax must be 'safe' or 'fast', got {softmax!r}")
        _TUNE["softmax"] = softmax


def _safe() -> int:
    return int(_TUNE["softmax"] == "safe")


class BlockParams(NamedTuple):
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def ln(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with one-pass moments (E[x^2] - mu^2), computed in f32 and
    returned in ``x.dtype`` (``pallas_block.py:_ln``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# The largest f32 score tensor the plain block makes at once, in bytes: its
# attention runs over chunks of sequences (the C axis at the flagship would
# otherwise hold 24,576 x 8 heads x 256^2 f32 scores, 51.5 GB).
REF_SCORE_BYTES = 1 << 30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  dt: torch.dtype) -> torch.Tensor:
    """softmax(q k^T) v in plain PyTorch on (S, L, heads, d) (q scaled
    already): f32 logits, masked (causal) with -1e30, the softmax's weights
    rounded to ``dt``.  The sequences are independent, so they go in chunks
    whose f32 scores stay within ``REF_SCORE_BYTES``; the projections
    around it stay whole.  Returns (S, L, heads * d)."""
    s, l, heads, d = q.shape
    per = max(1, REF_SCORE_BYTES // (heads * l * l * 4))
    m = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device)) if causal else None
    outs = []
    for i in range(0, max(s, 1), per):  # one (empty) chunk when there are no sequences
        logits = torch.einsum("blhd,bmhd->bhlm", q[i:i + per], k[i:i + per]).float()
        if causal:
            logits = torch.where(m, logits, torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1).to(dt)
        outs.append(torch.einsum("bhlm,bmhd->blhd", w, v[i:i + per]))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(s, l, heads * d)


def block_ref(x: torch.Tensor, p: BlockParams, l: int, heads: int, causal: bool):
    """Plain PyTorch block: the JAX package's ``_xla_block`` op for op
    (max-subtract softmax, dtype following ``x``), its attention over chunks
    of sequences (``attention_ref``)."""
    dt = x.dtype
    c = x.shape[-1]
    d = c // heads
    xn = ln(x, p.ln1_scale, p.ln1_bias)
    q = ((xn @ p.wq.to(dt)) + p.bq.to(dt)) * (d**-0.5)
    k = (xn @ p.wk.to(dt)) + p.bk.to(dt)
    v = (xn @ p.wv.to(dt)) + p.bv.to(dt)
    q, k, v = (t.reshape(-1, l, heads, d) for t in (q, k, v))
    attn = attention_ref(q, k, v, causal, dt).reshape(x.shape)
    x = x + (attn @ p.wo.to(dt)) + p.bo.to(dt)
    yn = ln(x, p.ln2_scale, p.ln2_bias)
    h1 = ((yn @ p.w1.to(dt)) + p.b1.to(dt)).float()
    h1 = gelu_tanh_f32(h1).to(dt)
    return x + (h1 @ p.w2.to(dt)) + p.b2.to(dt)


def canon_t_ref(x5: torch.Tensor, p: BlockParams, heads: int) -> torch.Tensor:
    """Plain causal T block on canonical (B, T, H, W, C): transpose, block,
    transpose back (``pallas_block.py:_canon_t_ref``)."""
    b, t, h, w, c = x5.shape
    y = x5.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    y = block_ref(y, p, t, heads, True)
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


def canon_t_supported(t: int, h: int, w: int, c: int, heads: int, hidden: int | None = None,
                      dtype: torch.dtype | None = None) -> bool:
    """Geometry gate for the canonical T-block kernel (``pallas_block.py:349``):
    the "fast" softmax (the kernel has no "safe" form: under "safe" the T
    block takes the rearranged ``fused_block_apply``), 2 <= T <= 8,
    C % 128 == 0, heads divides C; in f32 also a tile plan for the MLP width
    ``hidden`` (default C).  The TPU gate's VMEM estimate has no
    counterpart: the CUDA kernel tiles pixels, so no whole batch element has
    to fit on chip."""
    if _TUNE["softmax"] != "fast":
        return False
    if dtype == torch.float32 and sm90_plan(t, c, c if hidden is None else hidden, dtype) is None:
        return False
    return 2 <= t <= 8 and c % heads == 0 and c % 128 == 0


# --------------------------------------------------------------------------
# CUDA launch
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _param_shapes(c: int, hidden: int) -> tuple:
    return ((c,), (c,), (c, c), (c,), (c, c), (c,), (c, c), (c,), (c, c), (c,), (c,), (c,),
            (c, hidden), (hidden,), (hidden, c), (c,))


# The activation dtypes the block kernels are instantiated for.
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_kernel_args(x: torch.Tensor, p: BlockParams, l: int, heads: int,
                       max_l: int | None = KERNEL_MAX_L):
    """What the kernel takes, checked before any pointer reaches it (one
    pass per tensor: the checks run on every launch): a CUDA tensor and
    ``_check_block_args``."""
    if x.device.type != "cuda":
        raise ValueError(f"fused block kernel needs a CUDA tensor, got {x.device}")
    _check_block_args(x, p, l, heads, max_l)


def _check_block_args(x: torch.Tensor, p: BlockParams, l: int, heads: int,
                      max_l: int | None = KERNEL_MAX_L):
    """The block kernels' envelope on any device: x and every parameter in
    one dtype, bf16 or f32, contiguous and aligned, of the block's shapes;
    sequences of 1..``max_l`` (any length for None: the long entry)."""
    if x.dtype not in KERNEL_DTYPES or not x.is_contiguous():
        raise ValueError(f"kernel input must be contiguous bf16 or f32, got {x.dtype}")
    c, hidden = x.shape[-1], p.w1.shape[-1]
    if c % 64 or c > KERNEL_MAX_C or hidden % 64 or hidden > 2 * c or heads <= 0 or c % heads:
        raise ValueError(
            f"kernel needs C % 64 == 0, C <= {KERNEL_MAX_C}, hidden % 64 == 0, hidden <= 2C "
            f"and heads | C; got C={c}, hidden={hidden}, heads={heads}"
        )
    if c // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head dim must be one of {KERNEL_HEAD_DIMS}, got {c // heads}")
    if l < 1 or (max_l is not None and l > max_l):
        raise ValueError(f"kernel holds sequences of 1..{max_l}, got L={l}")
    _check_params(x, p, _param_shapes(c, hidden), x.dtype)


def _check_params(x: torch.Tensor, p: tuple, shapes: tuple, dtype=torch.bfloat16):
    """Each parameter of ``p`` (a NamedTuple) contiguous, 32-byte aligned,
    of ``dtype``, of its shape in ``shapes``, on ``x``'s device; ``x``
    aligned."""
    dev = x.device
    for name, t, want in zip(p._fields, p, shapes):
        if (t.shape != want or t.dtype != dtype or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 32):
            raise ValueError(
                f"{name}: want contiguous 32-byte-aligned {dtype} {want} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if x.data_ptr() % 32:
        raise ValueError("kernel input must be 32-byte aligned")


def _prescaled(p: BlockParams, heads: int) -> BlockParams:
    """Fold d**-0.5 * log2(e) into wq/bq once per launch
    (``pallas_block.py:147-151``)."""
    qs = (p.wq.shape[0] // heads) ** -0.5 * LOG2E
    # bf16 * scalar multiplies in f32 and rounds once: (w.f32 * qs).bf16.
    return p._replace(wq=p.wq * qs, bq=p.bq * qs)


def _ptr_array(params_seq: Sequence[BlockParams]):
    ptrs = [t.data_ptr() for p in params_seq for t in p]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


class _RecomputeGrad(torch.autograd.Function):
    """``launch(x, pack(flat))`` forward; backward = the cotangent pulled
    through ``plain(x, pack(flat))`` recomputed with autograd on.  The
    parameters arrive flat so autograd sees each tensor; ``pack`` regroups
    them (16 per block, or one tensor-parallel half's)."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, pack: Callable, x: torch.Tensor, *flat):
        ctx.plain, ctx.pack = plain, pack
        ctx.save_for_backward(x, *flat)
        return launch(x, pack(flat))

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip((x, *flat), need)]
            y = ctx.plain(leaves[0], ctx.pack(leaves[1:]))
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype)))
        return (None, None, None, *(next(grads) if n else None for n in need))


def _blocks(flat: Sequence[torch.Tensor]) -> tuple:
    return tuple(BlockParams(*flat[i : i + 16]) for i in range(0, len(flat), 16))


def _run(launch: Callable, plain: Callable, x: torch.Tensor, params_seq: Sequence[tuple],
         pack: Callable = _blocks):
    """Launch the kernel, through ``_RecomputeGrad`` when a gradient can flow."""
    flat = [t for p in params_seq for t in p]
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in flat)):
        return _RecomputeGrad.apply(launch, plain, pack, x, *flat)
    return launch(x, params_seq)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# --------------------------------------------------------------------------
# The single-block kernel for Hopper (csrc/fused_block_sm90.cu)
# --------------------------------------------------------------------------

SM90_SLAB_K = 32        # K rows of one weight slab
SM90_QKV_N = 192        # q|k|v columns of one head group (64 columns each)
SM90_QKV_LD = SM90_QKV_N + 8
SM90_MAX_STAGES = 4
# Dynamic shared memory a CTA may opt into on an H100 (the kernel checks the
# device's own figure and refuses a plan that does not fit).
SMEM_OPTIN = 232448
# The f32 tile body (``block_sm90.cuh``: kRowsF, kSlabKF, kQkvLdF, kMaxCF):
# 64-row tiles, 16-row slabs, a q|k|v tile of 196 floats a row, C <= 256.
SM90_F32_ROWS = 64
SM90_F32_SLAB_K = 16
SM90_F32_QKV_LD = SM90_QKV_N + 4
SM90_F32_MAX_C = 256


class Sm90Plan(NamedTuple):
    rows: int      # R: rows of a tile (64 or 128), whole sequences
    seqs: int      # sequences per tile
    np: tuple      # column pass widths of the qkv, out-projection, fc1, fc2 matmuls
    stages: int    # weight slabs in the ring

    def ints(self) -> list:
        return [self.rows, self.seqs, *self.np, self.stages]


def _pass_width(n: int) -> int:
    """Columns a matmul pass takes: all of N up to 192 (a warpgroup holds at
    most three 64-column f32 accumulators), else 128 or 64, whichever divides
    N.  Narrow passes keep the slabs small, so more of them are in flight."""
    return n if n <= 192 else 128 if n % 128 == 0 else 64


def _pass_width_f32(n: int) -> int:
    """The f32 body's pass width past the q|k|v one: 128 where it divides N,
    else 64 (``block_sm90.cuh:gemm_f32_np``)."""
    return 128 if n % 128 == 0 else 64


def sm90_smem(rows: int, c: int, hidden: int, np: tuple, stages: int,
              dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory bytes of a plan (``block_sm90.cuh:layout`` /
    ``layout_f32``): the LN1 output and the q|k|v tile (later the MLP
    hidden), the attention output (later the LN2 output), the slab ring and
    its barriers.  f32 tiles are row-major with 4 floats of padding a row."""
    if dtype == torch.float32:
        xn, qkv = rows * (c + 4) * 4, rows * SM90_F32_QKV_LD * 4
        a = max(rows * (hidden + 4) * 4, xn + qkv)
        return (a + rows * (c + 4) * 4 + stages * SM90_F32_SLAB_K * max(np) * 4
                + 2 * SM90_MAX_STAGES * 8)
    xn, qkv = rows * c * 2, rows * SM90_QKV_LD * 2
    a = max(rows * hidden * 2, xn + qkv)
    return a + rows * c * 2 + stages * SM90_SLAB_K * max(np) * 2 + 2 * SM90_MAX_STAGES * 8


@functools.lru_cache(maxsize=64)
def sm90_plan(l: int, c: int, hidden: int, dtype: torch.dtype = torch.bfloat16) -> Sm90Plan | None:
    """The tile plan for sequences of length ``l`` in ``dtype``: bf16,
    128-row tiles (two warpgroups of 64 rows) when they fit the shared
    memory with at least two slabs in flight, else 64 rows; f32, 64-row
    tiles and C <= 256; as many slabs as fit, up to four.  None outside the
    kernel's envelope."""
    if not (1 <= l <= KERNEL_MAX_L and c % 64 == 0 and 0 < c <= KERNEL_MAX_C
            and hidden % 64 == 0 and 0 < hidden <= 2 * c):
        return None
    if dtype == torch.float32:
        if c > SM90_F32_MAX_C:
            return None
        # The f32 body's passes past the q|k|v one are 64 or 128 wide.
        np = (SM90_QKV_N, *(_pass_width_f32(n) for n in (c, hidden, c)))
        rows = SM90_F32_ROWS
        for stages in range(SM90_MAX_STAGES, 1, -1):
            if sm90_smem(rows, c, hidden, np, stages, dtype) <= SMEM_OPTIN:
                return Sm90Plan(rows, rows // l, np, stages)
        return None
    np = (SM90_QKV_N, _pass_width(c), _pass_width(hidden), _pass_width(c))
    for rows in (128, 64):
        if rows < l or (rows == 128 and c > 256):  # a 128-row LayerNorm holds C <= 256
            continue
        for stages in range(SM90_MAX_STAGES, 1, -1):
            if sm90_smem(rows, c, hidden, np, stages) <= SMEM_OPTIN:
                return Sm90Plan(rows, rows // l, np, stages)
    return None


def arrange_weight(w: torch.Tensor, np: int) -> torch.Tensor:
    """(K, N) -> the slabs the kernel streams, flat: pass after pass of ``np``
    columns, in each pass K / 32 slabs, each slab in wgmma's K-major core-
    matrix layout (8 output columns x 8 K rows per 128-byte core matrix, core
    (n/8, k/8) at ((n/8) * 4 + k/8) * 64 elements)."""
    k, n = w.shape
    t = w.reshape(k // SM90_SLAB_K, SM90_SLAB_K // 8, 8, n // np, np // 8, 8)
    return t.permute(3, 0, 4, 1, 5, 2).reshape(-1)


def arrange_weight_f32(w: torch.Tensor, np: int) -> torch.Tensor:
    """(K, N) f32 -> the f32 body's slabs, flat: pass after pass of ``np``
    columns, in each pass K / 16 slabs of 16 rows x ``np`` columns in the
    order of mma.sync's B fragments (``block_sm90.cuh:gemm_f32``): per
    8-column tile j of the slab 128 floats, lane 4g + t's four at 4(4g + t):
    rows t, t + 4, 8 + t, 12 + t of column 8j + g (the b0, b1 of the slab's
    two k8 steps), one 16-byte load a lane."""
    k, n = w.shape
    t = w.reshape(k // SM90_F32_SLAB_K, 4, 4, n // np, np // 8, 8)  # kc, e, t, pass, j, g
    return t.permute(3, 0, 4, 5, 2, 1).reshape(-1)


class Sm90Weights(NamedTuple):
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    bqkv: torch.Tensor   # (C/64 * 192,): each head group's bq (prescaled) | bk | bv
    bo: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    slabs: torch.Tensor  # every weight slab of a tile's schedule, in order


def qkv_groups(p, heads: int) -> tuple[list, torch.Tensor]:
    """Per head group (64 columns: 64/d heads), the (C, 192) weight
    [wq | wk | wv] with d**-0.5*log2(e) folded into wq, and all groups'
    [bq | bk | bv] biases in one vector (``pallas_block.py:147-151``).
    ``p`` holds wq/bq/wk/bk/wv/bv (a block's, or a tp shard's with
    ``heads`` local heads); a shard narrower than a whole number of groups
    is padded with zero columns (a zero head, whose output is 0)."""
    ca = p.wq.shape[-1]
    qs = (ca // heads) ** -0.5 * LOG2E
    pad = -ca % 64
    # bf16 * scalar multiplies in f32 and rounds once: (w.f32 * qs).bf16.
    wq, bq, wk, bk, wv, bv = (F.pad(t, (0, pad)) for t in (p.wq * qs, p.bq * qs, p.wk, p.bk,
                                                             p.wv, p.bv))
    cols = [slice(g, g + 64) for g in range(0, ca + pad, 64)]
    ws = [torch.cat([wq[:, s], wk[:, s], wv[:, s]], dim=1) for s in cols]
    bs = torch.cat([torch.cat([bq[s], bk[s], bv[s]]) for s in cols])
    return ws, bs


def _arrange(p: BlockParams, heads: int, plan: Sm90Plan) -> Sm90Weights:
    ws, bqkv = qkv_groups(p, heads)
    np_qkv, np_o, np_1, np_2 = plan.np
    arrange = arrange_weight_f32 if p.wq.dtype == torch.float32 else arrange_weight
    slabs = torch.cat([*(arrange(w, np_qkv) for w in ws), arrange(p.wo, np_o),
                       arrange(p.w1, np_1), arrange(p.w2, np_2)])
    return Sm90Weights(p.ln1_scale, p.ln1_bias, bqkv, p.bo, p.ln2_scale, p.ln2_bias, p.b1,
                       p.b2, slabs)


def cast_weight(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` (an autograd cast where the dtype differs), marked
    as made from ``t``: the kernels' weights re-laid from the copy, which is
    made anew on every call, are cached under ``t`` and its version."""
    if t.dtype == dtype:
        return t
    out = t.to(dtype)
    out._cast_of = t
    return out


def _origin(t: torch.Tensor) -> torch.Tensor:
    """The tensor whose storage and version decide ``t``'s values: the base
    of a view (``copy_to_tp`` hands the tp halves a new view of each
    LayerNorm parameter on every call, ``x.view_as(x)``), the source of a
    ``cast_weight`` copy (the compute-dtype weights of f32 parameters)."""
    while True:
        if t._base is not None:
            t = t._base
        elif hasattr(t, "_cast_of"):
            t = t._cast_of
        else:
            return t


def _version(t: torch.Tensor):
    """The version counter (a view shares its base's), bumped by every
    in-place update; None for an inference tensor, which keeps none."""
    try:
        return t._version
    except RuntimeError:
        return None


# Re-laid weights by the identity of the tensors they came from (through
# views and casts), each one's storage address and layout, and the kernel
# plan; valid while every origin keeps its version.  Serving re-lays each
# block (or half) once, and so does a Trainer once per optimizer step: a
# weight updated in place bumps its version, and one given new storage
# (``.data`` swaps, as ``Module.to`` makes) or a new tensor changes the key.
_SM90_CACHE: collections.OrderedDict = collections.OrderedDict()
SM90_CACHE_SIZE = 64


def relaid_weights(p: tuple, extra: tuple, make: Callable):
    """``make()`` (under ``no_grad``) for the tensors ``p`` and the plan
    ``extra``, once per weight version; ``relaid_weights.count`` counts the
    re-layouts made."""
    roots = tuple(_origin(t) for t in p)
    key = (extra, tuple((id(r), r.data_ptr(), tuple(r.shape), r.stride(), t.dtype,
                         tuple(t.shape), t.stride(), t.storage_offset())
                        for r, t in zip(roots, p)))
    versions = tuple(_version(r) for r in roots)
    hit = _SM90_CACHE.get(key)
    if hit is not None:
        refs, seen, w = hit
        if all(ref() is r for ref, r in zip(refs, roots)) and seen == versions:
            _SM90_CACHE.move_to_end(key)
            return w
    with torch.no_grad():
        w = make()
    relaid_weights.count += 1
    _SM90_CACHE[key] = (tuple(weakref.ref(r) for r in roots), versions, w)
    _SM90_CACHE.move_to_end(key)
    while len(_SM90_CACHE) > SM90_CACHE_SIZE:
        _SM90_CACHE.popitem(last=False)
    return w


relaid_weights.count = 0


def sm90_weights(p: BlockParams, heads: int, plan: Sm90Plan) -> Sm90Weights:
    """The kernel's weights for ``p``, re-laid once per weight version."""
    return relaid_weights(p, ("block", heads, plan), lambda: _arrange(p, heads, plan))


def _f32(x: torch.Tensor) -> bool:
    return x.dtype == torch.float32


def _plan_for(l: int, c: int, hidden: int, dtype: torch.dtype) -> Sm90Plan:
    plan = sm90_plan(l, c, hidden, dtype)
    if plan is None:
        raise ValueError(f"no tile plan for L={l}, C={c}, hidden={hidden} in {dtype}")
    return plan


def _count(fn: Callable, x: torch.Tensor):
    """One launch of ``fn``'s kernel, counted under ``x``'s dtype."""
    fn.launches[x.dtype] += 1


def fused_block_apply(
    x: torch.Tensor, p: BlockParams, l: int, heads: int, causal: bool
) -> torch.Tensor:
    """(S, L, C) -> (S, L, C) full pre-LN transformer block: the
    single-block kernel for L <= ``KERNEL_MAX_L``, the long entry
    (``fused_block_long``) past it."""
    if x.device.type == "cpu":
        return block_ref(x, p, l, heads, causal)
    if x.shape[-2] != l:
        raise ValueError(f"x of shape {tuple(x.shape)} does not hold sequences of L={l}")
    if l > KERNEL_MAX_L:
        return fused_block_long(x, p, l, heads, causal)

    def launch(x, ps):
        from tante_tpu_torch.ops import _build

        (p,) = ps
        s, _, c = x.shape
        _check_kernel_args(x, p, l, heads)
        hidden = p.w1.shape[-1]
        plan = _plan_for(l, c, hidden, x.dtype)
        out = torch.empty_like(x)
        w = sm90_weights(p, heads, plan)
        lib = _build.load("fused_block_sm90")
        entry = lib.tante_fused_block_sm90_f32_fwd if _f32(x) else lib.tante_fused_block_sm90_fwd
        rc = entry(
            x.data_ptr(), out.data_ptr(), _ptr_array([w]), (ctypes.c_int * 7)(*plan.ints()), s,
            l, c, hidden, heads, int(bool(causal)), _safe(), x.device.index, _stream(x),
        )
        _raise_on(rc, "fused_block_fwd")
        _count(fused_block_apply, x)
        return out

    return _run(launch, lambda x, ps: block_ref(x, ps[0], l, heads, causal), x, (p,))


fused_block_apply.launches = collections.Counter()


# --------------------------------------------------------------------------
# The block at any sequence length (csrc/fused_block_long_sm90.cu): a qkv
# entry over token tiles into a workspace, then an attention entry on a
# persistent grid whose work items are (sequence, R query rows): the keys
# streamed through a ring, then the block's tail on the item's rows
# --------------------------------------------------------------------------

LONG_Q_ROWS = 64     # query rows of an f32 item (and of a bf16 pair item)
LONG_KEY_BLOCK = 64  # keys of a streamed k|v block
LONG_MAX_KV = 4      # k|v stages of an attention kernel's ring
LONG_MAX_Q = 2       # q slots of an attention kernel
# A bf16 pair item's exchange area in the tail's tile h (long_sm90.cuh:
# kPairScratch): 40 floats for each thread of the second warpgroup, 8 for every
# consumer thread.
LONG_PAIR_SCRATCH = 128 * 40 * 4 + 256 * 8 * 4
# Barriers of an attention kernel: the weight ring's, the k|v ring's, the q
# slots' (full and empty each) and the item's end.
_LONG_ATTN_BARS = 2 * SM90_MAX_STAGES + 2 * LONG_MAX_KV + 2 * LONG_MAX_Q + 1
# Row strides (floats) of an f32 q slot and k|v stage.
_LONG_Q_LD_F32, _LONG_KV_LD_F32 = 64 + 4, 128 + 4


class LongPlan(NamedTuple):
    rows: int        # token rows of a qkv-entry tile (sequences ignored)
    qkv_stages: int  # weight slabs in the qkv entry's ring; 0: its weights resident
    np: tuple        # column pass widths of the qkv, out-projection, fc1, fc2 matmuls
    stages: int      # weight slabs in the attention entry's ring
    items: int = 64  # query rows of an attention work item (R)
    kv_stages: int = 2  # k|v blocks in the attention entry's ring
    q_slots: int = 1    # q tiles in flight
    overlap: int = 0    # 1: the tail's tiles overlap the q slots and the ring
    keep: int = 0       # 1 (bf16, one out-projection pass): x' stays in shared memory
    qkv_parts: int = 3  # the qkv entry's staging buffers (R x 64 each)
    qkv_split: int = 0  # 1 (f32): LN1's output stored split in TF32 hi / lo tiles

    @property
    def qkv_resident(self) -> bool:
        """The qkv entry holds every group's q|k|v slabs in shared memory."""
        return self.qkv_stages == 0

    def ints(self) -> list:
        return [self.rows, self.qkv_stages, *self.np, self.stages, self.items, self.kv_stages,
                self.q_slots, self.overlap, self.keep, self.qkv_parts, self.qkv_split]


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _act_tile(rows: int, width: int, dtype: torch.dtype) -> int:
    """Bytes of an activation tile: bf16 core matrices, or f32 row-major with
    4 floats of padding a row."""
    return rows * (width + 4) * 4 if dtype == torch.float32 else rows * width * 2


# The qkv kernels of the long pairs (``long_sm90.cuh``): a q|k|v weight slab
# (bf16 32 x 192, f32 16 x 192) in bytes, the most staging buffers and ring
# stages, the barriers (the ring's, the x slot's full and empty, the
# resident weights', the staging buffers' full and empty).
LONG_QKV_SLAB = SM90_SLAB_K * SM90_QKV_N * 2
LONG_QKV_MAX_PARTS = 6
LONG_QKV_MAX_STAGES = 8
_LONG_QKV_BARS = 2 * LONG_QKV_MAX_STAGES + 3 + 2 * LONG_QKV_MAX_PARTS


def _long_qkv_smem(rows: int, stages: int, parts: int, c: int, width: int,
                   dtype: torch.dtype, split: int = 0) -> int:
    """Shared memory bytes of a qkv kernel of the long pairs, the block's and
    the half's alike (``long_sm90.cuh:layout_qkv``), attention width
    ``width``: the x slot (rows x C), the LN1 tile (``split``: its TF32 hi and
    lo tiles), ``parts`` staging buffers (rows x 64 each), the resident q|k|v
    slabs of all width/64 groups (``stages`` 0) or a ring of ``stages``
    slabs, each region on 128 bytes; the barriers."""
    e = 4 if dtype == torch.float32 else 2
    at_a = _align128(rows * c * e)
    at_st = _align128(at_a + (2 if split else 1) * _act_tile(rows, c, dtype))
    at_w = _align128(at_st + parts * rows * 64 * e)
    w = stages * LONG_QKV_SLAB if stages else (width // 64) * c * SM90_QKV_N * e
    return _align128(at_w + w) + _LONG_QKV_BARS * 8


def long_qkv_layout(c: int, width: int,
                    dtype: torch.dtype) -> tuple[int, int, int, int] | None:
    """A qkv kernel's (rows, ring stages, staging buffers, split) for the
    token width ``c`` and attention width ``width``: tiles of 128 rows in
    bf16 where the LayerNorm holds C (C <= 256), else 64 (f32: 64, as its
    products hold them; 128-row f32 tiles leave no room for the x slot, the
    padded LN1 tile and three staging buffers); then the first that fits
    ``SMEM_OPTIN`` of: the weights resident (stages 0), a ring of 8, 7, ...,
    2 slabs; in f32 at C <= 128 each first with LN1's output split in TF32
    hi / lo tiles (the products then split no A, at twice the tile's bytes)
    and then without, ring depth yielding to the split; with as many staging
    buffers (3 to ``LONG_QKV_MAX_PARTS``) as fit beside it.  None where none
    fits."""
    rows = 64 if dtype == torch.float32 or c > 256 else 128
    splits = (1, 0) if dtype == torch.float32 and c <= 128 else (0,)
    rings = range(LONG_QKV_MAX_STAGES, 1, -1)
    modes = [(0, sp) for sp in splits] + [(st, sp) for sp in splits for st in rings]
    for stages, split in modes:
        for parts in range(LONG_QKV_MAX_PARTS, 2, -1):
            if _long_qkv_smem(rows, stages, parts, c, width, dtype, split) <= SMEM_OPTIN:
                return rows, stages, parts, split
    return None


def long_qkv_runs(s: int, l: int, rows: int, width: int, dtype: torch.dtype) -> list[tuple]:
    """A qkv kernel's workspace stores on S sequences of L (``long_sm90.cuh:
    qkv_stores``), in the order one CTA issues them for its tiles: per
    ``rows``-row tile of the (S*L) tokens, head group and part (q, k, v),
    one bulk copy per run of the tile's rows inside one sequence: (tile,
    part, group, sequence, first position, rows, the copy's byte offset in
    the workspace (3, S, width/64, L, 64), its byte offset in the part's
    staging buffer, its bytes)."""
    e = 4 if dtype == torch.float32 else 2
    groups, tokens = width // 64, s * l
    part = s * groups * l * 64
    out = []
    for tile in range(-(-tokens // rows)):
        row0 = tile * rows
        valid = min(rows, tokens - row0)
        for gi in range(groups):
            for p in range(3):
                r = 0
                while r < valid:
                    seq, pos = divmod(row0 + r, l)
                    n = min(valid - r, l - pos)
                    dst = p * part + ((seq * groups + gi) * l + pos) * 64
                    out.append((tile, p, gi, seq, pos, n, dst * e, r * 64 * e, n * 64 * e))
                    r += n
    return out


def long_q_bytes(rows: int, dtype: torch.dtype) -> int:
    """A q slot of an attention kernel: bf16 core matrices (rows x 64),
    f32 row-major 64 x 68."""
    if dtype == torch.float32:
        return LONG_Q_ROWS * _LONG_Q_LD_F32 * 4
    return rows * 64 * 2


def long_kv_bytes(dtype: torch.dtype) -> int:
    """A k|v stage of an attention kernel: bf16 two 64 x 64 core-matrix
    tiles, f32 64 x 132 row-major (k in columns 0-63, v 64-127)."""
    if dtype == torch.float32:
        return LONG_KEY_BLOCK * _LONG_KV_LD_F32 * 4
    return LONG_KEY_BLOCK * 128 * 2


def long_smem(plan: LongPlan, c: int, hidden: int, dtype: torch.dtype) -> tuple[int, int]:
    """Shared memory bytes of the qkv and the attention entry under ``plan``
    (``long_sm90.cuh:layout_qkv``, ``fused_block_long_sm90.cu:layout_attn``).
    qkv: ``_long_qkv_smem`` at width C.  Attention: the item's attention output (later
    the LN2 output), the tail's tile h (bf16: the out-projection's staging
    tile, then the MLP hidden, at least a pair item's exchange area; f32:
    the hidden), with ``keep`` the out-projection's staging tile apart (x'
    until fc2), the q slots and the k|v ring (after those, or over h with
    ``overlap``), the weight ring; each region on 128 bytes; then the
    barriers."""
    f32 = dtype == torch.float32
    e = 4 if f32 else 2
    slab_k = SM90_F32_SLAB_K if f32 else SM90_SLAB_K
    r = plan.items
    qkv = _long_qkv_smem(plan.rows, plan.qkv_stages, plan.qkv_parts, c, c, dtype, plan.qkv_split)
    h = _act_tile(r, hidden, dtype)
    stage = _act_tile(r, c, dtype) if f32 else r * (plan.np[1] + 8) * 2  # x' with keep
    if not f32:
        h = max(h if plan.keep else max(h, stage), LONG_PAIR_SCRATCH)
    at_h = _align128(_act_tile(r, c, dtype))
    at_x = _align128(at_h + h)
    at_q = at_h if plan.overlap else _align128(at_x + (stage if plan.keep else 0))
    at_kv = _align128(at_q + plan.q_slots * long_q_bytes(r, dtype))
    end = at_kv + plan.kv_stages * long_kv_bytes(dtype)
    if plan.overlap:
        end = max(end, at_h + h)
    attn = (_align128(end) + plan.stages * slab_k * max(plan.np[1:]) * e
            + _LONG_ATTN_BARS * 8)
    return qkv, attn


# A 64-row pair item's time against a 128-row tile's (``long_sm90.cuh:
# kPairShare``): each warpgroup weighs half the key blocks, the tail runs on
# 64 rows.
LONG_PAIR_SHARE = 0.6


def long_big_tiles(plan: LongPlan | HalfLongPlan, tiles: int, sms: int,
                   dtype: torch.dtype) -> int:
    """The tiles a launch of an attention kernel (the block's entry or the
    half's) runs as one item each (``long_sm90.cuh:pair_items``): all of
    them, but in bf16 with 128-row tiles whose tail
    tiles stand apart from the ring, the tiles past the grid's last whole
    wave (one CTA per SM) run as two pair items each where that takes
    fewer waves' time (pair items at ``LONG_PAIR_SHARE`` of a tile)."""
    if dtype == torch.float32 or plan.items != 128 or plan.overlap:
        return tiles
    full, rest = divmod(tiles, sms)
    pair_waves = -(-2 * rest // sms)
    return full * sms if rest and LONG_PAIR_SHARE * pair_waves < 1 else tiles


def long_item_map(plan: LongPlan | HalfLongPlan, s: int, l: int,
                  big: int | None = None) -> list[tuple]:
    """An attention kernel's work items in walk order (``long_sm90.cuh:
    item_at``): (sequence, first query row, rows, valid rows).  Each sequence
    is cut into ``plan.items``-row tiles; the first ``big`` tiles (all by
    default) are one item each, every later tile two 64-row pair items (an
    empty second half of a ragged tile has valid <= 0 and is skipped)."""
    qtiles = -(-l // plan.items)
    tiles = s * qtiles
    big = tiles if big is None else big
    out = []
    for i in range(big + 2 * (tiles - big)):
        tile = i if i < big else big + (i - big) // 2
        seq, q0 = divmod(tile, qtiles)
        q0 *= plan.items
        rows = plan.items
        if i >= big:
            rows, q0 = 64, q0 + 64 * ((i - big) % 2)
        out.append((seq, q0, rows, min(rows, l - q0)))
    return out


def long_attn_reads(plan: LongPlan | HalfLongPlan, s: int, l: int, c: int, causal: bool,
                    safe: bool, dtype: torch.dtype, big: int | None = None) -> dict:
    """Workspace bytes an attention kernel reads on these inputs (``c`` its
    attention width: the block's C, the half's W): per item and head group
    the item's q rows, then each k|v block its queries admit (twice for
    "safe"); beside the workspace's unique 3*S*L*c values."""
    e = 4 if dtype == torch.float32 else 2
    groups = c // 64
    items = [it for it in long_item_map(plan, s, l, big) if it[3] > 0]
    reads = 0
    for _, q0, _, valid in items:
        keys = q0 + valid if causal else l
        # A block's rows past the sequence are zero-filled, not read.
        rows = sum(min(LONG_KEY_BLOCK, l - k0) for k0 in range(0, keys, LONG_KEY_BLOCK))
        reads += groups * (valid * 64 + (2 if safe else 1) * rows * 128) * e
    return {"items": len(items), "bytes_per_item": reads / len(items), "bytes_read": reads,
            "unique_bytes": 3 * s * l * c * e}


def long_attn_work(x: torch.Tensor, plan: LongPlan, hidden: int) -> dict:
    """The attention entry's work on the CUDA tensor x (S, L, C) under
    ``plan``, from its kernel library: R-row tiles, the big ones, items and
    grid (one CTA per SM)."""
    s, l, c = x.shape
    out = (ctypes.c_int * 4)()
    rc = _long_lib(x).tante_block_long_attn_items(_ints(plan), s, l, c, hidden, int(_f32(x)),
                                                  x.device.index, out)
    _raise_on(rc, "block_long_attn_items")
    return dict(zip(("tiles", "big", "items", "grid"), out))


@functools.lru_cache(maxsize=64)
def long_plan(c: int, hidden: int, heads: int,
              dtype: torch.dtype = torch.bfloat16) -> LongPlan | None:
    """The long entry's plan, the same at every sequence length L >= 1 (the
    attention entry streams the keys, so L sets only the items): the qkv
    entry's ``long_qkv_layout`` (tiles of 128 token rows in bf16 where
    C <= 256, else 64; the weights resident where they fit, else a ring of
    2-4 slabs; staging buffers), the single-block kernel's column passes;
    attention items of 128 query rows in bf16 where
    C <= 256 (two consumer warpgroups of 64), else 64 (f32: 64), and the
    first that fits of: the tail's tiles apart from the q slots and the k|v
    ring (so the next item's copies run under this item's tail), then
    overlapping them; x' kept in shared memory from the out-projection to
    fc2 (LN2 and fc2 read no residual from device memory; bf16 where one
    pass covers C, C <= 192: 3.7% quicker at the f32 C block with a k|v
    ring of 2 than with 3 and x' through y, on an H100); then the deepest of
    the k|v ring and the weight ring (2-4 stages each: the shallower of the
    two first), the deeper k|v ring, weight ring, and two q slots before one
    (bf16: wgmma reads the q tile until the group's last key block; f32
    holds it in registers, one slot).  The envelope is the single-block
    kernel's in C, hidden and head dim (f32: C <= 256).  None outside it."""
    if not (c % 64 == 0 and 0 < c <= KERNEL_MAX_C and hidden % 64 == 0
            and 0 < hidden <= 2 * c and heads > 0 and c % heads == 0
            and c // heads in KERNEL_HEAD_DIMS and dtype in KERNEL_DTYPES):
        return None
    if dtype == torch.float32:
        if c > SM90_F32_MAX_C:
            return None
        np = (SM90_QKV_N, *(_pass_width_f32(n) for n in (c, hidden, c)))
        items = LONG_Q_ROWS
    else:
        np = (SM90_QKV_N, _pass_width(c), _pass_width(hidden), _pass_width(c))
        items = 128 if c <= 256 else 64
    qkv = long_qkv_layout(c, c, dtype)
    if qkv is None:
        return None
    rows, qkv_stages, parts, split = qkv
    stages = range(SM90_MAX_STAGES, 1, -1)
    qs = (2, 1) if dtype == torch.bfloat16 else (1,)
    keeps = (1, 0) if dtype == torch.float32 or np[1] == c else (0,)
    for overlap in (0, 1):
        fits = [LongPlan(rows, qkv_stages, np, ws, items, kv, q, overlap, keep, parts, split)
                for kv in range(LONG_MAX_KV, 1, -1) for ws in stages for q in qs
                for keep in (keeps if not overlap else (0,))]
        fits = [p for p in fits if long_smem(p, c, hidden, dtype)[1] <= SMEM_OPTIN]
        if fits:
            return max(fits, key=lambda p: (p.keep, min(p.kv_stages, p.stages), p.kv_stages,
                                            p.stages, p.q_slots))
    return None


def _long_plan_for(c: int, hidden: int, heads: int, dtype: torch.dtype) -> LongPlan:
    plan = long_plan(c, hidden, heads, dtype)
    if plan is None:
        raise ValueError(f"no long-entry plan for C={c}, hidden={hidden}, heads={heads} "
                         f"in {dtype}")
    return plan


def _ints(plan: LongPlan | HalfLongPlan):
    """The plan as the C array the long kernels take."""
    ints = plan.ints()
    return (ctypes.c_int * len(ints))(*ints)


def _long_lib(x: torch.Tensor):
    """The long entry's library, for a CUDA tensor (raises for any other)."""
    from tante_tpu_torch.ops import _build

    if x.device.type != "cuda":
        raise ValueError(f"the long entry's kernels need a CUDA tensor, got {x.device}")
    return _build.load("fused_block_long_sm90")


def long_qkv_fwd(x: torch.Tensor, w: Sm90Weights, plan: LongPlan, l: int) -> torch.Tensor:
    """The qkv entry: (S, L, C) -> the workspace (3, S, C/64, L, 64) of
    q (prescaled), k and v, head group by head group, in x's dtype."""
    s, _, c = x.shape
    lib = _long_lib(x)
    ws = torch.empty((3, s, c // 64, l, 64), dtype=x.dtype, device=x.device)
    entry = lib.tante_block_long_qkv_sm90_f32_fwd if _f32(x) else lib.tante_block_long_qkv_sm90_fwd
    rc = entry(x.data_ptr(), ws.data_ptr(), _ptr_array([w]), _ints(plan), s, l, c,
               w.b1.shape[0], x.device.index, _stream(x))
    _raise_on(rc, "block_long_qkv_fwd")
    _count(long_qkv_fwd, x)
    return ws


def long_attn_fwd(x: torch.Tensor, ws: torch.Tensor, w: Sm90Weights, plan: LongPlan, l: int,
                  heads: int, causal: bool) -> torch.Tensor:
    """The attention entry: on a persistent grid, per work item (sequence,
    ``plan.items`` query rows) attention over the workspace's streamed keys,
    the out-projection and residual, the MLP half and residual -> (S, L, C)."""
    s, _, c = x.shape
    lib = _long_lib(x)
    out = torch.empty_like(x)
    entry = (lib.tante_block_long_attn_sm90_f32_fwd if _f32(x)
             else lib.tante_block_long_attn_sm90_fwd)
    rc = entry(x.data_ptr(), ws.data_ptr(), out.data_ptr(), _ptr_array([w]), _ints(plan), s, l,
               c, w.b1.shape[0], heads, int(bool(causal)), _safe(), x.device.index, _stream(x))
    _raise_on(rc, "block_long_attn_fwd")
    _count(long_attn_fwd, x)
    return out


long_qkv_fwd.launches = collections.Counter()
long_attn_fwd.launches = collections.Counter()


def _launch_long(x: torch.Tensor, p: BlockParams, l: int, heads: int, causal: bool):
    """Both entries of the long block on a CUDA tensor (raises on any
    other, and outside the plan)."""
    _check_kernel_args(x, p, l, heads, max_l=None)
    s, _, c = x.shape
    if s * l >= 2**31:
        raise ValueError(f"the long entry indexes tokens in 32 bits; got {s} x {l}")
    plan = _long_plan_for(c, p.w1.shape[-1], heads, x.dtype)
    w = sm90_weights(p, heads, plan)
    return long_attn_fwd(x, long_qkv_fwd(x, w, plan, l), w, plan, l, heads, causal)


def fused_block_long(x: torch.Tensor, p: BlockParams, l: int, heads: int,
                     causal: bool) -> torch.Tensor:
    """(S, L, C) -> (S, L, C) full pre-LN transformer block at any L through
    the long entry's two kernels (``fused_block_apply`` sends L > 64 here;
    called directly it takes L <= 64 too).  Its plain version is
    ``block_ref``, run for a CPU tensor."""
    if x.device.type == "cpu":
        return block_ref(x, p, l, heads, causal)
    if x.shape[-2] != l:
        raise ValueError(f"x of shape {tuple(x.shape)} does not hold sequences of L={l}")
    return _run(lambda x, ps: _launch_long(x, ps[0], l, heads, causal),
                lambda x, ps: block_ref(x, ps[0], l, heads, causal), x, (p,))


def fused_block_canon_t(x5: torch.Tensor, p: BlockParams, heads: int) -> torch.Tensor:
    """(B, T, H, W, C) -> same: one causal T-axis block on the canonical
    tensor, no rearrange on either side."""
    if x5.device.type == "cpu":
        return canon_t_ref(x5, p, heads)
    b, t, h, w, c = x5.shape
    if not canon_t_supported(t, h, w, c, heads, p.w1.shape[-1], x5.dtype):
        raise ValueError(f"canonical T block unsupported for {tuple(x5.shape)}, heads={heads}, "
                         f"{x5.dtype}")

    def launch(x5, ps):
        from tante_tpu_torch.ops import _build

        (p,) = ps
        _check_kernel_args(x5, p, t, heads)
        hidden = p.w1.shape[-1]
        plan = _plan_for(t, c, hidden, x5.dtype)
        out = torch.empty_like(x5)
        wts = sm90_weights(p, heads, plan)
        row_map = canon_t_map((t, h, w), b)
        lib = _build.load("fused_block_sm90")
        entry = (lib.tante_fused_block_canon_t_sm90_f32_fwd if _f32(x5)
                 else lib.tante_fused_block_canon_t_sm90_fwd)
        rc = entry(
            x5.data_ptr(), out.data_ptr(), _ptr_array([wts]), (ctypes.c_int * 7)(*plan.ints()),
            (ctypes.c_int * 6)(*row_map), b * h * w, t, c, hidden, heads, x5.device.index,
            _stream(x5),
        )
        _raise_on(rc, "fused_block_canon_t_fwd")
        _count(fused_block_canon_t, x5)
        return out

    return _run(launch, lambda x, ps: canon_t_ref(x, ps[0], heads), x5, (p,))


fused_block_canon_t.launches = collections.Counter()


# --------------------------------------------------------------------------
# Chain / group: a run of T/H/W blocks in one launch
# --------------------------------------------------------------------------

# Token orders that make each attention axis contiguous; canonical is "thw"
# (``pallas_block.py:_ORDER``).
_ORDER = {"T": "hwt", "H": "twh", "W": "thw"}
_CANONICAL = "thw"
# Blocks one cooperative launch takes (its argument block holds their 16
# pointers and two row maps each).
KERNEL_MAX_CHAIN = 12


def group_ref(x5: torch.Tensor, params_seq: Sequence[BlockParams], axes: str, heads: int):
    """Plain chain on canonical (B, T, H, W, C): rearrange per axis +
    ``block_ref`` (``pallas_block.py:_xla_group``)."""
    b, t, hp, wp, c = x5.shape
    x = x5
    for axis, p in zip(axes, params_seq):
        if axis == "T":
            x = canon_t_ref(x, p, heads)
        elif axis == "H":
            y = x.permute(0, 1, 3, 2, 4).reshape(b * t * wp, hp, c)
            y = block_ref(y, p, hp, heads, False)
            x = y.reshape(b, t, wp, hp, c).permute(0, 1, 3, 2, 4)
        else:
            y = block_ref(x.reshape(b * t * hp, wp, c), p, wp, heads, False)
            x = y.reshape(b, t, hp, wp, c)
    return x


def chain_ref(x3: torch.Tensor, params_seq: Sequence[BlockParams], axes: str, heads: int,
              dims: tuple) -> torch.Tensor:
    """Plain sub-chain: (s, l, c) in ``axes[0]``'s token order -> (s', l', c)
    in ``axes[-1]``'s (``pallas_block.py:_chain_ref``)."""
    t, hp, wp = dims
    c = x3.shape[-1]
    b = x3.numel() // (t * hp * wp * c)
    if axes[0] == "T":
        x5 = x3.reshape(b, hp, wp, t, c).permute(0, 3, 1, 2, 4)
    elif axes[0] == "H":
        x5 = x3.reshape(b, t, wp, hp, c).permute(0, 1, 3, 2, 4)
    else:
        x5 = x3.reshape(b, t, hp, wp, c)
    y5 = group_ref(x5, params_seq, axes, heads)
    if axes[-1] == "T":
        return y5.permute(0, 2, 3, 1, 4).reshape(b * hp * wp, t, c)
    if axes[-1] == "H":
        return y5.permute(0, 1, 3, 2, 4).reshape(b * t * wp, hp, c)
    return y5.reshape(b * t * hp, wp, c)


def group_fusable(axes: str, dims, c: int, heads: int, hidden: int | None = None,
                  dtype: torch.dtype | None = None) -> bool:
    """Whether the T/H/W chain can run in the chain kernel: known axes, heads
    dividing C (``pallas_block.py:949-956``) and the CUDA kernel's envelope
    (at most 12 blocks, each axis length <= 64, C and the MLP width
    (``hidden``, default C) multiples of 64 with C <= 512 and hidden <= 2C,
    head dim 16/32/64; in f32 a tile plan for every axis, so C <= 256).  The
    TPU gate's VMEM budget has no counterpart: the CUDA kernel tiles
    sequences and keeps no batch element on chip."""
    if any(a not in _ORDER for a in axes) or heads <= 0 or c % heads:
        return False
    hidden = c if hidden is None else hidden
    sizes = dict(zip("THW", dims))
    return (
        1 <= len(axes) <= KERNEL_MAX_CHAIN
        and c % 64 == 0 and c <= KERNEL_MAX_C and c // heads in KERNEL_HEAD_DIMS
        and hidden % 64 == 0 and hidden <= 2 * c
        and all(1 <= sizes[a] <= KERNEL_MAX_L for a in axes)
        and (dtype != torch.float32
             or all(sm90_plan(sizes[a], c, hidden, dtype) is not None for a in axes))
    )


# A sub-chain run has the group's conditions (``pallas_block.py:1028-1034``).
chain_fusable = group_fusable


def _row_strides(order: str, sizes: dict) -> dict:
    """Row stride of each axis letter in a token order such as "hwt"."""
    return {order[0]: sizes[order[1]] * sizes[order[2]], order[1]: sizes[order[2]], order[2]: 1}


def chain_plan(axes: str, dims, b: int, start: str = _CANONICAL, stop: str = _CANONICAL):
    """What the kernel is told per block, as ints: (L, causal, n_seqs) and
    the read and write row maps (per, n2, sb, s1, s2, sa) each: sequence
    ``b * per + i * n2 + j`` (i, j over the two other axes in canonical
    order) has its token ``p`` at row ``b * sb + i * s1 + j * s2 + p * sa``.
    The first block reads token order ``start``, the last writes ``stop``;
    the buffers between are canonical.  This is ``_layout_plan``'s job, with
    the permutations as addressing."""
    sizes = dict(zip("thw", dims))
    m = sizes["t"] * sizes["h"] * sizes["w"]
    plan = []
    for i, axis in enumerate(axes):
        a = axis.lower()
        o1, o2 = (x for x in _CANONICAL if x != a)
        row = [sizes[a], int(axis == "T"), b * m // sizes[a]]
        for order in (start if i == 0 else _CANONICAL, stop if i == len(axes) - 1 else _CANONICAL):
            st = _row_strides(order, sizes)
            row += [sizes[o1] * sizes[o2], sizes[o2], m, st[o1], st[o2], st[a]]
        plan.append(tuple(row))
    return plan


def canon_t_map(dims, b: int) -> tuple:
    """The canonical T block's row map (per, n2, sb, s1, s2, sa), for x and y
    alike: ``chain_plan``'s read map of a lone T block in canonical order."""
    return chain_plan("T", dims, b)[0][3:9]


def chain_plans(axes: str, dims, c: int, hidden: int, dtype: torch.dtype = torch.bfloat16) -> list:
    """Each block's tile plan: ``sm90_plan`` of its own axis.  Rows, column
    passes and ring stages depend on C, the MLP width and the dtype alone
    (every L the chain takes fits a tile), so one shared-memory layout serves
    the run."""
    sizes = dict(zip("THW", dims))
    plans = [sm90_plan(sizes[a], c, hidden, dtype) for a in axes]
    if any(p is None for p in plans):
        raise ValueError(f"no tile plan for axes={axes!r}, dims={tuple(dims)}, C={c}, "
                         f"hidden={hidden}")
    return plans


def chain_weights(params_seq: Sequence[BlockParams], heads: int, plans) -> tuple:
    """The chain's weight schedule: each block's ``sm90_weights`` (re-laid
    once per weight version), streamed back to back."""
    return tuple(sm90_weights(p, heads, plan) for p, plan in zip(params_seq, plans))


def _chain_args(x: torch.Tensor, params_seq, axes: str, heads: int, dims, start: str,
                stop: str) -> tuple:
    """Checks shared by both chain kernels; (C, hidden, batch elements,
    chain_plan ints)."""
    c, hidden = x.shape[-1], params_seq[0].w1.shape[-1]
    if len(params_seq) != len(axes):
        raise ValueError(f"{len(axes)} axes but {len(params_seq)} parameter sets")
    if not group_fusable(axes, dims, c, heads, hidden, x.dtype):
        raise ValueError(f"chain kernel cannot take axes={axes!r}, dims={tuple(dims)}, C={c}, "
                         f"hidden={hidden}, heads={heads}, {x.dtype}")
    m = dims[0] * dims[1] * dims[2]
    if x.numel() % (m * c):
        raise ValueError(f"x of shape {tuple(x.shape)} does not hold (T, H, W) = {tuple(dims)}")
    sizes = dict(zip("THW", dims))
    for axis, p in zip(axes, params_seq):
        if p.w1.shape[-1] != hidden:
            raise ValueError("every block of a chain needs the same MLP width")
        _check_kernel_args(x, p, sizes[axis], heads)
    b = x.numel() // (m * c)
    return c, hidden, b, chain_plan(axes, dims, b, start, stop)


def _scratch(x: torch.Tensor, n_blocks: int) -> tuple:
    """Ping-pong buffers for the activations between blocks (canonical
    order), and their pointers with None where a shorter run needs none."""
    scratch = [torch.empty_like(x) for _ in range(min(2, n_blocks - 1))]
    return scratch, [t.data_ptr() for t in scratch] + [None] * (2 - len(scratch))


def _launch_chain(x: torch.Tensor, params_seq, axes: str, heads: int, dims, start: str,
                  stop: str, out_shape) -> torch.Tensor:
    from tante_tpu_torch.ops import _build

    c, hidden, b, rows = _chain_args(x, params_seq, axes, heads, dims, start, stop)
    plans = chain_plans(axes, dims, c, hidden, x.dtype)
    weights = chain_weights(params_seq, heads, plans)
    plan_ints = [v for plan in plans for v in plan.ints()]
    maps = [v for row in rows for v in row]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    scratch, bufs = _scratch(x, len(axes))
    # Tiles finished per (block, batch element): the kernel's waits between
    # blocks (zeroed by the launch, on the stream).
    done = torch.empty(len(axes) * b, dtype=torch.int32, device=x.device)
    lib = _build.load("fused_chain_sm90")
    entry = lib.tante_fused_chain_sm90_f32_fwd if _f32(x) else lib.tante_fused_chain_sm90_fwd
    rc = entry(
        x.data_ptr(), out.data_ptr(), *bufs, _ptr_array(weights),
        (ctypes.c_int * len(plan_ints))(*plan_ints), (ctypes.c_int * len(maps))(*maps),
        len(axes), c, hidden, heads, _safe(), done.data_ptr(), b, x.device.index, _stream(x),
    )
    _raise_on(rc, "fused_chain_fwd")
    return out


def fused_group_apply(x5: torch.Tensor, params_seq: Sequence[BlockParams], axes: str,
                      heads: int) -> torch.Tensor:
    """(B, T, H, W, C) -> same, running the whole ``axes`` chain (one block
    per letter, T causal) in a single kernel launch."""
    params_seq = tuple(params_seq)
    if x5.device.type == "cpu":
        return group_ref(x5, params_seq, axes, heads)
    dims = tuple(x5.shape[1:4])

    def launch(x5, ps):
        out = _launch_chain(x5, ps, axes, heads, dims, _CANONICAL, _CANONICAL, x5.shape)
        _count(fused_group_apply, x5)
        return out

    return _run(launch, lambda x, ps: group_ref(x, ps, axes, heads), x5, params_seq)


fused_group_apply.launches = collections.Counter()


def fused_chain_apply(x3: torch.Tensor, params_seq: Sequence[BlockParams], axes: str,
                      heads: int, dims: tuple) -> torch.Tensor:
    """(s, l, c) in ``axes[0]``'s token order -> (s', l', c) in
    ``axes[-1]``'s order, running every block of ``axes`` (T causal) in a
    single kernel launch."""
    params_seq = tuple(params_seq)
    if x3.device.type == "cpu":
        return chain_ref(x3, params_seq, axes, heads, dims)
    l_out = dict(zip("THW", dims))[axes[-1]]

    def launch(x3, ps):
        out = _launch_chain(x3, ps, axes, heads, dims, _ORDER[axes[0]], _ORDER[axes[-1]],
                            (x3.numel() // (l_out * x3.shape[-1]), l_out, x3.shape[-1]))
        _count(fused_chain_apply, x3)
        return out

    return _run(launch, lambda x, ps: chain_ref(x, ps, axes, heads, dims), x3, params_seq)


fused_chain_apply.launches = collections.Counter()


# --------------------------------------------------------------------------
# The first design's canonical T and chain entries (csrc/fused_block.cu,
# ``block_tile``: wmma, 48-64-row tiles, per-warp weight rings).  No model
# path takes them; ``chip_smoke.py`` and ``tools/kernel_phases.py`` time the
# Hopper kernels against them in turns on the same card.
# --------------------------------------------------------------------------


def _check_first_design(x: torch.Tensor):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the first design's body takes bf16 only, got {x.dtype}")


def block_tile_canon_t(x5: torch.Tensor, p: BlockParams, heads: int) -> torch.Tensor:
    """The causal T block on canonical (B, T, H, W, C) through the first
    design's body (CUDA only; "fast" softmax)."""
    from tante_tpu_torch.ops import _build

    b, t, h, w, c = x5.shape
    _check_first_design(x5)
    _check_kernel_args(x5, p, t, heads)
    out = torch.empty_like(x5)
    scaled = _prescaled(p, heads)  # alive until enqueued
    rc = _build.load().tante_fused_block_canon_t_fwd(
        x5.data_ptr(), out.data_ptr(), _ptr_array([scaled]), b, t, h * w, c, p.w1.shape[-1],
        heads, x5.device.index, _stream(x5),
    )
    _raise_on(rc, "block_tile canonical T")
    return out


def block_tile_chain(x: torch.Tensor, params_seq: Sequence[BlockParams], axes: str, heads: int,
                     dims, start: str = _CANONICAL, stop: str = _CANONICAL) -> torch.Tensor:
    """A run of blocks through the first design's cooperative chain kernel
    (CUDA only): ``x`` in token order ``start`` -> the same shape in ``stop``
    (a one-block run in the axis's own order is that body on (S, L, C))."""
    from tante_tpu_torch.ops import _build

    params_seq = tuple(params_seq)
    _check_first_design(x)
    c, hidden, _, rows = _chain_args(x, params_seq, axes, heads, dims, start, stop)
    flat = [v for row in rows for v in row]
    out = torch.empty_like(x)
    scratch, bufs = _scratch(x, len(axes))
    scaled = [_prescaled(p, heads) for p in params_seq]
    rc = _build.load().tante_fused_chain_fwd(
        x.data_ptr(), out.data_ptr(), *bufs, _ptr_array(scaled),
        (ctypes.c_int * len(flat))(*flat), len(axes), c, hidden, heads, _safe(),
        x.device.index, _stream(x),
    )
    _raise_on(rc, "block_tile chain")
    return out


# --------------------------------------------------------------------------
# Tensor parallelism: the block split at its two all-reduces
# --------------------------------------------------------------------------


class AttnHalfParams(NamedTuple):
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor


class MlpHalfParams(NamedTuple):
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor


def attn_half_ref(x: torch.Tensor, p: AttnHalfParams, l: int, heads: int, causal: bool):
    """The attention half in plain PyTorch on (rows, L, C): ``block_ref`` cut
    at the out-projection matmul (``pallas_block.py:_xla_attn_half``).  ``p``
    may be a tp shard (attention width ``wq.shape[-1]``, ``heads`` local
    heads).  Returns the pre-bias partial (rows, L, C) in ``x.dtype``.  Its
    attention runs over chunks of sequences (``attention_ref``): the C block
    at tp 2 would otherwise hold 24,576 x 4 heads x 256^2 f32 scores."""
    dt = x.dtype
    c_att = p.wq.shape[-1]
    d = c_att // heads
    xn = ln(x, p.ln1_scale, p.ln1_bias)
    q = ((xn @ p.wq.to(dt)) + p.bq.to(dt)) * (d**-0.5)
    k = (xn @ p.wk.to(dt)) + p.bk.to(dt)
    v = (xn @ p.wv.to(dt)) + p.bv.to(dt)
    q, k, v = (t.reshape(-1, l, heads, d) for t in (q, k, v))
    attn = attention_ref(q, k, v, causal, dt).reshape(*x.shape[:-1], c_att)
    return attn @ p.wo.to(dt)


def mlp_half_ref(x2: torch.Tensor, p: MlpHalfParams) -> torch.Tensor:
    """The MLP half in plain PyTorch (``pallas_block.py:_xla_mlp_half``):
    the pre-bias fc2 partial in ``x2.dtype``."""
    dt = x2.dtype
    yn = ln(x2, p.ln2_scale, p.ln2_bias)
    h1 = gelu_tanh_f32(((yn @ p.w1.to(dt)) + p.b1.to(dt)).float()).to(dt)
    return h1 @ p.w2.to(dt)


def tp_fusable(c: int, heads: int, hidden: int, tp: int) -> bool:
    """Whether the block geometry splits evenly over ``tp`` shards."""
    return (tp >= 1 and heads % tp == 0 and c % tp == 0 and hidden % tp == 0
            and (c // tp) % (heads // tp) == 0)


def _pack_attn(flat) -> tuple:
    return (AttnHalfParams(*flat),)


def _pack_mlp(flat) -> tuple:
    return (MlpHalfParams(*flat),)


def _check_half_device(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"tp half kernel needs a CUDA tensor, got {x.device}")


def _check_half_x(x: torch.Tensor, c: int, local: int):
    """The halves' input on any device: contiguous, in one of the kernels'
    dtypes (bf16 or f32), of a width the halves take."""
    if x.dtype not in KERNEL_DTYPES or not x.is_contiguous():
        raise ValueError(f"kernel input must be contiguous bf16 or f32, got {x.dtype}")
    if c % 64 or c > KERNEL_MAX_C or local % 16 or not 16 <= local <= 2 * c:
        raise ValueError(f"tp half kernel needs C % 64 == 0, C <= {KERNEL_MAX_C} and a local "
                         f"width that is a multiple of 16 in [16, 2C]; got C={c}, local={local}")


def _check_attn_half(x: torch.Tensor, p: AttnHalfParams, l: int, heads: int,
                     max_l: int | None = KERNEL_MAX_L):
    """x and every parameter of the shard in x's dtype (bf16 or f32);
    sequences of 1..``max_l`` (any length for None: the long half)."""
    c, ca = x.shape[-1], p.wq.shape[-1]
    _check_half_x(x, c, ca)
    if heads <= 0 or ca % heads or ca // heads not in KERNEL_HEAD_DIMS or ca > c:
        raise ValueError(f"attention half: local width {ca} over {heads} heads, C={c}")
    if l < 1 or (max_l is not None and l > max_l):
        raise ValueError(f"kernel holds sequences of 1..{max_l}, got L={l}")
    _check_params(x, p, ((c,), (c,), (c, ca), (ca,), (c, ca), (ca,), (c, ca), (ca,), (ca, c)),
                  x.dtype)


def _check_mlp_half(x2: torch.Tensor, p: MlpHalfParams):
    c, hl = x2.shape[-1], p.w1.shape[-1]
    _check_half_x(x2, c, hl)
    _check_params(x2, p, ((c,), (c,), (c, hl), (hl,), (hl, c)), x2.dtype)


# --------------------------------------------------------------------------
# The tp halves for Hopper (csrc/fused_half_sm90.cu, on the block body of
# csrc/block_sm90.cuh)
# --------------------------------------------------------------------------

class HalfPlan(NamedTuple):
    rows: int        # R: rows of a tile (64 or 128)
    seqs: int        # whole sequences per tile (the MLP half: R rows of L = 1)
    width: int       # the shard's local width padded to a multiple of 64 (W)
    np: tuple        # column passes: q|k|v (192) or fc1; out-projection or fc2
    stages: int      # weight slabs in the ring
    f32: bool = False  # the f32 kernels' plan: their weight slabs (arrange_weight_f32)

    def ints(self) -> list:
        return [self.rows, self.seqs, self.width, *self.np, self.stages]


def half_smem(attn: bool, rows: int, c: int, width: int, np: tuple, stages: int,
              dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory bytes of a half's plan (``fused_half_sm90.cu:half_layout``,
    ``fused_half_sm90_f32.cu:half_layout_f32``): the LayerNorm output, the
    attention half's q|k|v tile, the attention or fc1 output (W wide), the
    slab ring and its barriers.  f32 tiles are row-major with 4 floats of
    padding a row, and f32 slabs are 16 rows deep."""
    if dtype == torch.float32:
        qkv = rows * SM90_F32_QKV_LD * 4 if attn else 0
        return (rows * (c + 4) * 4 + qkv + rows * (width + 4) * 4
                + stages * SM90_F32_SLAB_K * max(np) * 4 + 2 * SM90_MAX_STAGES * 8)
    qkv = rows * SM90_QKV_LD * 2 if attn else 0
    return (rows * c * 2 + qkv + rows * width * 2 + stages * SM90_SLAB_K * max(np) * 2
            + 2 * SM90_MAX_STAGES * 8)


@functools.lru_cache(maxsize=64)
def half_plan(kind: str, l: int, c: int, local: int,
              dtype: torch.dtype = torch.bfloat16) -> HalfPlan | None:
    """The tile plan of the "attn" half on sequences of length ``l`` or the
    "mlp" half (``l`` = 1) for a shard ``local`` columns wide, in ``dtype``:
    bf16, 128-row tiles when C <= 256, else 64 (the LayerNorm's registers);
    f32, 64-row tiles, C <= 256 and column passes past the q|k|v one 64 or
    128 wide (the f32 body's); as many ring stages as fit, up to four.  None
    outside ``_check_half_x``'s envelope (and, for the attention half,
    local <= C), or where no f32 tile fits."""
    attn = kind == "attn"
    if not (c % 64 == 0 and 0 < c <= KERNEL_MAX_C and local % 16 == 0
            and 16 <= local <= (c if attn else 2 * c) and 1 <= l <= (KERNEL_MAX_L if attn else 1)):
        return None
    width = -(-local // 64) * 64
    if dtype == torch.float32:
        if c > SM90_F32_MAX_C:
            return None
        np = (SM90_QKV_N if attn else _pass_width_f32(width), _pass_width_f32(c))
        rows = SM90_F32_ROWS
    else:
        np = (SM90_QKV_N if attn else _pass_width(width), _pass_width(c))
        rows = 128 if c <= 256 else 64
    for stages in range(SM90_MAX_STAGES, 1, -1):
        if half_smem(attn, rows, c, width, np, stages, dtype) <= SMEM_OPTIN:
            return HalfPlan(rows, rows // l, width, np, stages, dtype == torch.float32)
    return None


class HalfWeights(NamedTuple):
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    bias: torch.Tensor   # each head group's bq (prescaled) | bk | bv; or b1; W wide
    slabs: torch.Tensor  # every weight slab of a tile's schedule, in order


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(w, (0, 0, 0, rows - w.shape[0]))


def _slab_layout(plan: HalfPlan | HalfLongPlan) -> Callable:
    """The weight slabs of the plan's kernels: wgmma's core matrices (bf16)
    or the f32 body's mma.sync fragment order."""
    return arrange_weight_f32 if plan.f32 else arrange_weight


def _arrange_attn_half(p: AttnHalfParams, heads: int,
                       plan: HalfPlan | HalfLongPlan) -> HalfWeights:
    ws, bqkv = qkv_groups(p, heads)
    arrange = _slab_layout(plan)
    slabs = torch.cat([*(arrange(w, plan.np[0]) for w in ws),
                       arrange(_pad_rows(p.wo, plan.width), plan.np[1])])
    return HalfWeights(p.ln1_scale, p.ln1_bias, bqkv, slabs)


def _arrange_mlp_half(p: MlpHalfParams, plan: HalfPlan) -> HalfWeights:
    pad = plan.width - p.w1.shape[-1]
    arrange = _slab_layout(plan)
    slabs = torch.cat([arrange(F.pad(p.w1, (0, pad)), plan.np[0]),
                       arrange(_pad_rows(p.w2, plan.width), plan.np[1])])
    return HalfWeights(p.ln2_scale, p.ln2_bias, F.pad(p.b1, (0, pad)), slabs)


def half_weights(p: AttnHalfParams | MlpHalfParams, plan: HalfPlan,
                 heads: int = 0) -> HalfWeights:
    """A half's weights for ``p`` (``heads`` local heads for the attention
    half), re-laid once per weight version: zero-padded to the plan's width,
    q prescaled, slab after slab in the order the tile consumes them."""
    if isinstance(p, AttnHalfParams):
        return relaid_weights(p, ("attn", heads, plan), lambda: _arrange_attn_half(p, heads, plan))
    return relaid_weights(p, ("mlp", plan), lambda: _arrange_mlp_half(p, plan))


def _half_plan_for(kind: str, l: int, c: int, local: int, dtype: torch.dtype) -> HalfPlan:
    plan = half_plan(kind, l, c, local, dtype)
    if plan is None:
        raise ValueError(f"no {kind} half tile plan for L={l}, C={c}, local width {local} in "
                         f"{dtype}")
    return plan


def _half_entry(kind: str, x: torch.Tensor) -> Callable:
    """The C entry of the ``kind`` half ("attn" / "mlp") for x's dtype:
    ``fused_half_sm90.cu``'s (bf16) or ``fused_half_sm90_f32.cu``'s."""
    from tante_tpu_torch.ops import _build

    dt = "_f32" if _f32(x) else ""
    return getattr(_build.load(f"fused_half_sm90{dt}"), f"tante_{kind}_half_sm90{dt}_fwd")


def attn_half_apply(x: torch.Tensor, p: AttnHalfParams, l: int, heads: int,
                    causal: bool) -> torch.Tensor:
    """(S, L, C) -> the pre-bias attention partial (S, L, C) of one tp shard
    (``heads`` local heads) in x's dtype.  CUDA kernel ``attn_half_fwd``
    (``csrc/fused_half_sm90.cu``; in f32 ``csrc/fused_half_sm90_f32.cu``)
    for L <= ``KERNEL_MAX_L``, the long half (``attn_half_long``) past it;
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return attn_half_ref(x, p, l, heads, causal)
    if x.shape[-2] != l:
        raise ValueError(f"x of shape {tuple(x.shape)} does not hold sequences of L={l}")
    if l > KERNEL_MAX_L:
        return attn_half_long(x, p, l, heads, causal)

    def launch(x, ps):
        (p,) = ps
        _check_half_device(x)
        _check_attn_half(x, p, l, heads)
        c, ca = x.shape[-1], p.wq.shape[-1]
        plan = _half_plan_for("attn", l, c, ca, x.dtype)
        w = half_weights(p, plan, heads)
        out = torch.empty_like(x)
        rc = _half_entry("attn", x)(
            x.data_ptr(), out.data_ptr(), _ptr_array([w]), (ctypes.c_int * 6)(*plan.ints()),
            x.numel() // (l * c), l, c, ca, heads, int(bool(causal)), _safe(), x.device.index,
            _stream(x),
        )
        _raise_on(rc, "attn_half_fwd")
        _count(attn_half_apply, x)
        return out

    return _run(launch, lambda x, ps: attn_half_ref(x, ps[0], l, heads, causal), x, (p,),
                _pack_attn)


attn_half_apply.launches = collections.Counter()


def mlp_half_apply(x2: torch.Tensor, p: MlpHalfParams) -> torch.Tensor:
    """(..., C) -> the pre-bias MLP partial of one tp shard (rows are
    independent) in x2's dtype.  CUDA kernel ``mlp_half_fwd``
    (``csrc/fused_half_sm90.cu``; in f32 ``csrc/fused_half_sm90_f32.cu``);
    the plain version on the CPU."""
    if x2.device.type == "cpu":
        return mlp_half_ref(x2, p)

    def launch(x2, ps):
        (p,) = ps
        _check_half_device(x2)
        _check_mlp_half(x2, p)
        c, hl = x2.shape[-1], p.w1.shape[-1]
        plan = _half_plan_for("mlp", 1, c, hl, x2.dtype)
        w = half_weights(p, plan)
        out = torch.empty_like(x2)
        rc = _half_entry("mlp", x2)(
            x2.data_ptr(), out.data_ptr(), _ptr_array([w]), (ctypes.c_int * 6)(*plan.ints()),
            x2.numel() // c, c, hl, x2.device.index, _stream(x2),
        )
        _raise_on(rc, "mlp_half_fwd")
        _count(mlp_half_apply, x2)
        return out

    return _run(launch, lambda x, ps: mlp_half_ref(x, ps[0]), x2, (p,), _pack_mlp)


mlp_half_apply.launches = collections.Counter()


# --------------------------------------------------------------------------
# The attention half at any sequence length (csrc/fused_half_long_sm90.cu):
# the long entry's split after q|k|v on the halves' padded shard.  A qkv
# kernel over token tiles into a workspace of the shard's head groups, then
# the long entry's attention (a persistent grid over work items of R query
# rows, csrc/long_sm90.cuh) over those groups, whose tail writes the
# out-projection partial.
# --------------------------------------------------------------------------


class HalfLongPlan(NamedTuple):
    rows: int          # token rows of a qkv-kernel tile (sequences ignored)
    qkv_stages: int    # weight slabs in the qkv kernel's ring; 0: its weights resident
    width: int         # the shard's local width padded to a multiple of 64 (W)
    np: tuple          # column passes: q|k|v (192), out-projection
    stages: int        # weight slabs in the attention kernel's ring
    f32: bool = False  # the f32 kernels' plan: their weight slabs (arrange_weight_f32)
    items: int = 64    # query rows of an attention work item (R)
    kv_stages: int = 2  # k|v blocks in the attention kernel's ring
    q_slots: int = 1    # q tiles in flight
    qkv_parts: int = 3  # the qkv kernel's staging buffers (R x 64 each)
    qkv_split: int = 0  # 1 (f32): LN1's output stored split in TF32 hi / lo tiles

    @property
    def overlap(self) -> int:
        """The half's tail tiles never overlap the q slots and the ring."""
        return 0

    @property
    def qkv_resident(self) -> bool:
        """The qkv kernel holds every group's q|k|v slabs in shared memory."""
        return self.qkv_stages == 0

    def ints(self) -> list:
        return [self.rows, self.qkv_stages, self.width, *self.np, self.stages, self.items,
                self.kv_stages, self.q_slots, self.qkv_parts, self.qkv_split]


def half_long_smem(plan: HalfLongPlan, c: int, dtype: torch.dtype) -> tuple[int, int]:
    """Shared memory bytes of the long half's qkv and attention kernels
    (``fused_half_long_sm90.cu:half_long_shape``).  qkv: the long block's
    (``_long_qkv_smem`` at width W).  Attention (``layout_half_attn``): the item's
    attention output (R x W), in bf16 the partial's staging tile of the
    out-projection pass, at least a pair item's exchange area; the q slots,
    the k|v ring, the ring of out-projection slabs; each region on 128
    bytes; then the barriers."""
    f32 = dtype == torch.float32
    e = 4 if f32 else 2
    slab_k = SM90_F32_SLAB_K if f32 else SM90_SLAB_K
    r = plan.items
    h = 0 if f32 else max(r * (plan.np[1] + 8) * 2, LONG_PAIR_SCRATCH)
    at_q = _align128(_align128(_act_tile(r, plan.width, dtype)) + h)
    at_kv = _align128(at_q + plan.q_slots * long_q_bytes(r, dtype))
    at_ring = _align128(at_kv + plan.kv_stages * long_kv_bytes(dtype))
    attn = at_ring + plan.stages * slab_k * plan.np[1] * e + _LONG_ATTN_BARS * 8
    return (_long_qkv_smem(plan.rows, plan.qkv_stages, plan.qkv_parts, c, plan.width, dtype,
                           plan.qkv_split), attn)


@functools.lru_cache(maxsize=64)
def half_long_plan(c: int, local: int, heads: int,
                   dtype: torch.dtype = torch.bfloat16) -> HalfLongPlan | None:
    """The long half's plan for a shard ``local`` columns wide with ``heads``
    local heads, the same at every L: the long block's qkv layout at the
    padded width W (``long_qkv_layout``: 128-row tiles in bf16 where
    C <= 256, else 64; f32 64; the weights resident where they fit, else a
    ring of 2-4 slabs; staging buffers), the short halves' padded width and
    column passes;
    attention items of 128 query rows in bf16 where they fit (two consumer
    warpgroups of 64; else 64), 64 in f32, and as ``long_plan`` picks: the
    deepest of the k|v ring and the weight ring (2-4 stages each: the
    shallower of the two first), the deeper k|v ring, weight ring, and two
    q slots before one (bf16; f32 one).  The envelope is the short halves'
    in width (a multiple of 16 in [16, C]) and the block's in head dim (f32:
    C <= 256).  None outside it."""
    if not (c % 64 == 0 and 0 < c <= KERNEL_MAX_C and local % 16 == 0 and 16 <= local <= c
            and heads > 0 and local % heads == 0 and local // heads in KERNEL_HEAD_DIMS
            and dtype in KERNEL_DTYPES):
        return None
    f32 = dtype == torch.float32
    width = -(-local // 64) * 64
    if f32:
        if c > SM90_F32_MAX_C:
            return None
        np = (SM90_QKV_N, _pass_width_f32(c))
        items, qs = (LONG_Q_ROWS,), (1,)
    else:
        np = (SM90_QKV_N, _pass_width(c))
        items, qs = (128, LONG_Q_ROWS), (2, 1)
    qkv = long_qkv_layout(c, width, dtype)
    if qkv is None:
        return None
    rows, qkv_stages, parts, split = qkv
    stages = range(SM90_MAX_STAGES, 1, -1)
    for r in items:
        fits = [HalfLongPlan(rows, qkv_stages, width, np, ws, f32, r, kv, q, parts, split)
                for kv in range(LONG_MAX_KV, 1, -1) for ws in stages for q in qs]
        fits = [p for p in fits if half_long_smem(p, c, dtype)[1] <= SMEM_OPTIN]
        if fits:
            return max(fits, key=lambda p: (min(p.kv_stages, p.stages), p.kv_stages, p.stages,
                                            p.q_slots))
    return None


def _half_long_plan_for(c: int, local: int, heads: int, dtype: torch.dtype) -> HalfLongPlan:
    plan = half_long_plan(c, local, heads, dtype)
    if plan is None:
        raise ValueError(f"no long attention half plan for C={c}, local width {local}, "
                         f"{heads} local heads in {dtype}")
    return plan


def half_long_weights(p: AttnHalfParams, heads: int, plan: HalfLongPlan) -> HalfWeights:
    """The long half's weights for the shard ``p``, re-laid once per weight
    version under a key of their own: the short halves' layout (each head
    group's q|k|v slabs, q prescaled, then wo's, zero-padded to W)."""
    return relaid_weights(p, ("attn_long", heads, plan), lambda: _arrange_attn_half(p, heads, plan))


def _half_long_lib(x: torch.Tensor):
    """The long half's library, for a CUDA tensor (raises for any other)."""
    from tante_tpu_torch.ops import _build

    if x.device.type != "cuda":
        raise ValueError(f"the long attention half's kernels need a CUDA tensor, got {x.device}")
    return _build.load("fused_half_long_sm90")


def half_long_qkv_fwd(x: torch.Tensor, w: HalfWeights, plan: HalfLongPlan, l: int,
                      local: int) -> torch.Tensor:
    """The qkv kernel: (S, L, C) -> the workspace (3, S, W/64, L, 64) of the
    shard's q (prescaled), k and v, head group by head group, in x's dtype."""
    c = x.shape[-1]
    s = x.numel() // (l * c)
    lib = _half_long_lib(x)
    ws = torch.empty((3, s, plan.width // 64, l, 64), dtype=x.dtype, device=x.device)
    entry = (lib.tante_attn_half_long_qkv_sm90_f32_fwd if _f32(x)
             else lib.tante_attn_half_long_qkv_sm90_fwd)
    rc = entry(x.data_ptr(), ws.data_ptr(), _ptr_array([w]), _ints(plan), s, l, c, local,
               x.device.index, _stream(x))
    _raise_on(rc, "attn_half_long_qkv_fwd")
    _count(half_long_qkv_fwd, x)
    return ws


def half_long_attn_fwd(x: torch.Tensor, ws: torch.Tensor, w: HalfWeights, plan: HalfLongPlan,
                       l: int, local: int, heads: int, causal: bool) -> torch.Tensor:
    """The attention kernel: on a persistent grid, per work item (sequence,
    ``plan.items`` query rows) attention over the workspace's streamed keys
    of the shard's head groups and the out-projection -> the pre-bias
    partial, x's shape and dtype (x itself is not read: the workspace holds
    what the kernel needs of it)."""
    c = x.shape[-1]
    lib = _half_long_lib(x)
    out = torch.empty_like(x)
    entry = (lib.tante_attn_half_long_attn_sm90_f32_fwd if _f32(x)
             else lib.tante_attn_half_long_attn_sm90_fwd)
    rc = entry(ws.data_ptr(), out.data_ptr(), _ptr_array([w]), _ints(plan), x.numel() // (l * c),
               l, c, local, heads, int(bool(causal)), _safe(), x.device.index, _stream(x))
    _raise_on(rc, "attn_half_long_attn_fwd")
    _count(half_long_attn_fwd, x)
    return out


half_long_qkv_fwd.launches = collections.Counter()
half_long_attn_fwd.launches = collections.Counter()


def half_long_attn_work(x: torch.Tensor, plan: HalfLongPlan, l: int, local: int) -> dict:
    """The attention kernel's work on the CUDA tensor x (S sequences of L,
    C) under ``plan`` for a shard ``local`` columns wide, from its kernel
    library: R-row tiles, the big ones, items and grid (one CTA per SM)."""
    c = x.shape[-1]
    out = (ctypes.c_int * 4)()
    rc = _half_long_lib(x).tante_attn_half_long_attn_items(
        _ints(plan), x.numel() // (l * c), l, c, local, int(_f32(x)), x.device.index, out)
    _raise_on(rc, "attn_half_long_attn_items")
    return dict(zip(("tiles", "big", "items", "grid"), out))


def _launch_half_long(x: torch.Tensor, p: AttnHalfParams, l: int, heads: int, causal: bool):
    """Both kernels of the long half on a CUDA tensor (raises on any other,
    and outside the plan)."""
    _check_half_device(x)
    _check_attn_half(x, p, l, heads, max_l=None)
    c, ca = x.shape[-1], p.wq.shape[-1]
    if x.numel() // c >= 2**31:
        raise ValueError(f"the long half indexes tokens in 32 bits; got {x.numel() // c}")
    plan = _half_long_plan_for(c, ca, heads, x.dtype)
    w = half_long_weights(p, heads, plan)
    ws = half_long_qkv_fwd(x, w, plan, l, ca)
    return half_long_attn_fwd(x, ws, w, plan, l, ca, heads, causal)


def attn_half_long(x: torch.Tensor, p: AttnHalfParams, l: int, heads: int,
                   causal: bool) -> torch.Tensor:
    """(S, L, C) -> the pre-bias attention partial of one tp shard at any L
    through the long half's two kernels (``attn_half_apply`` sends L > 64
    here; called directly it takes L <= 64 too).  Its plain version is
    ``attn_half_ref``, run for a CPU tensor."""
    if x.device.type == "cpu":
        return attn_half_ref(x, p, l, heads, causal)
    if x.shape[-2] != l:
        raise ValueError(f"x of shape {tuple(x.shape)} does not hold sequences of L={l}")
    return _run(lambda x, ps: _launch_half_long(x, ps[0], l, heads, causal),
                lambda x, ps: attn_half_ref(x, ps[0], l, heads, causal), x, (p,), _pack_attn)


# The first design's halves (csrc/fused_block.cu: attn_half_kernel /
# mlp_half_kernel on ``block_tile``'s device functions).  No model path
# takes them; chip_smoke.py, tools/kernel_phases.py and the GPU tests time
# the Hopper halves against them in turns on the same card.


def block_tile_attn_half(x: torch.Tensor, p: AttnHalfParams, l: int, heads: int,
                         causal: bool) -> torch.Tensor:
    """The attention half through the first design's body (CUDA only, bf16)."""
    from tante_tpu_torch.ops import _build

    _check_first_design(x)
    _check_half_device(x)
    _check_attn_half(x, p, l, heads)
    c, ca = x.shape[-1], p.wq.shape[-1]
    out = torch.empty_like(x)
    qs = (ca // heads) ** -0.5 * LOG2E
    scaled = p._replace(wq=p.wq * qs, bq=p.bq * qs)  # alive until enqueued
    rc = _build.load().tante_attn_half_fwd(
        x.data_ptr(), out.data_ptr(), _ptr_array([scaled]), x.numel() // (l * c), l, c, ca,
        heads, int(bool(causal)), _safe(), x.device.index, _stream(x),
    )
    _raise_on(rc, "block_tile attention half")
    _count(block_tile_attn_half, x)
    return out


block_tile_attn_half.launches = collections.Counter()


def block_tile_mlp_half(x2: torch.Tensor, p: MlpHalfParams) -> torch.Tensor:
    """The MLP half through the first design's body (CUDA only, bf16)."""
    from tante_tpu_torch.ops import _build

    _check_first_design(x2)
    _check_half_device(x2)
    _check_mlp_half(x2, p)
    c, hl = x2.shape[-1], p.w1.shape[-1]
    out = torch.empty_like(x2)
    rc = _build.load().tante_mlp_half_fwd(
        x2.data_ptr(), out.data_ptr(), _ptr_array([p]), x2.numel() // c, c, hl,
        x2.device.index, _stream(x2),
    )
    _raise_on(rc, "block_tile MLP half")
    _count(block_tile_mlp_half, x2)
    return out


block_tile_mlp_half.launches = collections.Counter()


def fused_block_apply_tp(x: torch.Tensor, p: BlockParams, l: int, heads: int, causal: bool,
                         mesh) -> torch.Tensor:
    """(rows, L, C) -> (rows, L, C): the block on this rank's weight shards
    (``pallas_block.py:fused_block_apply_tp`` / ``_tp_block_impl``).

    ``p`` holds this rank's shards as ``parallel/sharding.py:shard_params``
    leaves them (q/k/v and fc1 columns, wo and fc2 rows), ``heads`` the
    block's full head count.  Each half runs its kernel (its plain version
    on the CPU), then an all-reduce over 'tp', then bias and residual in the
    activation dtype.  Whole weights (tp == 1, or a geometry that does not
    split, which ``shard_params`` leaves whole) run the unsplit block:
    ``fused_block_apply``.

    Gradients: the Megatron pair (``parallel/collectives.py``) around each
    half, whose Function differentiates the plain half; the LayerNorm
    parameters enter through ``copy_to_tp`` too (each shard's gradient of
    them is partial).  The JAX package recomputes the unsplit block instead,
    which needs whole weights; the gradient is the same."""
    from tante_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp

    c = x.shape[-1]
    tp = mesh.size("tp")
    if tp == 1 or p.wq.shape[-1] == c:
        return fused_block_apply(x, p, l, heads, causal)
    if p.wq.shape[-1] * tp != c or not tp_fusable(c, heads, p.w1.shape[-1] * tp, tp):
        raise ValueError(f"weights of width {p.wq.shape[-1]} are not a tp={tp} shard of C={c} "
                         f"with {heads} heads")
    g = mesh.group("tp")
    ap = AttnHalfParams(copy_to_tp(p.ln1_scale, g), copy_to_tp(p.ln1_bias, g),
                        p.wq, p.bq, p.wk, p.bk, p.wv, p.bv, p.wo)
    out = reduce_from_tp(attn_half_apply(copy_to_tp(x, g), ap, l, heads // tp, causal), g)
    xm = x + (out + p.bo).to(x.dtype)
    mp = MlpHalfParams(copy_to_tp(p.ln2_scale, g), copy_to_tp(p.ln2_bias, g), p.w1, p.b1, p.w2)
    h2 = reduce_from_tp(mlp_half_apply(copy_to_tp(xm, g), mp), g)
    return xm + (h2 + p.b2).to(x.dtype)


WRAPPERS = (fused_block_apply, fused_block_canon_t, fused_chain_apply, fused_group_apply,
            attn_half_apply, mlp_half_apply, long_qkv_fwd, long_attn_fwd, half_long_qkv_fwd,
            half_long_attn_fwd)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches.clear()
