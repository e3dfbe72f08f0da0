// The block for sequences longer than a tile: the whole pre-LN block of
// block_sm90.cuh on (S, L, C) at any L, as two kernels, each for bf16 and for
// f32 activations and weights.
//
//   y = x' + fc2(gelu_tanh(fc1(ln2(x'))))      x' = x + wo(attn(ln1(x)))
//
// Replaces tante_tpu/ops/pallas_block.py fused_block_apply (:208, its
// pallas_call at :163) at L > 64, where the single-block kernel
// (fused_block_sm90.cu) cannot hold whole sequences in a tile: the TANTE axes
// L (H*W = 768 at the flagship), X (T*W = 192), A (T*H*W = 3072) and the
// channel axis C (L = C = 256 channels, each lifted to expanded_channel =
// 128).  A query past a tile's 64 rows attends to keys that another CTA
// projects, so the block splits where the Pallas kernel rounds to the
// activation type anyway: after q, k and v.  The split adds no rounding.
//
//   tante_block_long_qkv_sm90[_f32]_fwd   LN1 and the q|k|v products of
//     64- or 128-row tiles of the (S*L, C) token matrix, sequences ignored:
//     the single-block kernel's LayerNorm, gemm (wgmma, bf16) / gemm_f32
//     (3xTF32 mma.sync, f32) and weight ring, q prescaled by d^-0.5*log2(e)
//     (folded into wq/bq by the wrapper), + bias, rounded to the activation
//     type, into a workspace laid out head group by head group,
//     (3, S, C/64, L, 64): the 64 keys of a block of one head group are one
//     contiguous run of 64 x 64 values.
//   tante_block_long_attn_sm90[_f32]_fwd  one CTA per (sequence, 64-query
//     tile), ragged last tiles masked.  Per head group: the q tile, then the
//     group's k|v in blocks of 64 keys through a two-stage cp.async ring in
//     shared memory, scores and the AV product on mma.sync m16n8k16 (bf16:
//     the single-block kernel's attention_group, ldmatrix and register
//     fragments) or on FFMA, one thread per (query, head) (f32:
//     attention_group_f32's arithmetic).  Then the single-block kernel's
//     tail unchanged: the out-projection + bo + residual (x' to y), LN2,
//     fc1 + GELU, fc2 + b2 + residual, its weights streamed by one producer
//     thread.
//
// Softmax.  "fast" (the default) has no max-subtract, so each key block adds
// bf16(unnorm) V to the output fragment and unnorm (f32) to the denominator,
// unnorm = exp2(min(s, 60*log2 e)) over the admitted keys: every element is
// the Pallas kernel's own value and only the order of the f32 sums differs.
// "safe" takes two passes over the keys: each row's maximum over all its
// admitted keys first, then exp2(s - max).  That repeats QK^T but keeps
// JAX's per-element values (an online rescale would change which value is
// rounded to bf16).  Causal: key <= query; key blocks wholly above the
// diagonal of a tile are not loaded, 16-key chunks above a 16-query block's
// diagonal not multiplied.  The result is scaled by 1/(sum + 1e-30) and
// rounded.
//
// Bound: operations (chip_smoke.py:bound / bound_f32).  At the flagship
// (8 heads, MLP ratio 1) an L block is 38.7 GFLOP and a C block 2,062 GFLOP
// (1,237 projections, 825 attention): 0.039 / 2.09 ms at 989 TFLOP/s bf16,
// three times the TF32 time in f32 (3xTF32).  Bytes: x and y once, plus the
// workspace's write and read (3 C values a token each way), which this
// design adds.  What it does about the bound: every projection is on the
// tensor cores (wgmma / 3xTF32), every score and weighted value of bf16 too;
// scores never reach device memory (the plain version's f32 score tensor of
// the C block is 51.5 GB).  Left for later (ROADMAP): wgmma and TMA for the
// attention, one CTA per sequence of the C axis (K/V loaded once, not once
// per query tile), the f32 attention on the tensor cores, and the qkv entry
// in a persistent schedule with the attention.
//
// The pieces the tensor-parallel attention half at L > 64 shares with this
// block (fused_half_long_sm90.cu) are in long_sm90.cuh.

#include "long_sm90.cuh"

namespace {

// The widest column pass of the attention entry's matmuls (out-projection,
// fc1, fc2).
__host__ __device__ inline int tail_pass(const int* np) {
  const int m = np[1] > np[2] ? np[1] : np[2];
  return m > np[3] ? m : np[3];
}

// The attention entry: region a holds the q tile and two k|v stages (from
// offset qkv) during attention, then the out-projection's staging tile
// (bf16), then the MLP hidden; region b the attention output, then the LN2
// output, then fc2's staging tile; the slab ring; its barriers.
__host__ __device__ inline Layout layout_attn(bool f32, int C, int HID, const int* np,
                                              int stages) {
  Layout l{};
  const size_t e = f32 ? 4 : 2;
  const size_t q = (size_t)kQRows * (f32 ? kQLdF : kQLd) * e;
  const size_t kv = (size_t)kKeyBlk * (f32 ? kKvLdF : kKvLd) * e;
  const size_t hid = f32 ? (size_t)kQRows * ld_f(HID) * 4 : (size_t)kQRows * HID * 2;
  const size_t stage = f32 ? 0 : (size_t)kQRows * (np[1] + 8) * 2;
  size_t a = q + 2 * kv;
  a = hid > a ? hid : a;
  a = stage > a ? stage : a;
  const size_t b = f32 ? (size_t)kQRows * ld_f(C) * 4 : (size_t)kQRows * C * 2;
  l.qkv = q;  // the k|v stages
  l.b = align128(a);
  l.ring = align128(l.b + b);
  l.bars = l.ring + (size_t)stages * (f32 ? kSlabKF : kSlabK) * tail_pass(np) * e;
  l.total = l.bars + 2 * kMaxStages * sizeof(uint64_t);
  return l;
}

// The attention entry's layout (block_cta's Plan).
template <bool F32>
struct AttnPlan {
  __device__ static Layout layout(const Shape& S) {
    return layout_attn(F32, S.C, S.HID, S.np, S.stages);
  }
  __device__ static int stage_bytes(const Shape& S) {
    return (F32 ? kSlabKF * 4 : kSlabK * 2) * tail_pass(S.np);
  }
};

// ---- the qkv entry --------------------------------------------------------------
//
// long_sm90.cuh's qkv body over all C/64 head groups.

__global__ void __launch_bounds__(kThreads, 1) block_long_qkv_kernel(const __grid_constant__ LongArgs A) {
  long_qkv<false>(A);
}

__global__ void __launch_bounds__(kThreads, 1) block_long_qkv_f32_kernel(const __grid_constant__ LongArgs A) {
  long_qkv_f32<false>(A);
}

// ---- the attention entry --------------------------------------------------------------

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1) block_long_attn_kernel(const __grid_constant__ LongArgs A) {
  const Shape& S = A.sh;
  const int groups = S.C / 64;
  block_cta<bf16, AttnPlan<false>>(
      S, [&](Ring& ring) { produce_range<bf16>(A, ring, groups, groups + 3); },
      [&](Ring& ring, bf16* sA, bf16* sB, bf16* sKV) {
        const int C = S.C, HID = S.HID;
        const int s = blockIdx.x / A.qtiles, q0 = (blockIdx.x - s * A.qtiles) * kQRows;
        const int valid = min(kQRows, A.L - q0);
        const ContigTile rows{((size_t)s * A.L + q0) * C, C};
        for (int gi = 0; gi < groups; ++gi)
          attention_long<D, SAFE>(A, s, gi, q0, valid, sA, sKV, sB, C);
        fence_async_smem();
        consumers_sync();
        const bf16* x = static_cast<const bf16*>(A.x);
        bf16* y = static_cast<bf16*>(A.y);
        auto w = [&](int k) { return static_cast<const bf16*>(A.p[k]); };
        // x' = x + bf16(attn wo + bo), to y; the residual staged in region a.
        gemm_np(sB, C, C, S.np[1], kQRows, ring,
                EpiResidual<ContigTile, ContigTile>{x, rows, y, rows, w(BO), sA, S.np[1] + 8, valid},
                1, blockIdx.x);
        consumers_sync();
        layer_norm(y, rows, valid, sB, kQRows, C, w(LN2S), w(LN2B));
        fence_async_smem();
        consumers_sync();
        gemm_np(sB, C, HID, S.np[2], kQRows, ring, EpiGelu{sA, w(B1), HID}, 2, blockIdx.x);
        fence_async_smem();
        consumers_sync();
        const int ld2 = S.np[3] + 8 <= C ? S.np[3] + 8 : S.np[3];
        gemm_np(sA, HID, C, S.np[3], kQRows, ring,
                EpiResidual<ContigTile, ContigTile>{y, rows, y, rows, w(B2), sB, ld2, valid}, 3,
                blockIdx.x);
      });
}

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1) block_long_attn_f32_kernel(const __grid_constant__ LongArgs A) {
  const Shape& S = A.sh;
  const int groups = S.C / 64;
  block_cta<float, AttnPlan<true>>(
      S, [&](Ring& ring) { produce_range<float>(A, ring, groups, groups + 3); },
      [&](Ring& ring, float* sA, float* sB, float* sKV) {
        const int C = S.C, HID = S.HID;
        const int s = blockIdx.x / A.qtiles, q0 = (blockIdx.x - s * A.qtiles) * kQRows;
        const int valid = min(kQRows, A.L - q0);
        const ContigTile rows{((size_t)s * A.L + q0) * C, C};
        for (int gi = 0; gi < groups; ++gi)
          attention_long_f32<D, SAFE>(A, s, gi, q0, valid, sA, sKV, sB, C);
        consumers_sync();  // the last group's output in place before the out-projection reads it
        const float* x = static_cast<const float*>(A.x);
        float* y = static_cast<float*>(A.y);
        auto w = [&](int k) { return static_cast<const float*>(A.p[k]); };
        gemm_f32_np(sB, C, C, S.np[1], valid, ring,
                    EpiResidualF<ContigTile, ContigTile>{x, rows, y, rows, w(BO), valid}, 1);
        consumers_sync();  // x' stored; the attention output is read no more
        layer_norm_f32(y, rows, valid, sB, C, w(LN2S), w(LN2B));
        consumers_sync();
        gemm_f32_np(sB, C, HID, S.np[2], valid, ring, EpiGeluF{sA, w(B1), ld_f(HID)}, 2);
        consumers_sync();
        gemm_f32_np(sA, HID, C, S.np[3], valid, ring,
                    EpiResidualF<ContigTile, ContigTile>{y, rows, y, rows, w(B2), valid}, 3);
      });
}

// ---- host side -------------------------------------------------------------------

// plan: the qkv entry's tile rows, its ring stages, the four column passes
// (q|k|v, out-projection, fc1, fc2), the attention entry's ring stages
// (ops/fused_block.py:long_plan).  Fills S for the entry (`attn`) and
// returns its shared memory bytes, 0 when the plan is outside the kernels.
long long long_shape(Shape& S, const int* plan, int C, int HID, bool f32, bool attn) {
  S.C = C;
  S.HID = HID;
  for (int i = 0; i < 4; ++i) S.np[i] = plan[2 + i];
  S.R = attn ? kQRows : plan[0];
  S.stages = attn ? plan[6] : plan[1];
  const int maxc = f32 ? kMaxCF : kMaxC;
  if (C % 64 || C < 64 || C > maxc || HID % 64 || HID < 64 || HID > 2 * C || S.stages < 2 ||
      S.stages > kMaxStages || S.np[0] != kQkvN || !np_ok(S.np[1], C) || !np_ok(S.np[2], HID) ||
      !np_ok(S.np[3], C))
    return 0;
  if (f32 && (S.np[1] > 128 || S.np[2] > 128 || S.np[3] > 128)) return 0;
  if (attn) return (long long)layout_attn(f32, C, HID, S.np, S.stages).total;
  if (f32 ? S.R != kRowsF : (S.R != 64 && (S.R != 128 || C > 256))) return 0;
  return (long long)layout_qkv(f32, S.R, C, S.stages).total;
}

// The checks both entries share; fills A.  0 = launch, else a cudaError_t
// (or -1: nothing to run).
int prepare(LongArgs& A, long long& smem, const void* const* w, const int* plan, int n_seqs,
            int L, int C, int HID, bool f32, bool attn, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  A = LongArgs{};
  smem = long_shape(A.sh, plan, C, HID, f32, attn);
  for (int k = 0; k < kNPtr; ++k) A.p[k] = w[k];
  return prepare_sizes(A, smem, n_seqs, L, device);
}

template <bool F32>
int launch_qkv(const void* x, void* ws, const void* const* w, const int* plan, int n_seqs, int L,
               int C, int HID, int device, void* stream) {
  LongArgs A;
  long long smem = 0;
  const int rc = prepare(A, smem, w, plan, n_seqs, L, C, HID, F32, false, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  A.x = x;
  A.ws = ws;
  const int grid = (A.tokens + A.sh.R - 1) / A.sh.R;
  if (F32) return launch_kernel(block_long_qkv_f32_kernel, A, grid, smem, stream);
  return launch_kernel(block_long_qkv_kernel, A, grid, smem, stream);
}

template <bool F32, int D, bool SAFE>
cudaError_t launch_attn_dt(const LongArgs& A, int grid, long long smem, void* stream) {
  if constexpr (F32)
    return launch_kernel(block_long_attn_f32_kernel<D, SAFE>, A, grid, smem, stream);
  else
    return launch_kernel(block_long_attn_kernel<D, SAFE>, A, grid, smem, stream);
}

template <bool F32, int D>
cudaError_t launch_attn_d(const LongArgs& A, int safe, int grid, long long smem, void* stream) {
  return safe ? launch_attn_dt<F32, D, true>(A, grid, smem, stream)
              : launch_attn_dt<F32, D, false>(A, grid, smem, stream);
}

template <bool F32>
int launch_attn(const void* x, const void* ws, void* y, const void* const* w, const int* plan,
                int n_seqs, int L, int C, int HID, int heads, int causal, int safe, int device,
                void* stream) {
  LongArgs A;
  long long smem = 0;
  const int rc = prepare(A, smem, w, plan, n_seqs, L, C, HID, F32, true, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  const int d = head_dim(C, heads);
  if (!d) return cudaErrorInvalidValue;
  A.x = x;
  A.ws = const_cast<void*>(ws);
  A.y = y;
  A.causal = causal ? 1 : 0;
  const int grid = n_seqs * A.qtiles;
  if (d == 16) return launch_attn_d<F32, 16>(A, safe, grid, smem, stream);
  if (d == 32) return launch_attn_d<F32, 32>(A, safe, grid, smem, stream);
  return launch_attn_d<F32, 64>(A, safe, grid, smem, stream);
}

}  // namespace

extern "C" {

// x: (S, L, C) bf16; ws: (3, S, C/64, L, 64) bf16, written.  w: the 9 device
// pointers of tante_fused_block_sm90_fwd (ln1_scale, ln1_bias, each head
// group's q|k|v bias with q prescaled, bo, ln2_scale, ln2_bias, b1, b2, the
// re-laid weights: ops/fused_block.py:sm90_weights).  plan: 7 ints
// (ops/fused_block.py:long_plan).  Returns a cudaError_t (0 = launched).
int tante_block_long_qkv_sm90_fwd(const void* x, void* ws, const void* const* w, const int* plan,
                                  int n_seqs, int L, int C, int HID, int device, void* stream) {
  return launch_qkv<false>(x, ws, w, plan, n_seqs, L, C, HID, device, stream);
}

// The same in f32 (f32 tensors, the f32 slab layout, C <= 256).
int tante_block_long_qkv_sm90_f32_fwd(const void* x, void* ws, const void* const* w,
                                      const int* plan, int n_seqs, int L, int C, int HID,
                                      int device, void* stream) {
  return launch_qkv<true>(x, ws, w, plan, n_seqs, L, C, HID, device, stream);
}

// x, y: (S, L, C) bf16 (y written); ws: the qkv entry's workspace of the same
// x; w, plan: as above.  causal: key <= query; safe: the "safe" softmax.
int tante_block_long_attn_sm90_fwd(const void* x, const void* ws, void* y, const void* const* w,
                                   const int* plan, int n_seqs, int L, int C, int HID, int heads,
                                   int causal, int safe, int device, void* stream) {
  return launch_attn<false>(x, ws, y, w, plan, n_seqs, L, C, HID, heads, causal, safe, device,
                            stream);
}

// The same in f32.
int tante_block_long_attn_sm90_f32_fwd(const void* x, const void* ws, void* y,
                                       const void* const* w, const int* plan, int n_seqs, int L,
                                       int C, int HID, int heads, int causal, int safe,
                                       int device, void* stream) {
  return launch_attn<true>(x, ws, y, w, plan, n_seqs, L, C, HID, heads, causal, safe, device,
                           stream);
}

// Shared memory bytes of each entry's plan (qkv, attention), 0 outside the
// kernels: the wrapper's long_smem mirrors this.
int tante_block_long_smem(const int* plan, int C, int HID, int f32, long long* bytes) {
  Shape S;
  bytes[0] = long_shape(S, plan, C, HID, f32 != 0, false);
  bytes[1] = long_shape(S, plan, C, HID, f32 != 0, true);
  return 0;
}

}  // extern "C"
