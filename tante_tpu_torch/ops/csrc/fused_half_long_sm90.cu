// The tensor-parallel attention half at sequences longer than a tile: one tp
// rank's head shard of a block on (S, L, C) at any L, as two kernels, each
// for bf16 and for f32 activations and weights, writing the rank's PRE-BIAS
// partial (S, L, C) for the caller's all-reduce.
//
//   partial = attn(ln1(x) [wq|wk|wv]_shard) wo_shard      (no bo, no residual)
//
// Replaces tante_tpu/ops/pallas_block.py fused_block_apply_tp (:890) ->
// _pallas_rowtile (:710, its pallas_call at :730): _attn_half_kernel (:696,
// _attn_half_body :544) at L > 64, where the halves of fused_half_sm90.cu /
// fused_half_sm90_f32.cu cannot hold whole sequences in a tile: TANTE's L
// (768 tokens at the flagship), X (192), A (3072) and channel C (256
// channels, 128 wide) blocks under a tp mesh.  The block's long entry
// (fused_block_long_sm90.cu) and the short halves meet here: the long
// entry's split after q|k|v and its streamed keys (long_sm90.cuh), on the
// short halves' padded shard and weight stream.
//
//   tante_attn_half_long_qkv_sm90[_f32]_fwd   LN1 over the full C of 64- or
//     128-row tiles of the (S*L, C) token matrix (sequences ignored), then
//     the q|k|v products of the shard's W/64 head groups (+ bias, q
//     prescaled by d^-0.5*log2(e) in the weights, rounded to the activation
//     type) into a workspace (3, S, W/64, L, 64).
//   tante_attn_half_long_attn_sm90[_f32]_fwd  one CTA per (sequence,
//     64-query tile): per head group the keys streamed as in the long
//     block's attention entry, then the out-projection (K = W, N = C) stored
//     as the partial, rounded once to the activation type (EpiPartial /
//     EpiPartialF): no bias, no residual, no MLP (_pallas_rowtile and
//     _xla_attn_half round it there too, pallas_block.py:735, 763).
//
// Widths.  A shard is CA = C/tp attention columns (local heads of d = 16, 32
// or 64), a multiple of 16; the wrapper pads it to W = the next multiple of
// 64 in the re-laid weights (ops/fused_block.py:half_long_weights, the short
// halves' layout: each group's (C x 192) q|k|v slabs, then wo's (W x C) with
// zero rows past CA).  A padded head's q, k and v are 0: its scores are 0,
// its weights finite (at most L of them summed, "fast" or "safe"), its
// values 0, so its output is exactly 0, and the zero rows of wo add exact
// zeros.  The kernels' Shape carries W as HID (the half has no MLP).
//
// Bound at the flagship's C block at tp 2 (24,576 sequences of L = 256
// channels, C = 128, CA = W = 64, bf16): q|k|v 2*tokens*C*3*CA, attention
// 4*tokens*L*CA, out-projection 2*tokens*CA*C: 824 GFLOP, 0.83 ms at 989
// TFLOP/s; bytes: x in, the partial out, the workspace written and read
// (3 W values a token each way): ~8 GB, 2.4 ms at 3.35 TB/s: bound by bytes,
// most of them the workspace's, which this split adds (chip_smoke.py
// computes the bound from each run's inputs: half_long_bounds).  What the
// design does about it: the block's long entry's (every projection on the
// tensor cores, the scores never in device memory, the workspace laid out so
// that a 64-key block of a head group is one contiguous run), with only the
// shard's W/64 groups projected and streamed.  Making it faster (one CTA per
// C sequence, wgmma attention) is the long entry's open work (ROADMAP).

#include "long_sm90.cuh"

namespace {

// The attention kernel: region a holds the q tile and two k|v stages during
// attention, then (bf16) the partial's staging tile (ld np[1] + 8); region b
// the 64 x W attention output; the ring of out-projection slabs; its barriers.
__host__ __device__ inline Layout layout_half_attn(bool f32, int W, int np1, int stages) {
  Layout l{};
  const size_t e = f32 ? 4 : 2;
  const size_t q = (size_t)kQRows * (f32 ? kQLdF : kQLd) * e;
  const size_t kv = (size_t)kKeyBlk * (f32 ? kKvLdF : kKvLd) * e;
  const size_t stage = f32 ? 0 : (size_t)kQRows * (np1 + 8) * 2;
  const size_t a = stage > q + 2 * kv ? stage : q + 2 * kv;
  const size_t b = f32 ? (size_t)kQRows * ld_f(W) * 4 : (size_t)kQRows * W * 2;
  l.qkv = q;  // the k|v stages
  l.b = align128(a);
  l.ring = align128(l.b + b);
  l.bars = l.ring + (size_t)stages * (f32 ? kSlabKF : kSlabK) * np1 * e;
  l.total = l.bars + 2 * kMaxStages * sizeof(uint64_t);
  return l;
}

// The attention kernel's layout (block_cta's Plan); S.HID is W.
template <bool F32>
struct HalfAttnPlan {
  __device__ static Layout layout(const Shape& S) {
    return layout_half_attn(F32, S.HID, S.np[1], S.stages);
  }
  __device__ static int stage_bytes(const Shape& S) {
    return (F32 ? kSlabKF * 4 : kSlabK * 2) * S.np[1];
  }
};

// The out-projection's slabs (K = W, N = C: C / np[1] passes of W / slab_k
// slabs each), which follow the W/64 groups' q|k|v slabs (C x 192 each) in
// the re-laid weights.
template <class T>
__device__ __forceinline__ void produce_proj(const LongArgs& A, Ring& ring) {
  constexpr int SK = Elem<T>::slab_k, E = Elem<T>::bytes;
  const Shape& S = A.sh;
  const unsigned char* src = static_cast<const unsigned char*>(A.p[WARR]) +
                             (size_t)(S.HID / 64) * S.C * kQkvN * E;
  const uint32_t bytes = (uint32_t)SK * S.np[1] * E;
  const int n = (S.C / S.np[1]) * (S.HID / SK);
  for (int i = 0; i < n; ++i, src += bytes) {
    const int s = i % ring.stages;
    if (i >= ring.stages) mbar_wait(&ring.empty[s], ((i / ring.stages) - 1) & 1);
    mbar_expect_tx(&ring.full[s], bytes);
    bulk_load(ring.base + (size_t)s * ring.stage_bytes, src, bytes, &ring.full[s]);
  }
}

// ---- the qkv kernels: long_sm90.cuh's body over the shard's W/64 groups ------------

__global__ void __launch_bounds__(kThreads, 1) half_long_qkv_kernel(const __grid_constant__ LongArgs A) {
  long_qkv<true>(A);
}

__global__ void __launch_bounds__(kThreads, 1) half_long_qkv_f32_kernel(const __grid_constant__ LongArgs A) {
  long_qkv_f32<true>(A);
}

// ---- the attention kernels ------------------------------------------------------------

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1) half_long_attn_kernel(const __grid_constant__ LongArgs A) {
  const Shape& S = A.sh;
  block_cta<bf16, HalfAttnPlan<false>>(
      S, [&](Ring& ring) { produce_proj<bf16>(A, ring); },
      [&](Ring& ring, bf16* sA, bf16* sB, bf16* sKV) {
        const int C = S.C, W = S.HID;
        const int s = blockIdx.x / A.qtiles, q0 = (blockIdx.x - s * A.qtiles) * kQRows;
        const int valid = min(kQRows, A.L - q0);
        const ContigTile rows{((size_t)s * A.L + q0) * C, C};
        for (int gi = 0; gi < W / 64; ++gi)
          attention_long<D, SAFE>(A, s, gi, q0, valid, sA, sKV, sB, W);
        fence_async_smem();
        consumers_sync();
        // bf16(attn wo), staged in region a (the k|v stages are read no more).
        gemm_np(sB, W, C, S.np[1], kQRows, ring,
                EpiPartial<ContigTile>{static_cast<bf16*>(A.y), rows, sA, S.np[1] + 8, valid}, 1,
                blockIdx.x);
      });
}

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1) half_long_attn_f32_kernel(const __grid_constant__ LongArgs A) {
  const Shape& S = A.sh;
  block_cta<float, HalfAttnPlan<true>>(
      S, [&](Ring& ring) { produce_proj<float>(A, ring); },
      [&](Ring& ring, float* sA, float* sB, float* sKV) {
        const int C = S.C, W = S.HID;
        const int s = blockIdx.x / A.qtiles, q0 = (blockIdx.x - s * A.qtiles) * kQRows;
        const int valid = min(kQRows, A.L - q0);
        const ContigTile rows{((size_t)s * A.L + q0) * C, C};
        for (int gi = 0; gi < W / 64; ++gi)
          attention_long_f32<D, SAFE>(A, s, gi, q0, valid, sA, sKV, sB, W);
        consumers_sync();  // the last group's output in place before the out-projection reads it
        gemm_f32_np(sB, W, C, S.np[1], valid, ring,
                    EpiPartialF<ContigTile>{static_cast<float*>(A.y), rows, valid}, 1);
      });
}

// ---- host side -------------------------------------------------------------------

// plan: the qkv kernel's tile rows, its ring stages, W (the shard's width
// padded to whole 64-column groups), the q|k|v and out-projection column
// passes, the attention kernel's ring stages (ops/fused_block.py:
// half_long_plan).  Fills S for the kernel (`attn`; S.HID = W) and returns
// its shared memory bytes, 0 when the plan is outside the kernels.
long long half_long_shape(Shape& S, const int* plan, int C, int CA, bool f32, bool attn) {
  const int W = plan[2];
  S.C = C;
  S.HID = W;
  S.np[0] = plan[3];
  S.np[1] = S.np[2] = S.np[3] = plan[4];
  S.R = attn ? kQRows : plan[0];
  S.stages = attn ? plan[5] : plan[1];
  const int maxc = f32 ? kMaxCF : kMaxC;
  if (C % 64 || C < 64 || C > maxc || CA < 16 || CA % 16 || W % 64 || W < CA || W - CA >= 64 ||
      W > C || S.stages < 2 || S.stages > kMaxStages || S.np[0] != kQkvN ||
      !np_ok(S.np[1], C) || (f32 && S.np[1] > 128))
    return 0;
  if (attn) return (long long)layout_half_attn(f32, W, S.np[1], S.stages).total;
  if (f32 ? S.R != kRowsF : (S.R != 64 && (S.R != 128 || C > 256))) return 0;
  return (long long)layout_qkv(f32, S.R, C, S.stages).total;
}

// The checks both kernels share; fills A.  w: the 4 device pointers of the
// shard's re-laid weights (ln1_scale, ln1_bias, each head group's q|k|v bias,
// the slabs).  0 = launch, else a cudaError_t (or -1: nothing to run).
int prepare_half(LongArgs& A, long long& smem, const void* const* w, const int* plan,
                 int n_seqs, int L, int C, int CA, bool f32, bool attn, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  A = LongArgs{};
  smem = half_long_shape(A.sh, plan, C, CA, f32, attn);
  A.p[LN1S] = w[0];
  A.p[LN1B] = w[1];
  A.p[BQKV] = w[2];
  A.p[WARR] = w[3];
  return prepare_sizes(A, smem, n_seqs, L, device);
}

template <bool F32>
int launch_half_qkv(const void* x, void* ws, const void* const* w, const int* plan, int n_seqs,
                    int L, int C, int CA, int device, void* stream) {
  LongArgs A;
  long long smem = 0;
  const int rc = prepare_half(A, smem, w, plan, n_seqs, L, C, CA, F32, false, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  A.x = x;
  A.ws = ws;
  const int grid = (A.tokens + A.sh.R - 1) / A.sh.R;
  if (F32) return launch_kernel(half_long_qkv_f32_kernel, A, grid, smem, stream);
  return launch_kernel(half_long_qkv_kernel, A, grid, smem, stream);
}

template <bool F32, int D>
cudaError_t launch_half_attn_d(const LongArgs& A, int safe, int grid, long long smem,
                               void* stream) {
  if constexpr (F32)
    return safe ? launch_kernel(half_long_attn_f32_kernel<D, true>, A, grid, smem, stream)
                : launch_kernel(half_long_attn_f32_kernel<D, false>, A, grid, smem, stream);
  else
    return safe ? launch_kernel(half_long_attn_kernel<D, true>, A, grid, smem, stream)
                : launch_kernel(half_long_attn_kernel<D, false>, A, grid, smem, stream);
}

template <bool F32>
int launch_half_attn(const void* ws, void* y, const void* const* w, const int* plan, int n_seqs,
                     int L, int C, int CA, int heads, int causal, int safe, int device,
                     void* stream) {
  LongArgs A;
  long long smem = 0;
  const int rc = prepare_half(A, smem, w, plan, n_seqs, L, C, CA, F32, true, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  const int d = head_dim(CA, heads);
  if (!d) return cudaErrorInvalidValue;
  A.ws = const_cast<void*>(ws);
  A.y = y;
  A.causal = causal ? 1 : 0;
  const int grid = n_seqs * A.qtiles;
  if (d == 16) return launch_half_attn_d<F32, 16>(A, safe, grid, smem, stream);
  if (d == 32) return launch_half_attn_d<F32, 32>(A, safe, grid, smem, stream);
  return launch_half_attn_d<F32, 64>(A, safe, grid, smem, stream);
}

}  // namespace

extern "C" {

// x: (S, L, C) bf16; ws: (3, S, W/64, L, 64) bf16, written.  w: host array of
// the 4 device pointers above (ops/fused_block.py:half_long_weights: q|k|v
// biases zero past CA, q's prescaled).  CA: the shard's attention width.
// plan: 6 ints (ops/fused_block.py:half_long_plan).  Returns a cudaError_t
// (0 = launched).
int tante_attn_half_long_qkv_sm90_fwd(const void* x, void* ws, const void* const* w,
                                      const int* plan, int n_seqs, int L, int C, int CA,
                                      int device, void* stream) {
  return launch_half_qkv<false>(x, ws, w, plan, n_seqs, L, C, CA, device, stream);
}

// The same in f32 (f32 tensors, the f32 slab layout, C <= 256).
int tante_attn_half_long_qkv_sm90_f32_fwd(const void* x, void* ws, const void* const* w,
                                          const int* plan, int n_seqs, int L, int C, int CA,
                                          int device, void* stream) {
  return launch_half_qkv<true>(x, ws, w, plan, n_seqs, L, C, CA, device, stream);
}

// ws: the qkv kernel's workspace; y: (S, L, C) bf16, the rank's pre-bias
// partial, written.  w, plan, CA: as above; `heads` the shard's local heads.
// causal: key <= query; safe: the "safe" softmax.
int tante_attn_half_long_attn_sm90_fwd(const void* ws, void* y, const void* const* w,
                                       const int* plan, int n_seqs, int L, int C, int CA,
                                       int heads, int causal, int safe, int device,
                                       void* stream) {
  return launch_half_attn<false>(ws, y, w, plan, n_seqs, L, C, CA, heads, causal, safe, device,
                                 stream);
}

// The same in f32.
int tante_attn_half_long_attn_sm90_f32_fwd(const void* ws, void* y, const void* const* w,
                                           const int* plan, int n_seqs, int L, int C, int CA,
                                           int heads, int causal, int safe, int device,
                                           void* stream) {
  return launch_half_attn<true>(ws, y, w, plan, n_seqs, L, C, CA, heads, causal, safe, device,
                                stream);
}

// Shared memory bytes of each kernel's plan (qkv, attention), 0 outside the
// kernels: the wrapper's half_long_smem mirrors this.
int tante_attn_half_long_smem(const int* plan, int C, int CA, int f32, long long* bytes) {
  Shape S;
  bytes[0] = half_long_shape(S, plan, C, CA, f32 != 0, false);
  bytes[1] = half_long_shape(S, plan, C, CA, f32 != 0, true);
  return 0;
}

}  // extern "C"
