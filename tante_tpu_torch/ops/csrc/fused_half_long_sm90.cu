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
// entry's split after q|k|v, its qkv body and its attention design
// (long_sm90.cuh), on the short halves' padded shard and weight stream.
//
//   tante_attn_half_long_qkv_sm90[_f32]_fwd   LN1 over the full C of 64- or
//     128-row tiles of the (S*L, C) token matrix (sequences ignored), then
//     the q|k|v products of the shard's W/64 head groups (+ bias, q
//     prescaled by d^-0.5*log2(e) in the weights, rounded to the activation
//     type) into a workspace (3, S, W/64, L, 64).
//   tante_attn_half_long_attn_sm90[_f32]_fwd  the long block's attention
//     entry over the shard's W/64 head groups (long_sm90.cuh: a persistent
//     grid over work items of R query rows, R = 128 in bf16 (two consumer
//     warpgroups; pair items of 64 rows past the grid's last whole wave) and
//     64 in f32; producer warps feeding q and k|v through an mbarrier ring;
//     bf16 QK^T on wgmma, f32 as 3xTF32), whose tail is the out-projection
//     (K = W, N = C) alone, stored as the partial rounded once to the
//     activation type (EpiPartial / EpiPartialF): no bias, no residual, no
//     MLP (_pallas_rowtile and _xla_attn_half round it there too,
//     pallas_block.py:735, 763).  wo's slabs stream once per item (bf16: per
//     128 rows).  The first design (one CTA per sequence and 64-query tile,
//     745 waves at the C block, k|v staged per tile behind two CTA barriers
//     a key block, f32 on FFMA) was 2.7-3.9x slower at C and A (PERF.md).
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
// computes the bound from each run's inputs: half_long_bounds).  What bounds
// the attention kernel, and what is left, is in long_sm90.cuh's header.

#include "long_sm90.cuh"

namespace {

// The attention kernel's shared memory (an AttnLayout): the attention output
// ao (R x W); the tail's tile h, in bf16 the partial's staging tile (ld
// np[1] + 8), at least a pair item's exchange area (live only during an
// item's attention, the staging tile only in its tail), none in f32
// (EpiPartialF stores to device memory); the q slots and the k|v ring, apart
// from both (so the next item's copies run under this item's tail); the
// ring of out-projection slabs; the barriers.
__host__ __device__ inline AttnLayout layout_half_attn(bool f32, int W, int np1, int stages,
                                                       const AttnPlan& P) {
  AttnLayout l{};
  const size_t ao = f32 ? (size_t)P.R * ld_f(W) * 4 : (size_t)P.R * W * 2;
  size_t h = 0;
  if (!f32) {
    h = (size_t)P.R * (np1 + 8) * 2;
    h = h > (size_t)kPairScratch ? h : (size_t)kPairScratch;
  }
  l.ao = 0;
  l.h = align128(ao);
  l.x = align128(l.h + h);
  l.q = l.x;
  l.kv = align128(l.q + (size_t)P.qs * q_bytes(f32, P.R));
  l.ring = align128(l.kv + (size_t)P.kv * kv_bytes(f32));
  l.bars = l.ring + (size_t)stages * (f32 ? kSlabKF * 4 : kSlabK * 2) * np1;
  l.total = l.bars + kAttnBars * sizeof(uint64_t);
  return l;
}

// The attention kernel's layout and weight stream (attn_cta's Tail): per
// item the out-projection's slabs (K = W, N = C: C / np[1] passes of
// W / slab_k slabs each), which follow the W/64 groups' q|k|v slabs (C x 192
// each) in the re-laid weights; idx counts the slabs streamed so far, so the
// ring's phase parity carries across items.
struct HalfTail {
  __device__ static AttnLayout layout(bool f32, const Shape& S, const AttnPlan& AP) {
    return layout_half_attn(f32, S.HID, S.np[1], S.stages, AP);
  }
  __device__ static int stage_bytes(bool f32, const Shape& S) {
    return (f32 ? kSlabKF * 4 : kSlabK * 2) * S.np[1];
  }
  template <class T>
  __device__ static void weights(const LongArgs& A, const AttnPlan& AP, Ring& ring, int items) {
    constexpr int SK = Elem<T>::slab_k, E = Elem<T>::bytes;
    const Shape& S = A.sh;
    const unsigned char* proj = static_cast<const unsigned char*>(A.p[WARR]) +
                                (size_t)(S.HID / 64) * S.C * kQkvN * E;
    const uint32_t bytes = (uint32_t)SK * S.np[1] * E;
    const int n = (S.C / S.np[1]) * (S.HID / SK);
    int idx = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      if (item_at(A, AP, it).valid <= 0) continue;
      const unsigned char* src = proj;
      for (int i = 0; i < n; ++i, ++idx, src += bytes) {
        const int s = idx % ring.stages;
        if (idx >= ring.stages) mbar_wait(&ring.empty[s], ((idx / ring.stages) - 1) & 1);
        mbar_expect_tx(&ring.full[s], bytes);
        bulk_load(ring.base + (size_t)s * ring.stage_bytes, src, bytes, &ring.full[s]);
      }
    }
  }
};

// ---- the qkv kernels: long_sm90.cuh's body over the shard's W/64 groups ------------

__global__ void __launch_bounds__(kThreads, 1)
    half_long_qkv_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ QkvPlan P) {
  qkv_cta<false, true>(A, P);
}

__global__ void __launch_bounds__(kThreads, 1)
    half_long_qkv_f32_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ QkvPlan P) {
  qkv_cta<true, true>(A, P);
}

// ---- the attention kernels: long_sm90.cuh's attention over the W/64 groups -------

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
    half_long_attn_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ AttnPlan AP) {
  attn_cta<bf16, SAFE ? 2 : 1, true, HalfTail>(
      A, AP, [&](const Item& it, Ring& ring, Pipe& P, bf16* ao, bf16* h, bf16*) {
        const Shape& S = A.sh;
        const int C = S.C, W = S.HID;
        for (int gi = 0; gi < W / 64; ++gi)
          attention_wg<D, SAFE, true>(A, it, gi, P, ao, reinterpret_cast<float*>(h));
        LCLK(t0);
        fence_async_smem();  // the attention output (generic stores) before wgmma reads it
        consumers_sync();
        LCLK(t1);
        LADD(PH_BETWEEN, t1 - t0);
        // bf16(attn wo), staged in h (the exchange area is free again).
        const ContigTile rows{((size_t)it.s * A.L + it.q0) * C, C};
        gemm_np(ao, W, C, S.np[1], it.rows, ring,
                EpiPartial<ContigTile>{static_cast<bf16*>(A.y), rows, h, S.np[1] + 8, it.valid},
                1, blockIdx.x);
        LCLK(t2);
        LADD(PH_TAIL, t2 - t1);
      });
}

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
    half_long_attn_f32_kernel(const __grid_constant__ LongArgs A,
                              const __grid_constant__ AttnPlan AP) {
  attn_cta<float, SAFE ? 2 : 1, true, HalfTail>(
      A, AP, [&](const Item& it, Ring& ring, Pipe& P, float* ao, float*, float*) {
        const Shape& S = A.sh;
        const int C = S.C, W = S.HID;
        for (int gi = 0; gi < W / 64; ++gi) attention_f32<D, SAFE, true>(A, it, gi, P, ao);
        LCLK(t0);
        consumers_sync();  // the attention output in place before the out-projection reads it
        LCLK(t1);
        LADD(PH_BETWEEN, t1 - t0);
        const ContigTile rows{((size_t)it.s * A.L + it.q0) * C, C};
        gemm_f32_np(ao, W, C, S.np[1], it.valid, ring,
                    EpiPartialF<ContigTile>{static_cast<float*>(A.y), rows, it.valid}, 1,
                    blockIdx.x);
        consumers_sync();  // no warp reads the attention output when the next item writes it
        LCLK(t2);
        LADD(PH_TAIL, t2 - t1);
      });
}

// ---- host side -------------------------------------------------------------------

// plan: the qkv kernel's tile rows, its ring stages (0: the weights
// resident), W (the shard's width padded to whole 64-column groups), the
// q|k|v and out-projection column passes, the attention kernel's weight
// ring stages, its item rows, k|v stages and q slots, the qkv kernel's
// staging buffers and split (ops/fused_block.py:half_long_plan).  Fills S (and AP)
// for the kernel (`attn`; S.HID = W) and returns its shared memory bytes, 0
// when the plan is outside the kernels.
long long half_long_shape(Shape& S, AttnPlan& AP, const int* plan, int C, int CA, bool f32,
                          bool attn) {
  const int W = plan[2];
  S.C = C;
  S.HID = W;
  S.np[0] = plan[3];
  S.np[1] = S.np[2] = S.np[3] = plan[4];
  S.R = attn ? plan[6] : plan[0];
  S.stages = attn ? plan[5] : plan[1];
  AP = AttnPlan{plan[6], plan[7], plan[8], 0, 0};
  const int maxc = f32 ? kMaxCF : kMaxC;
  if (C % 64 || C < 64 || C > maxc || CA < 16 || CA % 16 || W % 64 || W < CA || W - CA >= 64 ||
      W > C || S.np[0] != kQkvN || !np_ok(S.np[1], C) || (f32 && S.np[1] > 128))
    return 0;
  if (attn) {
    if (S.stages < 2 || S.stages > kMaxStages || (f32 ? AP.R != kRowsF : AP.R != 64 && AP.R != 128) ||
        AP.kv < 2 || AP.kv > kMaxKv || AP.qs < 1 || AP.qs > kMaxQ)
      return 0;
    return (long long)layout_half_attn(f32, W, S.np[1], S.stages, AP).total;
  }
  return qkv_smem(S, W, plan[9], plan[10], f32);
}

// The checks both kernels share; fills A (and AP).  w: the 4 device pointers
// of the shard's re-laid weights (ln1_scale, ln1_bias, each head group's
// q|k|v bias, the slabs).  0 = launch, else a cudaError_t (or -1: nothing to
// run).
int prepare_half(LongArgs& A, AttnPlan& AP, long long& smem, const void* const* w,
                 const int* plan, int n_seqs, int L, int C, int CA, bool f32, bool attn,
                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  A = LongArgs{};
  smem = half_long_shape(A.sh, AP, plan, C, CA, f32, attn);
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
  AttnPlan AP;
  long long smem = 0;
  const int rc = prepare_half(A, AP, smem, w, plan, n_seqs, L, C, CA, F32, false, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  A.x = x;
  A.ws = ws;
  const QkvPlan P{plan[9], (A.tokens + A.sh.R - 1) / A.sh.R, plan[10]};
  const int grid = attn_grid(P.tiles, device);  // one CTA per SM
  if (F32) return launch_qkv_kernel(half_long_qkv_f32_kernel, A, P, grid, smem, stream);
  return launch_qkv_kernel(half_long_qkv_kernel, A, P, grid, smem, stream);
}

template <bool F32, int D>
cudaError_t launch_half_attn_d(const LongArgs& A, const AttnPlan& AP, int safe, int grid,
                               long long smem, void* stream) {
  if constexpr (F32)
    return safe ? launch_attn_kernel(half_long_attn_f32_kernel<D, true>, A, AP, grid, smem, stream)
                : launch_attn_kernel(half_long_attn_f32_kernel<D, false>, A, AP, grid, smem,
                                     stream);
  else
    return safe ? launch_attn_kernel(half_long_attn_kernel<D, true>, A, AP, grid, smem, stream)
                : launch_attn_kernel(half_long_attn_kernel<D, false>, A, AP, grid, smem, stream);
}

// The attention kernel's tiles, big tiles and items on n_seqs sequences of
// L (AP from half_long_shape); A.qtiles the tiles of a sequence.  The grid:
// attn_grid of the items.
int half_attn_work(LongArgs& A, AttnPlan& AP, bool f32, int n_seqs, int L, int device) {
  if ((long long)n_seqs * ((L + AP.R - 1) / AP.R) * 2 >= (1ll << 31)) return cudaErrorInvalidValue;
  A.qtiles = (L + AP.R - 1) / AP.R;
  AP.tiles = n_seqs * A.qtiles;
  AP.big = pair_items(AP, f32, device);
  return cudaSuccess;
}

template <bool F32>
int launch_half_attn(const void* ws, void* y, const void* const* w, const int* plan, int n_seqs,
                     int L, int C, int CA, int heads, int causal, int safe, int device,
                     void* stream) {
  LongArgs A;
  AttnPlan AP;
  long long smem = 0;
  int rc = prepare_half(A, AP, smem, w, plan, n_seqs, L, C, CA, F32, true, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  const int d = head_dim(CA, heads);
  if (!d) return cudaErrorInvalidValue;
  if ((rc = half_attn_work(A, AP, F32, n_seqs, L, device))) return rc;
  A.ws = const_cast<void*>(ws);
  A.y = y;
  A.causal = causal ? 1 : 0;
  const int grid = attn_grid(attn_items(AP), device);
  if (d == 16) return launch_half_attn_d<F32, 16>(A, AP, safe, grid, smem, stream);
  if (d == 32) return launch_half_attn_d<F32, 32>(A, AP, safe, grid, smem, stream);
  return launch_half_attn_d<F32, 64>(A, AP, safe, grid, smem, stream);
}

}  // namespace

extern "C" {

// x: (S, L, C) bf16; ws: (3, S, W/64, L, 64) bf16, written.  w: host array of
// the 4 device pointers above (ops/fused_block.py:half_long_weights: q|k|v
// biases zero past CA, q's prescaled).  CA: the shard's attention width.
// plan: 11 ints (ops/fused_block.py:half_long_plan).  Returns a cudaError_t
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
  AttnPlan AP;
  bytes[0] = half_long_shape(S, AP, plan, C, CA, f32 != 0, false);
  bytes[1] = half_long_shape(S, AP, plan, C, CA, f32 != 0, true);
  return 0;
}

// The attention kernel's work on n_seqs sequences of L under `plan` on the
// device: out = its R-row tiles, the big ones (one item each; the others two
// pair items each), its items and its grid.  Returns a cudaError_t.
int tante_attn_half_long_attn_items(const int* plan, int n_seqs, int L, int C, int CA, int f32,
                                    int device, int* out) {
  Shape S;
  AttnPlan AP;
  LongArgs A{};
  if (!half_long_shape(S, AP, plan, C, CA, f32 != 0, true) || L < 1 || n_seqs < 1)
    return cudaErrorInvalidValue;
  const int rc = half_attn_work(A, AP, f32 != 0, n_seqs, L, device);
  if (rc) return rc;
  out[0] = AP.tiles;
  out[1] = AP.big;
  out[2] = attn_items(AP);
  out[3] = attn_grid(out[2], device);
  return cudaSuccess;
}

#ifdef TANTE_PHASE_TIMING
int tante_attn_half_long_qkv_phase_count() { return kQkvPhases; }
// Copies (and zeroes) the qkv kernel's phase cycles of the first n CTAs (n x
// kQkvPhases values, see g_qkv_cycles).
int tante_attn_half_long_qkv_phase_read(unsigned long long* host, int n) {
  if (n > kPhaseSlots) n = kPhaseSlots;
  const size_t bytes = sizeof(unsigned long long) * kQkvPhases * n;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_qkv_cycles, bytes);
  if (err != cudaSuccess) return err;
  static unsigned long long zeros[kPhaseSlots * kQkvPhases];
  return cudaMemcpyToSymbol(g_qkv_cycles, zeros, bytes);
}
int tante_attn_half_long_phase_count() { return kLongPhases; }
// Copies (and zeroes) the attention kernel's phase cycles of the first n CTAs
// (n x kLongPhases values, see g_long_cycles).
int tante_attn_half_long_phase_read(unsigned long long* host, int n) {
  if (n > kPhaseSlots) n = kPhaseSlots;
  const size_t bytes = sizeof(unsigned long long) * kLongPhases * n;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_long_cycles, bytes);
  if (err != cudaSuccess) return err;
  static unsigned long long zeros[kPhaseSlots * kLongPhases];
  return cudaMemcpyToSymbol(g_long_cycles, zeros, bytes);
}
#endif

}  // extern "C"
