// The two tensor-parallel halves of one block on the Hopper block body
// (block_sm90.cuh): a tp rank's head shard and hidden shard, each writing
// the rank's PRE-BIAS partial (rows, C) in bf16 for the caller's all-reduce.
//
//   tante_attn_half_sm90_fwd   rows of (S, L, C), whole sequences per tile:
//     LN1; per 64-column head group of the shard (W / 64 of them) one
//     m64n192 q|k|v projection and attention_group; the out-projection
//     (K = W, N = C) stored bf16(acc) with no bias and no residual
//     (EpiPartial).
//   tante_mlp_half_sm90_fwd    rows of (M, C), independent: LN2; fc1
//     (N = W) + b1 + tanh-GELU (EpiGelu); fc2 (K = W, N = C) through
//     EpiPartial.
//
// Replace tante_tpu/ops/pallas_block.py fused_block_apply_tp (:890) ->
// _pallas_rowtile (:730): _attn_half_kernel (:696; _attn_half_body with
// q_prescaled=True, both softmax forms, a template flag as in the block)
// and _mlp_half_kernel (:704).
//
// Widths.  A shard is CA = C/tp attention columns (local heads of d = 16,
// 32 or 64) and HL = hidden/tp MLP columns, each a multiple of 16.  The
// body's column passes and head groups are 64 wide, so the wrapper pads a
// shard to W = the next multiple of 64 in the re-laid weights
// (ops/fused_block.py:half_weights): zero columns of wq/wk/wv/w1 and zero
// biases, zero rows of wo/w2.  A padded head's q, k and v are 0, so its
// output is 0; GELU(0) = 0; the zero rows add exact zeros to the f32 sums.
// So a 32-wide shard (tp = 8 at the flagship) runs the 64-wide tile, and so
// does a 16-wide one (the 128-wide channel block at tp 8: one head of 16 and
// three zero heads, 16 live MLP columns and 48 zero ones).
//
// Bound at the flagship's tp = 2 H block (M = 24576 rows, C = 256, CA = HL
// = 128): ~25 MB of device memory (x in, the partial out; weights 0.2 MB)
// -> ~7.5 us at 3.35 TB/s, against 6.6 GFLOP (attention) / 3.2 GFLOP (MLP)
// -> 6.7 / 3.3 us at 989 TFLOP/s dense bf16: bound by bytes.
//
// What the design does about it (the first design, fused_block.cu
// attn_half_kernel / mlp_half_kernel, ran wmma at ~1.1 TFLOP/s per SM on
// 48-64-row tiles, per-warp weight rings re-reading the shard from L2 per
// tile, three separate q, k, v matmuls, f32 FMA attention at L = 4, and two
// prescale kernels per launch): 128-row tiles (64 when C > 256) of whole
// sequences, every matmul wgmma from shared memory, one producer thread
// streaming the re-laid slabs with cp.async.bulk into an mbarrier ring, the
// attention on tensor cores in registers, q prescaled in the weights
// (re-laid once per weight version).  The grid is persistent:
// min(tiles, resident CTAs) CTAs walk the tiles, and the producer streams
// the next tile's slabs while the consumers finish the current one (one CTA
// per tile and 64-row tiles with two CTAs per SM were slower on the card:
// the schedule table in PERF.md).  Numerics are the block body's: q/k/v, the attention
// output and the fc1 output rounded to bf16; LayerNorm, softmax, GELU and
// every accumulator f32; the partial rounded once.

#include "block_sm90.cuh"

namespace {

// One half launch.  The MLP half is sequences of L = 1 (seqs = R rows a tile).
struct HalfArgs {
  const bf16* x;
  bf16* y;
  const bf16* ln_s;
  const bf16* ln_b;
  const bf16* bias;  // attention: each head group's bq (prescaled) | bk | bv; MLP: b1 (W wide)
  const unsigned char* slabs;
  int C, W, R, stages, np[2];  // np: q|k|v or fc1; out-projection or fc2
  int L, causal, n_seqs, seqs, tiles;
};

struct HalfLayout {
  size_t a, qkv, b, ring, bars, total;  // byte offsets
};

// a: the LayerNorm output (R x C; the MLP half stages fc2's partial there);
// qkv (attention): one group's q|k|v, then the out-projection's staging;
// b: the attention output or the fc1 output (R x W); the slab ring.
__host__ __device__ inline HalfLayout half_layout(bool attn, int R, int C, int W, int stages,
                                                  int max_np) {
  HalfLayout l;
  l.a = 0;
  l.qkv = (size_t)R * C * 2;
  l.b = l.qkv + (attn ? (size_t)R * kQkvLd * 2 : 0);
  l.ring = l.b + (size_t)R * W * 2;
  l.bars = l.ring + (size_t)stages * kSlabK * max_np * 2;
  l.total = l.bars + 2 * kMaxStages * sizeof(uint64_t);
  return l;
}

// One tile's share of the weight stream, in the consumers' order: per head
// group its (C x 192) q|k|v slabs, then the (W x C) out-projection's; or
// fc1's (C x W), then fc2's (W x C).  idx carries the ring's phase across
// tiles.
__device__ __forceinline__ void produce_half(const HalfArgs& A, bool attn, Ring& ring, int& idx) {
  const unsigned char* src = A.slabs;
  const int n_mm = attn ? A.W / 64 + 1 : 2;
  for (int m = 0; m < n_mm; ++m) {
    const int last = m == n_mm - 1;
    const int K = last ? A.W : A.C;
    const int N = last ? A.C : attn ? kQkvN : A.W;
    const int np = A.np[last];
    const uint32_t bytes = (uint32_t)kSlabK * np * 2;
    const int n = (N / np) * (K / kSlabK);
    for (int i = 0; i < n; ++i, ++idx, src += bytes) {
      const int s = idx % ring.stages;
      if (idx >= ring.stages) mbar_wait(&ring.empty[s], ((idx / ring.stages) - 1) & 1);
      mbar_expect_tx(&ring.full[s], bytes);
      bulk_load(ring.base + (size_t)s * ring.stage_bytes, src, bytes, &ring.full[s]);
    }
  }
}

// The attention half on one tile (consumer warpgroups).  Phase stamps (slot
// = tile): start, LN1, per group its projection and attention, then the
// out-projection at kStamps - 4.
template <int D, bool SAFE>
__device__ __forceinline__ void attn_half_tile(const HalfArgs& A, int tile, Ring& ring, bf16* sA,
                                               bf16* sQkv, bf16* sB) {
  const int slot = tile;
  [[maybe_unused]] const bool stamp = true;
  const int R = A.R, C = A.C, W = A.W;
  const int seq0 = tile * A.seqs, valid = min(A.seqs, A.n_seqs - seq0) * A.L;
  const ContigTile rows{(size_t)seq0 * A.L * C, C};
  STAMP(0);
  layer_norm(A.x, rows, valid, sA, R, C, A.ln_s, A.ln_b);
  fence_async_smem();
  consumers_sync();
  STAMP(1);
  for (int gi = 0; gi < W / 64; ++gi) {
    gemm_np(sA, C, kQkvN, A.np[0], R, ring, EpiQkv{sQkv, A.bias + gi * kQkvN}, 0, slot);
    STAMP(2 + 2 * gi);
    consumers_sync();
    attention_group<D, SAFE>(sQkv, sB, gi, valid, A.L, W, A.causal, R);
    consumers_sync();  // the next group's projection overwrites q|k|v
    STAMP(3 + 2 * gi);
  }
  fence_async_smem();
  consumers_sync();
  // The partial, staged in the q|k|v tile (free now).
  gemm_np(sB, W, C, A.np[1], R, ring, EpiPartial<ContigTile>{A.y, rows, sQkv, A.np[1] + 8, valid},
          1, slot);
#ifdef TANTE_PHASE_TIMING
  consumers_sync();
  STAMP(kStamps - 4);
#endif
}

// The MLP half on one tile of R rows.  Stamps: start, LN2, fc1, fc2.
__device__ __forceinline__ void mlp_half_tile(const HalfArgs& A, int tile, Ring& ring, bf16* sA,
                                              bf16* sH) {
  const int slot = tile;
  [[maybe_unused]] const bool stamp = true;
  const int R = A.R, C = A.C, W = A.W;
  const int row0 = tile * R, valid = min(R, A.n_seqs - row0);
  const ContigTile rows{(size_t)row0 * C, C};
  STAMP(0);
  layer_norm(A.x, rows, valid, sA, R, C, A.ln_s, A.ln_b);
  fence_async_smem();
  consumers_sync();
  STAMP(1);
  gemm_np(sA, C, W, A.np[0], R, ring, EpiGelu{sH, A.bias, W}, 2, slot);
  fence_async_smem();
  consumers_sync();
  STAMP(2);
  // The partial, staged in the LN2 output (free once fc1 has read it).
  const int ld = A.np[1] + 8 <= C ? A.np[1] + 8 : A.np[1];
  gemm_np(sH, W, C, A.np[1], R, ring, EpiPartial<ContigTile>{A.y, rows, sA, ld, valid}, 3, slot);
#ifdef TANTE_PHASE_TIMING
  consumers_sync();
  STAMP(3);
#endif
}

// D = 16, 32, 64: the attention half of that head dim; D = 0: the MLP half.
// CTA c runs tiles c, c + gridDim.x, ...; its producer streams the slabs of
// each in turn.
template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
half_sm90_kernel(const __grid_constant__ HalfArgs A) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kAttn = D != 0;
  const HalfLayout lay = half_layout(kAttn, A.R, A.C, A.W, A.stages, max(A.np[0], A.np[1]));
  bf16* sA = reinterpret_cast<bf16*>(smem + lay.a);
  bf16* sQkv = reinterpret_cast<bf16*>(smem + lay.qkv);
  bf16* sB = reinterpret_cast<bf16*>(smem + lay.b);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Ring ring{smem + lay.ring, bars, bars + A.stages, A.stages,
            kSlabK * max(A.np[0], A.np[1]) * 2, 0};

  if (threadIdx.x == 0) {
    for (int s = 0; s < A.stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int idx = 0;
      for (int t = blockIdx.x; t < A.tiles; t += gridDim.x) produce_half(A, kAttn, ring, idx);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  for (int t = blockIdx.x; t < A.tiles; t += gridDim.x) {
    if constexpr (kAttn)
      attn_half_tile<D, SAFE>(A, t, ring, sA, sQkv, sB);
    else
      mlp_half_tile(A, t, ring, sA, sB);
  }
}

// The persistent grid: as many CTAs as are resident at once, at most one a
// tile.
template <int D, bool SAFE>
cudaError_t launch_half_dt(const HalfArgs& A, size_t smem, int device, cudaStream_t st) {
  auto k = half_sm90_kernel<D, SAFE>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  k<<<min(A.tiles, per_sm * sms), kThreads, smem, st>>>(A);
  return cudaGetLastError();
}

// plan: R (128 when C <= 256, else 64), sequences per tile, W (the local
// width padded to a multiple of 64), the two column passes, ring stages.
// Fills A's plan and returns the shared memory bytes, 0 when the plan is
// outside the kernel.
long long half_shape(HalfArgs& A, const int* plan, bool attn, int C, int local) {
  A.C = C;
  A.R = plan[0];
  A.seqs = plan[1];
  A.W = plan[2];
  A.np[0] = plan[3];
  A.np[1] = plan[4];
  A.stages = plan[5];
  if (A.R != (C <= 256 ? 128 : 64) || C < 64 || C % 64 || C > kMaxC ||
      local < 16 || local % 16 || A.W % 64 || A.W < local || A.W - local >= 64 ||
      A.W > (attn ? C : 2 * C) || A.stages < 2 || A.stages > kMaxStages ||
      !np_ok(A.np[0], attn ? kQkvN : A.W) || !np_ok(A.np[1], C))
    return 0;
  const int max_np = A.np[0] > A.np[1] ? A.np[0] : A.np[1];
  return (long long)half_layout(attn, A.R, C, A.W, A.stages, max_np).total;
}

}  // namespace

extern "C" {

// Tensor-parallel attention half: x (S, L, C) bf16 -> y (S, L, C) bf16, the
// rank's pre-bias out-projection partial.  w: host array of 4 device
// pointers: ln1_scale, ln1_bias, the q|k|v bias of each head group in turn
// (W / 64 groups of 192; q prescaled by d^-0.5*log2(e), zero past CA), and
// the re-laid weights (every slab of a tile's schedule in order; see
// ops/fused_block.py:half_weights).  CA: the shard's attention width,
// `heads` its local heads.  plan: 6 ints (see half_shape).  Returns a
// cudaError_t (0 = launched).
int tante_attn_half_sm90_fwd(const void* x, void* y, const void* const* w, const int* plan,
                             int n_seqs, int L, int C, int CA, int heads, int causal, int safe,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  HalfArgs A;
  const long long smem = half_shape(A, plan, true, C, CA);
  const int d = CA <= C ? head_dim(CA, heads) : 0;
  if (!smem || !d || L < 1 || L > 64 || A.seqs < 1 || A.seqs * L > A.R || n_seqs < 0)
    return cudaErrorInvalidValue;
  err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  if (n_seqs == 0) return cudaSuccess;
  A.x = static_cast<const bf16*>(x);
  A.y = static_cast<bf16*>(y);
  A.ln_s = static_cast<const bf16*>(w[0]);
  A.ln_b = static_cast<const bf16*>(w[1]);
  A.bias = static_cast<const bf16*>(w[2]);
  A.slabs = static_cast<const unsigned char*>(w[3]);
  A.L = L;
  A.causal = causal;
  A.n_seqs = n_seqs;
  A.tiles = (n_seqs + A.seqs - 1) / A.seqs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 16)
    return safe ? launch_half_dt<16, true>(A, smem, device, st)
                : launch_half_dt<16, false>(A, smem, device, st);
  if (d == 32)
    return safe ? launch_half_dt<32, true>(A, smem, device, st)
                : launch_half_dt<32, false>(A, smem, device, st);
  return safe ? launch_half_dt<64, true>(A, smem, device, st)
              : launch_half_dt<64, false>(A, smem, device, st);
}

// Tensor-parallel MLP half: x (M, C) bf16 -> y (M, C) bf16, the rank's
// pre-bias fc2 partial.  w: 4 device pointers: ln2_scale, ln2_bias, b1
// (W wide, zero past HL) and the re-laid weights (fc1's slabs, then fc2's).
// HL: the shard's MLP width.  plan: as above, with R sequences of one row.
int tante_mlp_half_sm90_fwd(const void* x, void* y, const void* const* w, const int* plan, int M,
                            int C, int HL, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  HalfArgs A;
  const long long smem = half_shape(A, plan, false, C, HL);
  if (!smem || A.seqs != A.R || M < 0) return cudaErrorInvalidValue;
  err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  A.x = static_cast<const bf16*>(x);
  A.y = static_cast<bf16*>(y);
  A.ln_s = static_cast<const bf16*>(w[0]);
  A.ln_b = static_cast<const bf16*>(w[1]);
  A.bias = static_cast<const bf16*>(w[2]);
  A.slabs = static_cast<const unsigned char*>(w[3]);
  A.L = 1;
  A.causal = 0;
  A.n_seqs = M;
  A.tiles = (M + A.R - 1) / A.R;
  return launch_half_dt<0, false>(A, smem, device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
