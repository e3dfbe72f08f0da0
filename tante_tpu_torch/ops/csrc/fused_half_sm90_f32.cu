// The two tensor-parallel halves of one block in f32, on the f32 tile body
// of block_sm90.cuh (layer_norm_f32, gemm_f32, attention_group_f32, the f32
// weight stream): a tp rank's head shard and hidden shard, each writing the
// rank's PRE-BIAS partial (rows, C) in f32 for the caller's all-reduce.
//
//   tante_attn_half_sm90_f32_fwd  rows of (S, L, C), whole sequences per
//     64-row tile: LN1; per 64-column head group of the shard (W / 64 of
//     them) one 192-column q|k|v pass and attention_group_f32; the
//     out-projection (K = W, N = C) stored with no bias and no residual
//     (EpiPartialF).
//   tante_mlp_half_sm90_f32_fwd   rows of (M, C), independent: LN2; fc1
//     (N = W) + b1 + tanh-GELU (EpiGeluF); fc2 (K = W, N = C) through
//     EpiPartialF.
//
// Replace tante_tpu/ops/pallas_block.py fused_block_apply_tp (:890) ->
// _pallas_rowtile (:730) in f32 activations: _attn_half_kernel (:696; both
// softmax forms, a template flag) and _mlp_half_kernel (:704), whose output
// takes x's dtype, so an f32 model's partials stay f32.  The bf16 halves are
// fused_half_sm90.cu; these are kernels of their own in a source of their
// own, so the bf16 kernels keep their names, code and build, and the two
// sources build in parallel.
//
// Widths as the bf16 halves': a shard is CA = C/tp attention columns (local
// heads of d = 16, 32 or 64) and HL = hidden/tp MLP columns, multiples of
// 16, padded by the wrapper to W = the next multiple of 64 in the re-laid
// weights (ops/fused_block.py:half_weights): zero columns of wq/wk/wv/w1 and
// zero biases, zero rows of wo/w2.  A padded head's q, k and v are 0, so its
// output is 0; GELU(0) = 0; the zero rows add exact zeros to the f32 sums.
// f32 bounds the width: C <= 256 (the f32 LayerNorm), W <= C (attention) or
// 2C (MLP).
//
// Bound at the flagship's tp = 2 H block (M = 24576 rows, C = 256, CA = HL
// = 128): 6.6 GFLOP (attention) / 3.2 GFLOP (MLP) of f32 products over
// ~50 MB (f32 x in, the f32 partial out) -> 3xTF32 at 495 TFLOP/s (three
// TF32 products an f32-accurate one): ~0.040 / ~0.020 ms, bound by
// operations; the FFMA peak (67 TFLOP/s) gives ~0.098 / ~0.048 ms.
//
// What the design does: the f32 block body's arithmetic (every product
// three TF32 tensor-core products, 3xTF32 with mma.sync, as close to the
// exact product as an f32 FMA; nothing rounded below f32; 64-row tiles;
// row-major activation tiles of K + 4 floats; weight slabs of 16 rows in
// mma's B-fragment order, ops/fused_block.py:arrange_weight_f32; only the
// 16-row blocks that hold valid rows multiplied) on the bf16 halves'
// schedule: a persistent grid of
// min(tiles, resident CTAs) CTAs walks the tiles, and one producer thread
// streams every tile's slabs with cp.async.bulk into an mbarrier ring, the
// next tile's while the consumers finish the current one.  Shared memory at
// C = 256, W = 128: LN output 65 KB, q|k|v 49 KB, attention output 33 KB,
// four 12 KB stages (~195 KB); the MLP half at W = 2C: 65 + 129 KB and
// four 8 KB stages (~226 KB).

#include "block_sm90.cuh"

namespace {

// One f32 half launch.  The MLP half is sequences of L = 1 (seqs = 64 rows a tile).
struct HalfArgsF {
  const float* x;
  float* y;
  const float* ln_s;
  const float* ln_b;
  const float* bias;  // attention: each head group's bq (prescaled) | bk | bv; MLP: b1 (W wide)
  const unsigned char* slabs;
  int C, W, stages, np[2];  // np: q|k|v (192) or fc1; out-projection or fc2
  int L, causal, n_seqs, seqs, tiles;
};

struct HalfLayoutF {
  size_t a, qkv, b, ring, bars, total;  // byte offsets
};

// a: the LayerNorm output (64 x ld_f(C)); qkv (attention): one head group's
// q|k|v (64 x kQkvLdF); b: the attention output or the fc1 output
// (64 x ld_f(W)); the slab ring and its barriers.
__host__ __device__ inline HalfLayoutF half_layout_f32(bool attn, int C, int W, int stages,
                                                       int max_np) {
  HalfLayoutF l;
  l.a = 0;
  l.qkv = (size_t)kRowsF * ld_f(C) * 4;
  l.b = l.qkv + (attn ? (size_t)kRowsF * kQkvLdF * 4 : 0);
  l.ring = l.b + (size_t)kRowsF * ld_f(W) * 4;
  l.bars = l.ring + (size_t)stages * kSlabKF * max_np * 4;
  l.total = l.bars + 2 * kMaxStages * sizeof(uint64_t);
  return l;
}

// One tile's share of the weight stream, in the consumers' order: per head
// group its (C x 192) q|k|v slabs, then the (W x C) out-projection's; or
// fc1's (C x W), then fc2's (W x C).  idx carries the ring's phase across
// tiles.
__device__ __forceinline__ void produce_half_f32(const HalfArgsF& A, bool attn, Ring& ring,
                                                 int& idx) {
  const unsigned char* src = A.slabs;
  const int n_mm = attn ? A.W / 64 + 1 : 2;
  for (int m = 0; m < n_mm; ++m) {
    const int last = m == n_mm - 1;
    const int K = last ? A.W : A.C;
    const int N = last ? A.C : attn ? kQkvN : A.W;
    const int np = A.np[last];
    const uint32_t bytes = (uint32_t)kSlabKF * np * 4;
    const int n = (N / np) * (K / kSlabKF);
    for (int i = 0; i < n; ++i, ++idx, src += bytes) {
      const int s = idx % ring.stages;
      if (idx >= ring.stages) mbar_wait(&ring.empty[s], ((idx / ring.stages) - 1) & 1);
      mbar_expect_tx(&ring.full[s], bytes);
      bulk_load(ring.base + (size_t)s * ring.stage_bytes, src, bytes, &ring.full[s]);
    }
  }
}

// The attention half on one tile of whole sequences (consumer warpgroups).
template <int D, bool SAFE>
__device__ __forceinline__ void attn_half_tile_f32(const HalfArgsF& A, int tile, Ring& ring,
                                                   float* sA, float* sQkv, float* sB) {
  const int C = A.C, W = A.W;
  const int seq0 = tile * A.seqs, valid = min(A.seqs, A.n_seqs - seq0) * A.L;
  const ContigTile rows{(size_t)seq0 * A.L * C, C};
  layer_norm_f32(A.x, rows, valid, sA, C, A.ln_s, A.ln_b);
  consumers_sync();
  for (int gi = 0; gi < W / 64; ++gi) {
    gemm_f32<3>(sA, C, kQkvN, valid, ring, EpiQkvF{sQkv, A.bias + gi * kQkvN});
    consumers_sync();
    // The attention output tile is W wide (ld_f(W)): attention_group_f32's C.
    attention_group_f32<D, SAFE>(sQkv, sB, gi, valid, A.L, W, A.causal);
    consumers_sync();  // the next group's projection overwrites q|k|v
  }
  gemm_f32_np(sB, W, C, A.np[1], valid, ring, EpiPartialF<ContigTile>{A.y, rows, valid});
}

// The MLP half on one tile of 64 rows.
__device__ __forceinline__ void mlp_half_tile_f32(const HalfArgsF& A, int tile, Ring& ring,
                                                  float* sA, float* sH) {
  const int C = A.C, W = A.W;
  const int row0 = tile * kRowsF, valid = min(kRowsF, A.n_seqs - row0);
  const ContigTile rows{(size_t)row0 * C, C};
  layer_norm_f32(A.x, rows, valid, sA, C, A.ln_s, A.ln_b);
  consumers_sync();
  gemm_f32_np(sA, C, W, A.np[0], valid, ring, EpiGeluF{sH, A.bias, ld_f(W)});
  consumers_sync();
  gemm_f32_np(sH, W, C, A.np[1], valid, ring, EpiPartialF<ContigTile>{A.y, rows, valid});
}

// D = 16, 32, 64: the attention half of that head dim; D = 0: the MLP half.
// CTA c runs tiles c, c + gridDim.x, ...; its producer streams the slabs of
// each in turn.  A tile's shared tiles are free for the next one once every
// consumer is past the next tile's first barrier (after its LayerNorm).
template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
half_sm90_f32_kernel(const __grid_constant__ HalfArgsF A) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kAttn = D != 0;
  const int max_np = max(A.np[0], A.np[1]);
  const HalfLayoutF lay = half_layout_f32(kAttn, A.C, A.W, A.stages, max_np);
  float* sA = reinterpret_cast<float*>(smem + lay.a);
  float* sQkv = reinterpret_cast<float*>(smem + lay.qkv);
  float* sB = reinterpret_cast<float*>(smem + lay.b);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Ring ring{smem + lay.ring, bars, bars + A.stages, A.stages, kSlabKF * max_np * 4, 0};

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
      for (int t = blockIdx.x; t < A.tiles; t += gridDim.x) produce_half_f32(A, kAttn, ring, idx);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  for (int t = blockIdx.x; t < A.tiles; t += gridDim.x) {
    if constexpr (kAttn)
      attn_half_tile_f32<D, SAFE>(A, t, ring, sA, sQkv, sB);
    else
      mlp_half_tile_f32(A, t, ring, sA, sB);
  }
}

// The persistent grid: as many CTAs as are resident at once, at most one a
// tile.
template <int D, bool SAFE>
cudaError_t launch_half_f32(const HalfArgsF& A, size_t smem, int device, cudaStream_t st) {
  auto k = half_sm90_f32_kernel<D, SAFE>;
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

// An f32 pass past the q|k|v one: 64 or 128 columns (gemm_f32_np), dividing N.
bool np_ok_f32(int np, int N) { return (np == 64 || np == 128) && N % np == 0; }

// plan: R (64), sequences per tile, W (the local width padded to a multiple
// of 64), the two column passes, ring stages (ops/fused_block.py:half_plan
// with dtype f32 mirrors it).  Fills A's plan and returns the shared memory
// bytes, 0 when the plan is outside the kernel.
long long half_shape_f32(HalfArgsF& A, const int* plan, bool attn, int C, int local) {
  A.C = C;
  A.seqs = plan[1];
  A.W = plan[2];
  A.np[0] = plan[3];
  A.np[1] = plan[4];
  A.stages = plan[5];
  if (plan[0] != kRowsF || C < 64 || C % 64 || C > kMaxCF || local < 16 || local % 16 ||
      A.W % 64 || A.W < local || A.W - local >= 64 || A.W > (attn ? C : 2 * C) ||
      A.stages < 2 || A.stages > kMaxStages ||
      !(attn ? A.np[0] == kQkvN : np_ok_f32(A.np[0], A.W)) || !np_ok_f32(A.np[1], C))
    return 0;
  const int max_np = A.np[0] > A.np[1] ? A.np[0] : A.np[1];
  return (long long)half_layout_f32(attn, C, A.W, A.stages, max_np).total;
}

}  // namespace

extern "C" {

// Tensor-parallel attention half in f32: x (S, L, C) f32 -> y (S, L, C) f32,
// the rank's pre-bias out-projection partial.  w: host array of 4 device
// pointers, all f32: ln1_scale, ln1_bias, the q|k|v bias of each head group
// in turn (W / 64 groups of 192; q prescaled by d^-0.5*log2(e), zero past
// CA), and the re-laid weights (every f32 slab of a tile's schedule in
// order; see ops/fused_block.py:half_weights).  CA: the shard's attention
// width, `heads` its local heads.  plan: 6 ints (see half_shape_f32).
// Returns a cudaError_t (0 = launched).
int tante_attn_half_sm90_f32_fwd(const void* x, void* y, const void* const* w, const int* plan,
                                 int n_seqs, int L, int C, int CA, int heads, int causal,
                                 int safe, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  HalfArgsF A;
  const long long smem = half_shape_f32(A, plan, true, C, CA);
  const int d = CA <= C ? head_dim(CA, heads) : 0;
  if (!smem || !d || L < 1 || L > 64 || A.seqs < 1 || A.seqs * L > kRowsF || n_seqs < 0)
    return cudaErrorInvalidValue;
  err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  if (n_seqs == 0) return cudaSuccess;
  A.x = static_cast<const float*>(x);
  A.y = static_cast<float*>(y);
  A.ln_s = static_cast<const float*>(w[0]);
  A.ln_b = static_cast<const float*>(w[1]);
  A.bias = static_cast<const float*>(w[2]);
  A.slabs = static_cast<const unsigned char*>(w[3]);
  A.L = L;
  A.causal = causal;
  A.n_seqs = n_seqs;
  A.tiles = (n_seqs + A.seqs - 1) / A.seqs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 16)
    return safe ? launch_half_f32<16, true>(A, smem, device, st)
                : launch_half_f32<16, false>(A, smem, device, st);
  if (d == 32)
    return safe ? launch_half_f32<32, true>(A, smem, device, st)
                : launch_half_f32<32, false>(A, smem, device, st);
  return safe ? launch_half_f32<64, true>(A, smem, device, st)
              : launch_half_f32<64, false>(A, smem, device, st);
}

// Tensor-parallel MLP half in f32: x (M, C) f32 -> y (M, C) f32, the rank's
// pre-bias fc2 partial.  w: 4 device pointers, all f32: ln2_scale,
// ln2_bias, b1 (W wide, zero past HL) and the re-laid weights (fc1's slabs,
// then fc2's).  HL: the shard's MLP width.  plan: as above, with 64
// sequences of one row.
int tante_mlp_half_sm90_f32_fwd(const void* x, void* y, const void* const* w, const int* plan,
                                int M, int C, int HL, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  HalfArgsF A;
  const long long smem = half_shape_f32(A, plan, false, C, HL);
  if (!smem || A.seqs != kRowsF || M < 0) return cudaErrorInvalidValue;
  err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  A.x = static_cast<const float*>(x);
  A.y = static_cast<float*>(y);
  A.ln_s = static_cast<const float*>(w[0]);
  A.ln_b = static_cast<const float*>(w[1]);
  A.bias = static_cast<const float*>(w[2]);
  A.slabs = static_cast<const unsigned char*>(w[3]);
  A.L = 1;
  A.causal = 0;
  A.n_seqs = M;
  A.tiles = (M + kRowsF - 1) / kRowsF;
  return launch_half_f32<0, false>(A, smem, device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
