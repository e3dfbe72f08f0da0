// Fused pre-LN axial transformer block for Hopper (sm_90a), bf16: the first
// design's tile body (block_tile, the first port of
// tante_tpu/ops/pallas_block.py fused_block_apply).
//
//   y = x' + fc2(gelu_tanh(fc1(ln2(x'))))      x' = x + wo(attn(ln1(x)))
//
// No model path takes this body any more: the Hopper body (block_sm90.cuh)
// took its place in fused_block_sm90.cu (the single block, the canonical T
// block), fused_chain_sm90.cu (the chain) and fused_half_sm90.cu (the two
// tensor-parallel halves).  Its entries stay as the baseline the
// measurement scripts and the GPU tests time the Hopper kernels against, in
// turns on the same card (ops/fused_block.py: block_tile_canon_t,
// block_tile_chain, block_tile_attn_half, block_tile_mlp_half):
//
//   tante_attn_half_fwd / tante_mlp_half_fwd
//                                  the two tensor-parallel halves of one
//                                  block on a tp rank's weight shards: LN1 +
//                                  local q/k/v heads + attention + the
//                                  out-projection partial, and LN2 + local
//                                  fc1/GELU + the fc2 partial, each stored
//                                  pre-bias in bf16 for the caller's
//                                  all-reduce (first port of
//     tante_tpu/ops/pallas_block.py fused_block_apply_tp -> _pallas_rowtile
//     -> _attn_half_kernel / _mlp_half_kernel).
//   tante_fused_block_canon_t_fwd  the causal T block on canonical
//                                  (B, T, H, W, C): each CTA gathers P
//                                  pixels x T steps as P sequences of
//                                  length T, at stride H*W*C.
//   tante_fused_chain_fwd         a run of T/H/W blocks on one (B, T, H, W, C)
//                                  tensor in ONE cooperative launch: a
//                                  persistent grid loops over the run's
//                                  blocks, each block over its tiles under a
//                                  strided row map for its axis, with a
//                                  grid-wide barrier (grid.sync) between
//                                  blocks and two ping-pong device buffers.
//
// Numerics: q arrives prescaled by d^-0.5*log2(e) (folded into wq/bq by the
// wrapper).  The Pallas "fast" softmax: scores are exp2(min(s, 60*log2 e))
// with no max-subtract; or, under the SAFE template flag (the chain and the
// tp halves take it; set_block_tuning(softmax="safe")), the Pallas "safe"
// branch (pallas_block.py:_attn_half_body): exp2(s - max) over the admitted
// keys.  Masked keys contribute exactly 0 (skipped), the unnormalised
// weights are rounded to bf16 before the AV product, and the result is
// scaled by 1/(sum + 1e-30).  q/k/v,
// attention output, fc1 output and both residual sums are rounded to bf16
// where the Pallas kernel rounds them; LayerNorm (one-pass moments), GELU,
// softmax and every matmul accumulator are f32.
//
// Bound at the flagship shape (M = 8*4*16*48 = 24576 rows, C = hidden =
// 256): 2*M*(4C^2 + 2C*hidden) = 19.3 GFLOP of matmul per block plus
// 4*M*L*C of attention (1.21 GFLOP at L=48, 0.40 at L=16, ~0.1 for T) ->
// ~20 us at 989 TFLOP/s dense bf16; device memory moves ~26 MB (x in, y out,
// 0.8 MB of weights) -> ~8 us at 3.35 TB/s.  The block is compute-bound.
//
// This first design: one CTA (8 warps) per tile of whole sequences (64 rows
// for L=16 and T, 48 for L=48; a ragged last tile is masked).  x, LN output,
// q, k, v live in dynamic shared memory as bf16 (attention writes over q,
// fc1 over q|k).  The six matmuls run on the tensor cores through
// nvcuda::wmma (m16n16k16 bf16, f32 accumulate); each warp owns 32 output
// columns and streams its own 16 x 32 weight tiles from L2 through a private
// 4-deep cp.async ring, so a matmul needs no CTA barrier.  Attention runs on
// the tensor cores when L % 16 == 0 (the H and W blocks) and as f32 FMA on
// CUDA cores otherwise (the T block, L = 4).  Measured phase split per CTA
// (H block, see PERF.md): ~75% matmuls, ~10% attention, ~10% LayerNorm and
// row gathers.  What it leaves on the table against the bound: wgmma, TMA
// and warp specialisation, a persistent grid, and more than one CTA per SM
// (~219 KB of shared memory per CTA at 64 rows).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;          // bf16 row padding of shared tiles (bank spread)
constexpr int kPassN = kWarps * 32;  // output columns per pass (32 per warp)
constexpr int kStages = 4;       // k steps of weight tiles in flight per warp
constexpr int kRingLd = 32 + kPad;         // row stride of a ring tile (bank spread)
constexpr int kRingTile = 16 * kRingLd;    // one 16 x 32 weight tile, bf16
constexpr int kMaxRows = 64;     // rows per CTA at most (4 wmma row tiles)
constexpr int kMaxC = 512;       // widest row LayerNorm keeps in registers
constexpr int kLnChunks = kMaxC / 256;
constexpr float kLog2e = 1.4426950408889634f;

enum { LN1S, LN1B, WQ, BQ, WK, BK, WV, BV, WO, BO, LN2S, LN2B, W1, B1, W2, B2 };

struct Params {
  const bf16* p[16];
};

// Phase timing (measurement builds only, -DTANTE_PHASE_TIMING; see
// tante_tpu_torch/tools/kernel_phases.py): thread 0 of each of the first
// kPhaseCtas tiles stamps the global nanosecond timer at every phase
// boundary, after a CTA barrier.  Without the flag PHASE() is empty.
constexpr int kPhases = 11;  // start, load, ln1, q, k, v, attention, o, ln2, fc1, fc2
constexpr int kPhaseCtas = 8192;
#ifdef TANTE_PHASE_TIMING
__device__ unsigned long long g_phase_ns[kPhaseCtas][kPhases];
#define PHASE(i)                                                               \
  do {                                                                         \
    __syncthreads();                                                           \
    if (threadIdx.x == 0 && tile < kPhaseCtas) {                               \
      unsigned long long t;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                    \
      g_phase_ns[tile][i] = t;                                                 \
    }                                                                          \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

// Sequence = one pixel's T steps of a canonical (B, T, HW, C) tensor.
struct CanonTRows {
  int T, HW, C;
  __device__ size_t offset(int seq, int t) const {
    const int b = seq / HW, p = seq - b * HW;
    return (((size_t)b * T + t) * HW + p) * C;
  }
};

// Sequence = one line along an axis of a (B, T, H, W) token grid held in any
// token order: sequence number = (b, i, j) over the two other axes (the
// inner one of size n2), rows of a batch element `sb` apart, strides in rows.
struct StridedRows {
  int per, n2, sb, s1, s2, sa, C;
  __device__ size_t offset(int seq, int t) const {
    const int b = seq / per, r = seq - b * per, i = r / n2, j = r - i * n2;
    return ((size_t)b * sb + (size_t)i * s1 + (size_t)j * s2 + (size_t)t * sa) * C;
  }
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 consecutive bf16 <-> f32.
__device__ __forceinline__ void load8(const bf16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = bf2f(b[e]);
}
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 u;
  bf16* b = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = f2bf(v[e]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// LayerNorm of R rows (one warp per row), f32 one-pass moments, bf16 out.
// Lane l owns columns [8l, 8l+8) of every 256-column chunk; its scale and
// bias live in registers for all rows.
__device__ void layer_norm(const bf16* src, bf16* dst, int ld, int rows, int C,
                           const bf16* __restrict__ scale, const bf16* __restrict__ bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sc[kLnChunks][8], bi[kLnChunks][8];
#pragma unroll
  for (int i = 0; i < kLnChunks; ++i) {
    const int c0 = lane * 8 + i * 256;
    if (c0 < C) {
      load8(scale + c0, sc[i]);
      load8(bias + c0, bi[i]);
    }
  }
  for (int r = warp; r < rows; r += kWarps) {
    const bf16* row = src + r * ld;
    float v[kLnChunks][8];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kLnChunks; ++i) {
      const int c0 = lane * 8 + i * 256;
      if (c0 < C) {
        load8(row + c0, v[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[i][e];
          ss += v[i][e] * v[i][e];
        }
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float var = fmaxf(ss / C - mu * mu, 0.f);
    const float rs = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int i = 0; i < kLnChunks; ++i) {
      const int c0 = lane * 8 + i * 256;
      if (c0 < C) {
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = (v[i][e] - mu) * rs * sc[i][e] + bi[i][e];
        store8(dst + r * ld + c0, y);
      }
    }
  }
}

// ---- matmul epilogues: v = acc + bias for 8 consecutive columns of a row --

struct EpiStore {  // dst = bf16(v)
  bf16* dst;
  int ld;
  __device__ void operator()(int r, int c, float* v) const { store8(dst + r * ld + c, v); }
};

struct EpiGelu {  // dst = bf16(gelu_tanh(v)), GELU in f32
  bf16* dst;
  int ld;
  __device__ void operator()(int r, int c, float* v) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = v[e];
      v[e] = 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
    }
    store8(dst + r * ld + c, v);
  }
};

struct EpiResidual {  // x = bf16(x + bf16(v)), in shared memory
  bf16* x;
  int ld;
  __device__ void operator()(int r, int c, float* v) const {
    float xr[8];
    load8(x + r * ld + c, xr);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = xr[e] + round_bf16(v[e]);
    store8(x + r * ld + c, v);
  }
};

struct EpiOut {  // y[row_off[r]] = bf16(x + bf16(v)) for the tile's valid rows
  const bf16* x;
  int ld;
  bf16* y;
  const size_t* row_off;  // element offset of each tile row in y (shared memory)
  int rows_valid;
  __device__ void operator()(int r, int c, float* v) const {
    if (r >= rows_valid) return;
    float xr[8];
    load8(x + r * ld + c, xr);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = xr[e] + round_bf16(v[e]);
    store8(y + row_off[r] + c, v);
  }
};

struct EpiRows {  // y[r] = bf16(v) for the tile's valid rows (contiguous, ld apart)
  bf16* y;
  int ld;
  int rows_valid;
  __device__ void operator()(int r, int c, float* v) const {
    if (r < rows_valid) store8(y + (size_t)r * ld + c, v);
  }
};

// out[r, n] = sum_k A[r, k] W[k, n] + bias[n] for the RT*16 rows of A
// (shared, lda) and W (K x N, row-major, device memory; K % 16 == 0),
// handed to `epi` in f32.  Columns go in passes of kPassN; warp w owns 32
// columns of a pass and all RT row tiles.  Each warp streams its own 16 x 32
// tiles of W (L2-resident: every CTA reads the same weights) through a
// private shared-memory ring, kStages k steps deep, with 16-byte cp.async
// copies; no barrier is needed, only the warp's own: the caller
// synchronises before reading what the epilogue wrote.
// A null `bias` adds nothing (the tensor-parallel halves' pre-bias partials).
// N need not fill a pass: a warp whose 32 columns start at or past N idles.
template <int RT, class Epi>
__device__ void gemm(const bf16* sA, int lda, const bf16* __restrict__ W,
                     const bf16* __restrict__ bias, int K, int N, float* sStage,
                     bf16* sRing, const Epi& epi) {
  const int nk = K / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rr = lane >> 1, cc = (lane & 1) * 8;  // this lane's epilogue row / columns
  bf16* ring = sRing + warp * kStages * kRingTile;
  for (int n0 = warp * 32; n0 < N; n0 += kPassN) {
    // Lane l copies 16-byte chunks l and l + 32 of each 16 x 32 tile.
    auto fetch = [&](int k) {
      if (k < nk) {
        bf16* dst = ring + (k % kStages) * kRingTile;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t, row = c >> 2, col = (c & 3) * 8;
          cp_async16(dst + row * kRingLd + col, W + (size_t)(k * 16 + row) * N + n0 + col);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) fetch(k);
    float bv[2][8] = {};
    if (bias) {
      load8(bias + n0 + cc, bv[0]);
      load8(bias + n0 + 16 + cc, bv[1]);
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::fill_fragment(acc[i][0], 0.f);
      wmma::fill_fragment(acc[i][1], 0.f);
    }
    for (int k = 0; k < nk; ++k) {
      cp_async_wait<kStages - 2>();  // tile k has landed (this lane's copies)
      __syncwarp();                  // ... every lane's
      const bf16* tile = ring + (k % kStages) * kRingTile;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
      wmma::load_matrix_sync(b0, tile, kRingLd);
      wmma::load_matrix_sync(b1, tile + 16, kRingLd);
      __syncwarp();                  // the slot of tile k - 1 is free again
      fetch(k + kStages - 1);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) wmma::load_matrix_sync(a[i], sA + i * 16 * lda + k * 16, lda);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        wmma::mma_sync(acc[i][0], a[i], b0, acc[i][0]);
        wmma::mma_sync(acc[i][1], a[i], b1, acc[i][1]);
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // the ring is free for the next pass
    float* stage = sStage + warp * 256;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        float v[8];
        const float4 lo = *reinterpret_cast<const float4*>(stage + rr * 16 + cc);
        const float4 hi = *reinterpret_cast<const float4*>(stage + rr * 16 + cc + 4);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += bv[j][e];
        epi(i * 16 + rr, n0 + j * 16 + cc, v);
        __syncwarp();
      }
    }
  }
}

// Per-warp attention scratch (tensor-core path): 16 x L f32 scores, then
// 16 x (L + kPad) bf16 weights.
__host__ __device__ constexpr int attn_scratch_floats(int L) {
  return 16 * L + 16 * (L + kPad) / 2;
}

// Attention of one head inside each length-L sequence of the tile; the
// output overwrites q in place (a head's q rows are read only by whoever
// writes that head's output, before it writes).

// CUDA cores, any L: one thread per (row, head); the rows of a warp share a
// head, so their k/v reads broadcast.
template <int D, bool SAFE>
__device__ void attention_fma(bf16* sQ, const bf16* sK, const bf16* sV, int ld, int rows,
                              int rows_valid, int L, int heads, bool causal) {
  const float clamp = 60.f * kLog2e;
  for (int item = threadIdx.x; item < rows * heads; item += kThreads) {
    const int h = item / rows, r = item - h * rows;
    bf16* o = sQ + r * ld + h * D;
    if (r >= rows_valid) continue;
    const int s0 = (r / L) * L;
    const int jmax = causal ? r - s0 : L - 1;
    float q[D], acc[D];
#pragma unroll
    for (int i = 0; i < D; i += 8) load8(o + i, q + i);
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] = 0.f;
    auto score = [&](int j) {
      const bf16* kr = sK + (s0 + j) * ld + h * D;
      float sp[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, not one of D FMAs
#pragma unroll
      for (int i = 0; i < D; i += 8) {
        float kv[8];
        load8(kr + i, kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) sp[e & 3] = fmaf(q[i + e], kv[e], sp[e & 3]);
      }
      return (sp[0] + sp[1]) + (sp[2] + sp[3]);
    };
    float mx = -1e30f;  // "safe": the row's largest admitted score
    if (SAFE)
      for (int j = 0; j <= jmax; ++j) mx = fmaxf(mx, score(j));
    float den = 0.f;
    for (int j = 0; j <= jmax; ++j) {
      const bf16* vr = sV + (s0 + j) * ld + h * D;
      const float s = score(j);
      const float e = exp2f(SAFE ? s - mx : fminf(s, clamp));
      den += e;
      const float eb = round_bf16(e);
#pragma unroll
      for (int i = 0; i < D; i += 8) {
        float vv[8];
        load8(vr + i, vv);
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[i + t] = fmaf(eb, vv[t], acc[i + t]);
      }
    }
    const float inv = 1.f / (den + 1e-30f);
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] *= inv;
#pragma unroll
    for (int i = 0; i < D; i += 8) store8(o + i, acc + i);
  }
}

// Tensor cores, L % 16 == 0: one warp per (sequence, head, 16-query block).
// Scores S = q k^T (wmma, f32) go to the warp's scratch, the unnormalised
// weights bf16(exp2(min(s, clamp))) to a bf16 copy beside them, then
// o = (P v) / rowsum.  Causal blocks skip the key tiles above the diagonal.
template <int D, bool SAFE>
__device__ void attention_mma(bf16* sQ, const bf16* sK, const bf16* sV, float* scratch,
                              float* sStage, int ld, int nseq, int L, int heads, bool causal) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float clamp = 60.f * kLog2e;
  const int nqb = L / 16, ldp = L + kPad;
  float* sc = scratch + warp * attn_scratch_floats(L);
  bf16* pm = reinterpret_cast<bf16*>(sc + 16 * L);
  float* stage = sStage + warp * 256;
  const int row = lane >> 1, half = lane & 1;
  for (int item = warp; item < nseq * heads * nqb; item += kWarps) {
    const int qb = item % nqb, h = (item / nqb) % heads, s = item / (nqb * heads);
    const int row0 = s * L + qb * 16;
    const int nkt = causal ? qb + 1 : nqb;
    bf16* q = sQ + row0 * ld + h * D;
    for (int jt = 0; jt < nkt; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, q + kk, ld);
        wmma::load_matrix_sync(b, sK + (s * L + jt * 16) * ld + h * D + kk, ld);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sc + jt * 16, acc, L, wmma::mem_row_major);
    }
    __syncwarp();
    // Lane pair (2r, 2r+1) owns query row r: alternate key columns.
    const int tq = qb * 16 + row;
    float mx = -1e30f;  // "safe": the row's largest admitted score
    if (SAFE) {
      for (int c = half; c < nkt * 16; c += 2)
        if (!causal || c <= tq) mx = fmaxf(mx, sc[row * L + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    }
    float den = 0.f;
    for (int c = half; c < nkt * 16; c += 2) {
      float e = 0.f;
      if (!causal || c <= tq) {
        const float s = sc[row * L + c];
        e = exp2f(SAFE ? s - mx : fminf(s, clamp));
        den += e;
      }
      pm[row * ldp + c] = f2bf(e);
    }
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    const float inv = 1.f / (den + 1e-30f);
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < D; dt += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int jt = 0; jt < nkt; ++jt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, pm + jt * 16, ldp);
        wmma::load_matrix_sync(b, sV + (s * L + jt * 16) * ld + h * D + dt, ld);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = stage[row * 16 + half * 8 + e] * inv;
      store8(q + row * ld + dt + half * 8, v);
      __syncwarp();
    }
  }
}

// Per-warp scratch: the matmuls' weight rings, or (never at the same time)
// the attention scratch.
__host__ __device__ constexpr size_t scratch_bytes(int L) {
  const size_t ring = (size_t)kWarps * kStages * kRingTile * sizeof(bf16);
  const size_t attn = L % 16 == 0 ? (size_t)kWarps * attn_scratch_floats(L) * sizeof(float) : 0;
  return ring > attn ? ring : attn;
}

// Where each tile row lives in x and in y (element offsets), worked out once
// per tile: the row maps' divisions stay out of the gather and the epilogue.
constexpr size_t kRowTableBytes = 2 * kMaxRows * sizeof(size_t);

__host__ __device__ constexpr size_t smem_bytes(int rows, int C, int HID, int L) {
  // row offset tables; x, ln-out, q (-> attention out), k, v tiles; fc1
  // output reuses q|k (HID <= 2C); per-warp matmul staging; per-warp scratch.
  return kRowTableBytes + (size_t)5 * rows * (C + kPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float) + scratch_bytes(L);
}

// One tile of one block: the tile's whole sequences are gathered from x
// through `in`, run through the block in shared memory, and stored to y
// through `out`.  x is read with ld.global.cg (L2 only): inside the chain
// kernel another SM wrote it earlier in the same launch.
template <int RT, bool SAFE, class InMap, class OutMap>
__device__ __forceinline__ void block_tile(const bf16* x, bf16* y, const Params& P,
                                           const InMap& in, const OutMap& out, int tile,
                                           int n_seqs, int seqs_per_tile, int L, int C, int HID,
                                           int heads, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = RT * 16;
  const int ldx = C + kPad, ldh = HID + kPad;
  size_t* sRowIn = reinterpret_cast<size_t*>(smem);
  size_t* sRowOut = sRowIn + kMaxRows;
  bf16* sX = reinterpret_cast<bf16*>(smem + kRowTableBytes);
  bf16* sXN = sX + R * ldx;
  bf16* sQ = sXN + R * ldx;
  bf16* sK = sQ + R * ldx;
  bf16* sV = sK + R * ldx;
  bf16* sH = sQ;  // fc1 output, after attention no longer needs q and k
  float* sStage = reinterpret_cast<float*>(sV + R * ldx);
  float* sScratch = sStage + kWarps * 256;
  bf16* sRing = reinterpret_cast<bf16*>(sScratch);

  PHASE(0);
  const int seq0 = tile * seqs_per_tile;
  const int rows_valid = min(seqs_per_tile, n_seqs - seq0) * L;

  for (int r = threadIdx.x; r < rows_valid; r += kThreads) {
    sRowIn[r] = in.offset(seq0 + r / L, r % L);
    sRowOut[r] = out.offset(seq0 + r / L, r % L);
  }
  __syncthreads();
  // Gather the tile's rows (zeros below the valid rows).
  const int vec_per_row = C / 8;
  for (int idx = threadIdx.x; idx < R * vec_per_row; idx += kThreads) {
    const int r = idx / vec_per_row, c8 = idx - r * vec_per_row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      v = __ldcg(reinterpret_cast<const uint4*>(x + sRowIn[r] + c8 * 8));
    *reinterpret_cast<uint4*>(sX + r * ldx + c8 * 8) = v;
  }
  __syncthreads();
  PHASE(1);

  layer_norm(sX, sXN, ldx, R, C, P.p[LN1S], P.p[LN1B]);
  __syncthreads();
  PHASE(2);
  gemm<RT>(sXN, ldx, P.p[WQ], P.p[BQ], C, C, sStage, sRing, EpiStore{sQ, ldx});
  PHASE(3);
  gemm<RT>(sXN, ldx, P.p[WK], P.p[BK], C, C, sStage, sRing, EpiStore{sK, ldx});
  PHASE(4);
  gemm<RT>(sXN, ldx, P.p[WV], P.p[BV], C, C, sStage, sRing, EpiStore{sV, ldx});
  __syncthreads();
  PHASE(5);

  const int d = C / heads;
  if (L % 16 == 0) {
    const int nseq = rows_valid / L;
    if (d == 32)
      attention_mma<32, SAFE>(sQ, sK, sV, sScratch, sStage, ldx, nseq, L, heads, causal);
    else if (d == 64)
      attention_mma<64, SAFE>(sQ, sK, sV, sScratch, sStage, ldx, nseq, L, heads, causal);
    else
      attention_mma<16, SAFE>(sQ, sK, sV, sScratch, sStage, ldx, nseq, L, heads, causal);
  } else {
    if (d == 32)
      attention_fma<32, SAFE>(sQ, sK, sV, ldx, R, rows_valid, L, heads, causal);
    else if (d == 64)
      attention_fma<64, SAFE>(sQ, sK, sV, ldx, R, rows_valid, L, heads, causal);
    else
      attention_fma<16, SAFE>(sQ, sK, sV, ldx, R, rows_valid, L, heads, causal);
  }
  __syncthreads();
  PHASE(6);

  gemm<RT>(sQ, ldx, P.p[WO], P.p[BO], C, C, sStage, sRing, EpiResidual{sX, ldx});
  __syncthreads();
  PHASE(7);
  layer_norm(sX, sXN, ldx, R, C, P.p[LN2S], P.p[LN2B]);
  __syncthreads();
  PHASE(8);
  gemm<RT>(sXN, ldx, P.p[W1], P.p[B1], C, HID, sStage, sRing, EpiGelu{sH, ldh});
  __syncthreads();
  PHASE(9);
  gemm<RT>(sH, ldh, P.p[W2], P.p[B2], HID, C, sStage, sRing,
           EpiOut{sX, ldx, y, sRowOut, rows_valid});
  PHASE(10);
}

template <int RT, class RowMap>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_kernel(const bf16* x, bf16* y, Params P, RowMap rm, int n_seqs, int seqs_per_tile,
                   int L, int C, int HID, int heads, int causal) {
  block_tile<RT, false>(x, y, P, rm, rm, blockIdx.x, n_seqs, seqs_per_tile, L, C, HID, heads,
                       causal);
}

// ---- the chain: a run of blocks in one cooperative launch ------------------

constexpr int kMaxChainBlocks = 12;

struct ChainStep {
  Params P;
  StridedRows in, out;  // token order of the buffer read / written
  int L, causal, n_seqs, seqs_per_tile, rt;
  int src, dst;         // indices into ChainArgs::buf
};

struct ChainArgs {
  ChainStep step[kMaxChainBlocks];
  bf16* buf[4];  // caller's x, caller's y, two scratch buffers (canonical order)
  int n_steps;
};

// Inlined on purpose: as a function of its own the tile body keeps its wmma
// fragments in a stack frame and runs slower, although it then spills less.
template <int RT, bool SAFE>
__device__ __forceinline__ void chain_tile(const bf16* x, bf16* y, const ChainStep& s, int tile,
                                           int C, int HID, int heads) {
  block_tile<RT, SAFE>(x, y, s.P, s.in, s.out, tile, s.n_seqs, s.seqs_per_tile, s.L, C, HID, heads,
                 s.causal);
}

// Persistent grid: every CTA walks the tiles of block i at stride gridDim.x,
// then all CTAs meet at a grid barrier (which orders block i's global writes
// before block i + 1's reads) and go on to block i + 1.  A block never reads
// the buffer it writes.
template <bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
fused_chain_kernel(const __grid_constant__ ChainArgs A, int C, int HID, int heads) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < A.n_steps; ++i) {
    const ChainStep& s = A.step[i];
    const bf16* x = A.buf[s.src];
    bf16* y = A.buf[s.dst];
    const int n_tiles = (s.n_seqs + s.seqs_per_tile - 1) / s.seqs_per_tile;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      switch (s.rt) {
        case 1: chain_tile<1, SAFE>(x, y, s, tile, C, HID, heads); break;
        case 2: chain_tile<2, SAFE>(x, y, s, tile, C, HID, heads); break;
        case 3: chain_tile<3, SAFE>(x, y, s, tile, C, HID, heads); break;
        default: chain_tile<4, SAFE>(x, y, s, tile, C, HID, heads); break;
      }
      __syncthreads();  // the tile's shared memory is free for the next tile
    }
    if (i + 1 < A.n_steps) grid.sync();
  }
}

// Whole sequences per CTA: as many as fit in kMaxRows rows and in the
// device's opt-in shared memory.  Returns 0 when none fits.
int plan_tile(int L, int C, int HID, int* seqs_out, int* smem_out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (L < 1 || L > kMaxRows || C % 64 || C > kMaxC || HID % 64 || HID > 2 * C)
    return cudaErrorInvalidValue;
  for (int seqs = kMaxRows / L; seqs >= 1; --seqs) {
    const int rows = (seqs * L + 15) / 16 * 16;
    const size_t bytes = smem_bytes(rows, C, HID, L);
    if (bytes <= (size_t)optin) {
      *seqs_out = seqs;
      *smem_out = (int)bytes;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

template <int RT, class RowMap>
cudaError_t launch_rt(const bf16* x, bf16* y, const Params& P, RowMap rm, int n_seqs, int seqs,
                      int smem, int L, int C, int HID, int heads, int causal, cudaStream_t st) {
  auto kernel = fused_block_kernel<RT, RowMap>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (n_seqs + seqs - 1) / seqs;
  kernel<<<grid, kThreads, smem, st>>>(x, y, P, rm, n_seqs, seqs, L, C, HID, heads, causal);
  return cudaGetLastError();
}

bool head_dim_ok(int C, int heads) {
  const int d = heads > 0 && C % heads == 0 ? C / heads : 0;
  return d == 16 || d == 32 || d == 64;
}

template <class RowMap>
int launch(const void* x, void* y, const void* const* w, RowMap rm, int n_seqs, int L, int C,
           int HID, int heads, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!head_dim_ok(C, heads)) return cudaErrorInvalidValue;
  int seqs = 0, smem = 0;
  err = (cudaError_t)plan_tile(L, C, HID, &seqs, &smem);
  if (err != cudaSuccess) return err;
  if (n_seqs <= 0) return cudaSuccess;
  Params P;
  for (int i = 0; i < 16; ++i) P.p[i] = static_cast<const bf16*>(w[i]);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((seqs * L + 15) / 16) {
    case 1: return launch_rt<1>(xb, yb, P, rm, n_seqs, seqs, smem, L, C, HID, heads, causal, st);
    case 2: return launch_rt<2>(xb, yb, P, rm, n_seqs, seqs, smem, L, C, HID, heads, causal, st);
    case 3: return launch_rt<3>(xb, yb, P, rm, n_seqs, seqs, smem, L, C, HID, heads, causal, st);
    case 4: return launch_rt<4>(xb, yb, P, rm, n_seqs, seqs, smem, L, C, HID, heads, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// plan: n_steps x kChainPlanInts ints per block: L, causal, n_seqs, then the
// read map and the write map as (per, n2, sb, s1, s2, sa) each.
constexpr int kChainPlanInts = 15;

template <bool SAFE>
int launch_chain(const void* x, void* y, void* buf0, void* buf1, const void* const* w,
                 const int* plan, int n_steps, int C, int HID, int heads, int device,
                 void* stream) {
  auto kernel = fused_chain_kernel<SAFE>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_steps < 1 || n_steps > kMaxChainBlocks || !head_dim_ok(C, heads))
    return cudaErrorInvalidValue;
  int coop = 0, sms = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  ChainArgs A;
  A.n_steps = n_steps;
  A.buf[0] = const_cast<bf16*>(static_cast<const bf16*>(x));
  A.buf[1] = static_cast<bf16*>(y);
  A.buf[2] = static_cast<bf16*>(buf0);
  A.buf[3] = static_cast<bf16*>(buf1);
  int smem = 0, max_tiles = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int* p = plan + i * kChainPlanInts;
    ChainStep& s = A.step[i];
    for (int k = 0; k < 16; ++k) s.P.p[k] = static_cast<const bf16*>(w[i * 16 + k]);
    s.L = p[0];
    s.causal = p[1];
    s.n_seqs = p[2];
    s.in = StridedRows{p[3], p[4], p[5], p[6], p[7], p[8], C};
    s.out = StridedRows{p[9], p[10], p[11], p[12], p[13], p[14], C};
    if (s.n_seqs <= 0 || s.in.per <= 0 || s.in.n2 <= 0 || s.out.per <= 0 || s.out.n2 <= 0)
      return cudaErrorInvalidValue;
    int seqs = 0, bytes = 0;
    err = (cudaError_t)plan_tile(s.L, C, HID, &seqs, &bytes);
    if (err != cudaSuccess) return err;
    s.seqs_per_tile = seqs;
    s.rt = (seqs * s.L + 15) / 16;
    s.src = i == 0 ? 0 : 2 + (i - 1) % 2;
    s.dst = i == n_steps - 1 ? 1 : 2 + i % 2;
    if (bytes > smem) smem = bytes;
    const int tiles = (s.n_seqs + seqs - 1) / seqs;
    if (tiles > max_tiles) max_tiles = tiles;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // A cooperative grid must be co-resident: size it from the occupancy at
  // the real dynamic shared memory.
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms;
  if (grid > max_tiles) grid = max_tiles;
  void* args[] = {&A, &C, &HID, &heads};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- the tensor-parallel halves ---------------------------------------------
//
// The block split at its two all-reduces (Megatron layout): each tp rank holds
// a head shard of wq/wk/wv (C x CA columns, CA = C / tp) with the matching rows
// of wo (CA x C), and a hidden shard of w1 (C x HL) / b1 with the rows of w2
// (HL x C).  Each half writes the rank's PRE-BIAS partial (M, C) in bf16; the
// caller all-reduces it over tp and adds bias and residual.  The same device
// functions as block_tile, on narrower tiles: the LayerNorm overwrites x in
// place (a half has no residual), q/k/v/h are CA or HL wide, and the last
// matmul's epilogue stores the f32 accumulator rounded once to bf16, with no
// bias and no residual.

enum { A_LN1S, A_LN1B, A_WQ, A_BQ, A_WK, A_BK, A_WV, A_BV, A_WO, A_NPARAMS };
enum { M_LN2S, M_LN2B, M_W1, M_B1, M_W2, M_NPARAMS };

struct HalfParams {
  const bf16* p[A_NPARAMS];
};

__host__ __device__ constexpr size_t attn_half_smem(int rows, int C, int CA, int L) {
  // row tile of x (LayerNorm in place), q (-> attention out), k, v; staging; scratch.
  return (size_t)rows * (C + kPad) * sizeof(bf16) + (size_t)3 * rows * (CA + kPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float) + scratch_bytes(L);
}

__host__ __device__ constexpr size_t mlp_half_smem(int rows, int C, int HL) {
  return (size_t)rows * (C + kPad) * sizeof(bf16) + (size_t)rows * (HL + kPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float) + scratch_bytes(1);
}

// Gather `rows_valid` contiguous rows of width C into a shared tile (zeros below).
__device__ __forceinline__ void load_rows(const bf16* x, bf16* sX, int ldx, int R, int rows_valid,
                                          int C) {
  const int vec_per_row = C / 8;
  for (int idx = threadIdx.x; idx < R * vec_per_row; idx += kThreads) {
    const int r = idx / vec_per_row, c8 = idx - r * vec_per_row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) v = *reinterpret_cast<const uint4*>(x + (size_t)r * C + c8 * 8);
    *reinterpret_cast<uint4*>(sX + r * ldx + c8 * 8) = v;
  }
}

// One tile of whole length-L sequences of (S, L, C): LN1, the local q/k/v
// (CA columns, heads local heads of d = CA / heads), attention, and the
// out-projection partial (K = CA, N = C).
template <int RT, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
attn_half_kernel(const bf16* x, bf16* y, HalfParams P, int n_seqs, int seqs_per_tile, int L,
                 int C, int CA, int heads, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = RT * 16;
  const int ldx = C + kPad, lda = CA + kPad;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sQ = sX + R * ldx;
  bf16* sK = sQ + R * lda;
  bf16* sV = sK + R * lda;
  float* sStage = reinterpret_cast<float*>(sV + R * lda);
  float* sScratch = sStage + kWarps * 256;
  bf16* sRing = reinterpret_cast<bf16*>(sScratch);

  const int seq0 = blockIdx.x * seqs_per_tile;
  const int rows_valid = min(seqs_per_tile, n_seqs - seq0) * L;
  const size_t row0 = (size_t)seq0 * L;
  load_rows(x + row0 * C, sX, ldx, R, rows_valid, C);
  __syncthreads();
  layer_norm(sX, sX, ldx, R, C, P.p[A_LN1S], P.p[A_LN1B]);
  __syncthreads();
  gemm<RT>(sX, ldx, P.p[A_WQ], P.p[A_BQ], C, CA, sStage, sRing, EpiStore{sQ, lda});
  gemm<RT>(sX, ldx, P.p[A_WK], P.p[A_BK], C, CA, sStage, sRing, EpiStore{sK, lda});
  gemm<RT>(sX, ldx, P.p[A_WV], P.p[A_BV], C, CA, sStage, sRing, EpiStore{sV, lda});
  __syncthreads();
  const int d = CA / heads;
  if (L % 16 == 0) {
    const int nseq = rows_valid / L;
    if (d == 32)
      attention_mma<32, SAFE>(sQ, sK, sV, sScratch, sStage, lda, nseq, L, heads, causal);
    else if (d == 64)
      attention_mma<64, SAFE>(sQ, sK, sV, sScratch, sStage, lda, nseq, L, heads, causal);
    else
      attention_mma<16, SAFE>(sQ, sK, sV, sScratch, sStage, lda, nseq, L, heads, causal);
  } else {
    if (d == 32)
      attention_fma<32, SAFE>(sQ, sK, sV, lda, R, rows_valid, L, heads, causal);
    else if (d == 64)
      attention_fma<64, SAFE>(sQ, sK, sV, lda, R, rows_valid, L, heads, causal);
    else
      attention_fma<16, SAFE>(sQ, sK, sV, lda, R, rows_valid, L, heads, causal);
  }
  __syncthreads();
  gemm<RT>(sQ, lda, P.p[A_WO], nullptr, CA, C, sStage, sRing,
           EpiRows{y + row0 * C, C, rows_valid});
}

// One tile of R rows of (M, C): LN2, fc1 (HL columns) + b1 + tanh-GELU, and
// the fc2 partial (K = HL, N = C).
template <int RT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_half_kernel(const bf16* x, bf16* y, HalfParams P, int M, int C, int HL) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = RT * 16;
  const int ldx = C + kPad, ldh = HL + kPad;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sH = sX + R * ldx;
  float* sStage = reinterpret_cast<float*>(sH + R * ldh);
  bf16* sRing = reinterpret_cast<bf16*>(sStage + kWarps * 256);

  const size_t row0 = (size_t)blockIdx.x * R;
  const int rows_valid = min(R, M - (int)row0);
  load_rows(x + row0 * C, sX, ldx, R, rows_valid, C);
  __syncthreads();
  layer_norm(sX, sX, ldx, R, C, P.p[M_LN2S], P.p[M_LN2B]);
  __syncthreads();
  gemm<RT>(sX, ldx, P.p[M_W1], P.p[M_B1], C, HL, sStage, sRing, EpiGelu{sH, ldh});
  __syncthreads();
  gemm<RT>(sH, ldh, P.p[M_W2], nullptr, HL, C, sStage, sRing, EpiRows{y + row0 * C, C, rows_valid});
}

// What both halves take: C a LayerNorm width the registers hold and a matmul
// depth, the local widths whole 32-column warp passes.
bool half_dims_ok(int C, int local) {
  return C % 64 == 0 && C <= kMaxC && local % 32 == 0 && local >= 32 && local <= 2 * C;
}

int optin_smem(int device, int* optin) {
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

template <bool SAFE>
int launch_attn_half(const void* x, void* y, const void* const* w, int n_seqs, int L, int C,
                     int CA, int heads, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!half_dims_ok(C, CA) || CA > C || !head_dim_ok(CA, heads) || L < 1 || L > kMaxRows)
    return cudaErrorInvalidValue;
  int optin = 0;
  err = (cudaError_t)optin_smem(device, &optin);
  if (err != cudaSuccess) return err;
  int seqs = 0;
  size_t smem = 0;
  for (int s = kMaxRows / L; s >= 1 && !seqs; --s) {
    const size_t bytes = attn_half_smem((s * L + 15) / 16 * 16, C, CA, L);
    if (bytes <= (size_t)optin) seqs = s, smem = bytes;
  }
  if (!seqs) return cudaErrorInvalidValue;
  if (n_seqs <= 0) return cudaSuccess;
  HalfParams P;
  for (int i = 0; i < A_NPARAMS; ++i) P.p[i] = static_cast<const bf16*>(w[i]);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n_seqs + seqs - 1) / seqs;
#define TANTE_ATTN_HALF(RT)                                                                    \
  {                                                                                            \
    auto k = attn_half_kernel<RT, SAFE>;                                                       \
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);    \
    if (err != cudaSuccess) return err;                                                        \
    k<<<grid, kThreads, smem, st>>>(xb, yb, P, n_seqs, seqs, L, C, CA, heads, causal);        \
    return cudaGetLastError();                                                                 \
  }
  switch ((seqs * L + 15) / 16) {
    case 1: TANTE_ATTN_HALF(1)
    case 2: TANTE_ATTN_HALF(2)
    case 3: TANTE_ATTN_HALF(3)
    case 4: TANTE_ATTN_HALF(4)
    default: return cudaErrorInvalidValue;
  }
#undef TANTE_ATTN_HALF
}

int launch_mlp_half(const void* x, void* y, const void* const* w, int M, int C, int HL,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!half_dims_ok(C, HL)) return cudaErrorInvalidValue;
  int optin = 0;
  err = (cudaError_t)optin_smem(device, &optin);
  if (err != cudaSuccess) return err;
  int rt = 0;
  for (int r = kMaxRows / 16; r >= 1 && !rt; --r)
    if (mlp_half_smem(16 * r, C, HL) <= (size_t)optin) rt = r;
  if (!rt) return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  const size_t smem = mlp_half_smem(16 * rt, C, HL);
  HalfParams P;
  for (int i = 0; i < M_NPARAMS; ++i) P.p[i] = static_cast<const bf16*>(w[i]);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (M + 16 * rt - 1) / (16 * rt);
#define TANTE_MLP_HALF(RT)                                                                     \
  {                                                                                            \
    auto k = mlp_half_kernel<RT>;                                                              \
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);    \
    if (err != cudaSuccess) return err;                                                        \
    k<<<grid, kThreads, smem, st>>>(xb, yb, P, M, C, HL);                                      \
    return cudaGetLastError();                                                                 \
  }
  switch (rt) {
    case 1: TANTE_MLP_HALF(1)
    case 2: TANTE_MLP_HALF(2)
    case 3: TANTE_MLP_HALF(3)
    case 4: TANTE_MLP_HALF(4)
    default: return cudaErrorInvalidValue;
  }
#undef TANTE_MLP_HALF
}

}  // namespace

extern "C" {

// x, y: (B, T, H, W, C) bf16, HW = H*W; causal over T; w: host array of the
// 16 BlockParams device pointers (bf16, wq/bq prescaled).  Returns a
// cudaError_t (0 = launched).
int tante_fused_block_canon_t_fwd(const void* x, void* y, const void* const* w, int B, int T,
                                  int HW, int C, int HID, int heads, int device, void* stream) {
  return launch(x, y, w, CanonTRows{T, HW, C}, B * HW, T, C, HID, heads, 1, device, stream);
}

// A run of n_steps blocks on one tensor of B*T*H*W rows in one cooperative
// launch.  x: the input in the first block's read order; y: the output in
// the last block's write order; buf0, buf1: scratch of the same size
// (unused for n_steps == 1 / 2); w: host array of n_steps * 16 device
// pointers; plan: host array of n_steps * 15 ints (see launch_chain).
int tante_fused_chain_fwd(const void* x, void* y, void* buf0, void* buf1, const void* const* w,
                          const int* plan, int n_steps, int C, int HID, int heads, int safe,
                          int device, void* stream) {
  return (safe ? launch_chain<true> : launch_chain<false>)(x, y, buf0, buf1, w, plan, n_steps, C,
                                                           HID, heads, device, stream);
}

// Tensor-parallel attention half: x (S, L, C) bf16 -> y (S, L, C) bf16, the
// rank's pre-bias out-projection partial.  w: host array of 9 device pointers
// (ln1_scale, ln1_bias, wq, bq, wk, bk, wv, bv, wo), wq/wk/wv (C, CA), wo
// (CA, C), wq/bq prescaled by d^-0.5*log2(e); `heads` local heads.
int tante_attn_half_fwd(const void* x, void* y, const void* const* w, int n_seqs, int L, int C,
                        int CA, int heads, int causal, int safe, int device, void* stream) {
  return (safe ? launch_attn_half<true> : launch_attn_half<false>)(x, y, w, n_seqs, L, C, CA,
                                                                   heads, causal, device, stream);
}

// Tensor-parallel MLP half: x (M, C) bf16 -> y (M, C) bf16, the rank's
// pre-bias fc2 partial.  w: 5 device pointers (ln2_scale, ln2_bias, w1 (C, HL),
// b1 (HL), w2 (HL, C)).
int tante_mlp_half_fwd(const void* x, void* y, const void* const* w, int M, int C, int HL,
                       int device, void* stream) {
  return launch_mlp_half(x, y, w, M, C, HL, device, stream);
}

// The tile plan a launch with these sizes uses (for reports).
int tante_fused_block_plan(int L, int C, int HID, int* seqs_per_cta, int* smem_bytes_out) {
  return plan_tile(L, C, HID, seqs_per_cta, smem_bytes_out);
}

#ifdef TANTE_PHASE_TIMING
// Copies the phase stamps of the first n CTAs of the last launch to host
// memory (n x kPhases nanosecond timestamps).
int tante_phase_read(unsigned long long* host, int n) {
  if (n > kPhaseCtas) n = kPhaseCtas;
  return cudaMemcpyFromSymbol(host, g_phase_ns, sizeof(unsigned long long) * kPhases * n);
}
#endif

}  // extern "C"
