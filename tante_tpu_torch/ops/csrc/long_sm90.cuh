// What the two kernel pairs for sequences longer than a tile share: the long
// block (fused_block_long_sm90.cu) and the tensor-parallel attention half at
// L > 64 (fused_half_long_sm90.cu).  Each pair is a qkv kernel (LN1 and the
// q|k|v products of token tiles into a workspace laid out head group by head
// group) and an attention kernel.  The qkv body (long_qkv, long_qkv_f32) is
// both pairs'.  The streamed attention below (attention_long,
// attention_long_f32: one CTA per sequence and 64-query tile, the keys in
// blocks of 64 through a two-stage cp.async ring behind two CTA barriers a
// block, the f32 scores and AV on FFMA) is the long half's only: the long
// block's attention entry has its own persistent design in
// fused_block_long_sm90.cu (work items on a producer-fed mbarrier ring,
// wgmma scores in bf16, 3xTF32 in f32), which the half is to take next
// (ROADMAP).  What bounds this first design: latency, 5.6-7.1% of the bf16
// bound at the flagship (PERF.md).
//
// Widths.  C is the LayerNorm's (the token width); W is the attention width,
// a multiple of 64: W = C for the block, the shard's local width padded to
// whole 64-column head groups for the half (carried in Shape's HID: the
// half has no MLP).  The workspace is (3, S, W/64, L, 64); the attention
// output tile is 64 x W.  The block's kernels read W as C
// (attn_width<false>), which compiles to the code they had before W existed.

#pragma once

#include "block_sm90.cuh"

namespace {

constexpr int kQRows = 64;       // queries of an attention tile
constexpr int kKeyBlk = 64;      // keys of a streamed k|v block
constexpr int kQLd = 64 + 8;     // bf16 row stride of the staged q tile (bank spread)
constexpr int kKvLd = 128 + 8;   // bf16 row stride of a k|v block: k columns 0-63, v 64-127
constexpr int kQLdF = 64 + 4;    // the same in f32
constexpr int kKvLdF = 128 + 4;

// One launch of either kernel of a pair.  ws: (3, n_seqs, W/64, L, 64) q|k|v
// in the activation type.  sh: C, HID (the block's MLP width; the half, which
// has no MLP, carries W there), R (the qkv kernel's tile rows; 64 in the
// attention kernel), stages and the column passes.
struct LongArgs {
  const void* p[kNPtr];
  Shape sh;
  const void* x;
  void* ws;
  void* y;
  int n_seqs, L, tokens, causal, qtiles;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~(size_t)127; }

// The attention width W of a launch: C for the block, HID for the half.
template <bool HALF>
__device__ __forceinline__ int attn_width(const LongArgs& A) {
  return HALF ? A.sh.HID : A.sh.C;
}

// The qkv kernel: the LN1 output (a), the q|k|v tile of a head group (b), the
// slab ring, its barriers.
__host__ __device__ inline Layout layout_qkv(bool f32, int R, int C, int stages) {
  Layout l{};
  const size_t xn = f32 ? (size_t)R * ld_f(C) * 4 : (size_t)R * C * 2;
  const size_t qkv = f32 ? (size_t)R * kQkvLdF * 4 : (size_t)R * kQkvLd * 2;
  l.b = align128(xn);
  l.ring = align128(l.b + qkv);
  l.bars = l.ring + (size_t)stages * (f32 ? kSlabKF * kQkvN * 4 : kSlabK * kQkvN * 2);
  l.total = l.bars + 2 * kMaxStages * sizeof(uint64_t);
  return l;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One head group's q|k|v of the tile's `valid` token rows (from row0), from
// the row-major tile `src` (ld elements a row: q at columns 0-63, k 64-127,
// v 128-191) to the workspace of W/64 groups, in 16-byte pieces.
template <class T, bool HALF>
__device__ void store_qkv(const T* src, int ld, const LongArgs& A, int gi, int row0, int valid) {
  constexpr int E = 16 / sizeof(T);  // elements of a piece
  constexpr int P = 64 / E;          // pieces of a part's 64 columns
  const int G = attn_width<HALF>(A) / 64;
  const size_t part = (size_t)A.n_seqs * G * A.L * 64;
  T* ws = static_cast<T*>(A.ws);
  for (int i = threadIdx.x; i < valid * 3 * P; i += kConsumers) {
    const int r = i / (3 * P), k = i - r * (3 * P), which = k / P, piece = k - which * P;
    const int tok = row0 + r, s = tok / A.L, pos = tok - s * A.L;
    T* dst = ws + which * part + (((size_t)s * G + gi) * A.L + pos) * 64 + piece * E;
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + r * ld + which * 64 + piece * E);
  }
}

// ---- the qkv kernels -------------------------------------------------------------

// The qkv kernel's layout (block_cta's Plan): the same for the block and the half.
template <bool F32>
struct QkvPlan {
  __device__ static Layout layout(const Shape& S) {
    return layout_qkv(F32, F32 ? kRowsF : S.R, S.C, S.stages);
  }
  __device__ static int stage_bytes(const Shape&) {
    return F32 ? kSlabKF * kQkvN * 4 : kSlabK * kQkvN * 2;
  }
};

// The weight stream of matmuls [m0, m1) of the block's schedule.  The first
// C/64 matmuls are head groups' q|k|v (K = C, N = 192), so [0, W/64) is also
// the half's q|k|v stream: its slabs lead with its W/64 groups.
template <class T>
__device__ __forceinline__ void produce_range(const LongArgs& A, Ring& ring, int m0, int m1) {
  int idx = 0;
  produce_tile<T>(static_cast<const unsigned char*>(A.p[WARR]), A.sh, ring, idx, m0, m1);
}

// LN1 over C of a tile of token rows, then the q|k|v of each of the W/64 head
// groups (+ bias, rounded to bf16) into the workspace.
template <bool HALF>
__device__ __forceinline__ void long_qkv(const LongArgs& A) {
  const Shape& S = A.sh;
  const int groups = attn_width<HALF>(A) / 64;
  block_cta<bf16, QkvPlan<false>>(
      S, [&](Ring& ring) { produce_range<bf16>(A, ring, 0, groups); },
      [&](Ring& ring, bf16* sA, bf16* sQkv, bf16*) {
        const int row0 = blockIdx.x * S.R;
        const int valid = min(S.R, A.tokens - row0);
        const ContigTile rows{(size_t)row0 * S.C, S.C};
        layer_norm(static_cast<const bf16*>(A.x), rows, valid, sA, S.R, S.C,
                   static_cast<const bf16*>(A.p[LN1S]), static_cast<const bf16*>(A.p[LN1B]));
        fence_async_smem();
        consumers_sync();
        for (int gi = 0; gi < groups; ++gi) {
          gemm_np(sA, S.C, kQkvN, S.np[0], S.R, ring,
                  EpiQkv{sQkv, static_cast<const bf16*>(A.p[BQKV]) + gi * kQkvN}, 0, blockIdx.x);
          consumers_sync();
          store_qkv<bf16, HALF>(sQkv, kQkvLd, A, gi, row0, valid);
          consumers_sync();  // the next group's projection overwrites q|k|v
        }
      });
}

// The same in f32 (64-row tiles, 3xTF32 products).
template <bool HALF>
__device__ __forceinline__ void long_qkv_f32(const LongArgs& A) {
  const Shape& S = A.sh;
  const int groups = attn_width<HALF>(A) / 64;
  block_cta<float, QkvPlan<true>>(
      S, [&](Ring& ring) { produce_range<float>(A, ring, 0, groups); },
      [&](Ring& ring, float* sA, float* sQkv, float*) {
        const int row0 = blockIdx.x * kRowsF;
        const int valid = min(kRowsF, A.tokens - row0);
        const ContigTile rows{(size_t)row0 * S.C, S.C};
        layer_norm_f32(static_cast<const float*>(A.x), rows, valid, sA, S.C,
                       static_cast<const float*>(A.p[LN1S]), static_cast<const float*>(A.p[LN1B]));
        consumers_sync();
        for (int gi = 0; gi < groups; ++gi) {
          gemm_f32<3>(sA, S.C, kQkvN, valid, ring,
                      EpiQkvF{sQkv, static_cast<const float*>(A.p[BQKV]) + gi * kQkvN});
          consumers_sync();
          store_qkv<float, HALF>(sQkv, kQkvLdF, A, gi, row0, valid);
          consumers_sync();
        }
      });
}

// ---- attention over streamed keys ---------------------------------------------------
//
// Stage (into shared memory, by cp.async; rows past the sequence zeroed) the
// q tile of head group gi, then the group's k|v blocks.  `base` is the
// group's q of sequence s in the workspace; k and v sit `part` and 2*part
// elements further.  Steps run the key blocks once ("fast") or twice
// ("safe": maxima, then weights), loading step n + 1 while step n computes.

template <class T>
struct Staging {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int qld = sizeof(T) == 2 ? kQLd : kQLdF;
  static constexpr int kvld = sizeof(T) == 2 ? kKvLd : kKvLdF;
  const T* base;
  size_t part;
  int L, q0, valid;
  __device__ void load_q(T* sQ) const {
    for (int i = threadIdx.x; i < kQRows * (64 / E); i += kConsumers) {
      const int r = i / (64 / E), c = (i - r * (64 / E)) * E;
      T* dst = sQ + r * qld + c;
      if (r < valid)
        cp_async16(dst, base + (size_t)(q0 + r) * 64 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ void load_kv(T* dst0, int key0) const {
    for (int i = threadIdx.x; i < kKeyBlk * (128 / E); i += kConsumers) {
      const int r = i / (128 / E), c = (i - r * (128 / E)) * E;  // c < 64: k, else v
      T* dst = dst0 + r * kvld + c;
      if (key0 + r < L)
        cp_async16(dst, base + (c < 64 ? part : 2 * part) + (size_t)(key0 + r) * 64 + (c & 63));
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// bf16: item = (16-query block, head of the group) on one warp, the
// single-block kernel's fragments.  A warp keeps its items' outputs and
// denominators (and, safe, maxima) in registers across the key blocks.
// Output: the attention-output tile ao (core-matrix layout, W wide) at head
// column (gi*64/D + j)*D; rows past `valid` get zeros.  A zero head (a padded
// shard's: q = k = v = 0) gets 0: its weights are finite, its values 0.
template <int D, bool SAFE>
__device__ void attention_long(const LongArgs& A, int s, int gi, int q0, int valid, bf16* sQ,
                               bf16* sKV, bf16* ao, int W) {
  constexpr int HG = 64 / D;
  constexpr int ITEMS = (kQRows / 16) * HG;
  constexpr int IPW = (ITEMS + 7) / 8;  // items a warp holds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int G = W / 64, L = A.L, causal = A.causal;
  const float clamp = 60.f * kLog2e;
  const Staging<bf16> st{static_cast<const bf16*>(A.ws) + ((size_t)s * G + gi) * L * 64,
                         (size_t)A.n_seqs * G * L * 64, L, q0, valid};
  const int kend = causal ? q0 + valid : L;  // keys any query of the tile admits
  const int nkb = (kend + kKeyBlk - 1) / kKeyBlk;
  const int steps = (SAFE ? 2 : 1) * nkb;

  float o[IPW][D / 8][4], den[IPW][2], mx[IPW][2];
  uint32_t qa[IPW][D / 16][4];
#pragma unroll
  for (int m = 0; m < IPW; ++m) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
    den[m][0] = den[m][1] = 0.f;
    mx[m][0] = mx[m][1] = -1e30f;
  }

  st.load_q(sQ);
  st.load_kv(sKV, 0);
  cp_async_commit();
  for (int n = 0; n < steps; ++n) {
    if (n + 1 < steps) {
      st.load_kv(sKV + ((n + 1) & 1) * kKeyBlk * kKvLd, ((n + 1) % nkb) * kKeyBlk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    consumers_sync();  // step n's block (and at n = 0 the q tile) in place
    const bf16* kv = sKV + (n & 1) * kKeyBlk * kKvLd;
    const int key0 = (n % nkb) * kKeyBlk;
    const bool weigh = !SAFE || n >= nkb;  // safe: the first pass takes maxima only
    if (SAFE && n == nkb) {
#pragma unroll
      for (int m = 0; m < IPW; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(0xffffffffu, mx[m][h], 1));
          mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(0xffffffffu, mx[m][h], 2));
        }
    }
#pragma unroll
    for (int m = 0; m < IPW; ++m) {
      const int item = warp + 8 * m;
      if (item >= ITEMS) break;
      const int qb = item / HG, j = item - qb * HG, r0 = qb * 16;
      if (n == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qa[m][kk], sQ + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kQLd + j * D +
                                 kk * 16 + 8 * (lane >> 4));
      }
      // Keys this query block may admit: below the sequence's end, and
      // (causal) up to its last query.
      const int khi = causal ? min(L, q0 + r0 + 16) : L;
      if (r0 >= valid || key0 >= khi) continue;
      float sc[4][2][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[kc][nt][e] = 0.f;
        if (key0 + kc * 16 < khi) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t b[4];
            ldsm_x4(b, kv + (kc * 16 + (lane & 7) + 8 * (lane >> 4)) * kKvLd + j * D + kk * 16 +
                           8 * ((lane >> 3) & 1));
            mma16816(sc[kc][0], qa[m][kk], b[0], b[1]);
            mma16816(sc[kc][1], qa[m][kk], b[2], b[3]);
          }
        }
      }
      // The admitted keys of this thread's two query rows.
      int qi[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qi[h] = q0 + r0 + g + 8 * h;
        live[h] = r0 + g + 8 * h < valid;
      }
      auto admitted = [&](int h, int key) {
        return live[h] && key < L && (!causal || key <= qi[h]);
      };
      if (!weigh) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          if (key0 + kc * 16 < khi)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (admitted(e >> 1, key0 + kc * 16 + nt * 8 + 2 * t + (e & 1)))
                  mx[m][e >> 1] = fmaxf(mx[m][e >> 1], sc[kc][nt][e]);
        continue;
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (key0 + kc * 16 >= khi) continue;
        uint32_t pa[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float e4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sv = sc[kc][nt][e];
            const float ev = admitted(e >> 1, key0 + kc * 16 + nt * 8 + 2 * t + (e & 1))
                                 ? exp2f(SAFE ? sv - mx[m][e >> 1] : fminf(sv, clamp))
                                 : 0.f;
            den[m][e >> 1] += ev;
            e4[e] = ev;
          }
          pa[2 * nt] = pack_bf16(e4[0], e4[1]);      // row g, keys 8nt + 2t
          pa[2 * nt + 1] = pack_bf16(e4[2], e4[3]);  // row g + 8
        }
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          uint32_t b[4];
          ldsm_x4_t(b, kv + (kc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kKvLd + 64 + j * D +
                           dt * 16 + 8 * (lane >> 4));
          mma16816(o[m][2 * dt], pa, b[0], b[1]);
          mma16816(o[m][2 * dt + 1], pa, b[2], b[3]);
        }
      }
    }
    consumers_sync();  // no warp reads this stage when step n + 2 refills it
  }
#pragma unroll
  for (int m = 0; m < IPW; ++m) {
    const int item = warp + 8 * m;
    if (item >= ITEMS) break;
    const int qb = item / HG, j = item - qb * HG, r0 = qb * 16, hc = gi * HG + j;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      den[m][h] += __shfl_xor_sync(0xffffffffu, den[m][h], 1);
      den[m][h] += __shfl_xor_sync(0xffffffffu, den[m][h], 2);
      inv[h] = 1.f / (den[m][h] + 1e-30f);
    }
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(ao + blk(r0 + g + 8 * h, hc * D + nn * 8 + 2 * t, W)) =
            pack_bf16(o[m][nn][2 * h] * inv[h], o[m][nn][2 * h + 1] * inv[h]);
  }
}

// f32: one thread per (query row, head of the group), its admitted keys of
// each block in order (scores with four partial sums), attention_group_f32's
// arithmetic.  Output to the attention-output tile (ld_f(W)) at head column
// (gi*64/D + j)*D; rows past `valid` get zeros, a zero head 0.
template <int D, bool SAFE>
__device__ void attention_long_f32(const LongArgs& A, int s, int gi, int q0, int valid,
                                   float* sQ, float* sKV, float* ao, int W) {
  constexpr int HG = 64 / D;
  const int G = W / 64, L = A.L, causal = A.causal;
  const float clamp = 60.f * kLog2e;
  const Staging<float> st{static_cast<const float*>(A.ws) + ((size_t)s * G + gi) * L * 64,
                          (size_t)A.n_seqs * G * L * 64, L, q0, valid};
  const int kend = causal ? q0 + valid : L;
  const int nkb = (kend + kKeyBlk - 1) / kKeyBlk;
  const int steps = (SAFE ? 2 : 1) * nkb;
  const int item = threadIdx.x, j = item / kQRows, i = item - j * kQRows;
  const bool active = item < kQRows * HG && i < valid;
  const int qi = q0 + i;
  float o[D], q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = q[d] = 0.f;
  float den = 0.f, mx = -1e30f;

  st.load_q(sQ);
  st.load_kv(sKV, 0);
  cp_async_commit();
  for (int n = 0; n < steps; ++n) {
    if (n + 1 < steps) {
      st.load_kv(sKV + ((n + 1) & 1) * kKeyBlk * kKvLdF, ((n + 1) % nkb) * kKeyBlk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    consumers_sync();
    if (active) {
      if (n == 0) {
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 v = *reinterpret_cast<const float4*>(sQ + i * kQLdF + j * D + d);
          q[d] = v.x, q[d + 1] = v.y, q[d + 2] = v.z, q[d + 3] = v.w;
        }
      }
      const float* kv = sKV + (n & 1) * kKeyBlk * kKvLdF;
      const int key0 = (n % nkb) * kKeyBlk;
      int nk = min(kKeyBlk, L - key0);
      if (causal) nk = min(nk, qi - key0 + 1);
      const float* kb = kv + j * D;
      const float* vb = kv + 64 + j * D;
      auto score = [&](int key) {
        const float* kr = kb + key * kKvLdF;
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 v = *reinterpret_cast<const float4*>(kr + d);
          p0 = fmaf(q[d], v.x, p0);
          p1 = fmaf(q[d + 1], v.y, p1);
          p2 = fmaf(q[d + 2], v.z, p2);
          p3 = fmaf(q[d + 3], v.w, p3);
        }
        return (p0 + p1) + (p2 + p3);
      };
      if (SAFE && n < nkb) {
        for (int key = 0; key < nk; ++key) mx = fmaxf(mx, score(key));
      } else {
        for (int key = 0; key < nk; ++key) {
          const float sv = score(key);
          const float e = exp2f(SAFE ? sv - mx : fminf(sv, clamp));
          den += e;
          const float* vr = vb + key * kKvLdF;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 v = *reinterpret_cast<const float4*>(vr + d);
            o[d] = fmaf(e, v.x, o[d]);
            o[d + 1] = fmaf(e, v.y, o[d + 1]);
            o[d + 2] = fmaf(e, v.z, o[d + 2]);
            o[d + 3] = fmaf(e, v.w, o[d + 3]);
          }
        }
      }
    }
    consumers_sync();
  }
  if (item < kQRows * HG) {
    const float inv = 1.f / (den + 1e-30f);
    float* out = ao + i * ld_f(W) + (gi * HG + j) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(out + d) =
          make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

// ---- host side -------------------------------------------------------------------

template <class K>
cudaError_t launch_kernel(K k, const LongArgs& A, int grid, long long smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return cudaGetLastError();
}

// The checks every launch of a pair shares, once the plan's shared memory
// bytes (`smem`, 0 outside the kernels) are known; fills A's sizes.  0 =
// launch, -1 = nothing to run, else a cudaError_t.
int prepare_sizes(LongArgs& A, long long smem, int n_seqs, int L, int device) {
  const long long tokens = (long long)n_seqs * L;
  if (!smem || L < 1 || n_seqs < 0 || tokens >= (1ll << 31)) return cudaErrorInvalidValue;
  const cudaError_t err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  A.n_seqs = n_seqs;
  A.L = L;
  A.tokens = (int)tokens;
  A.qtiles = (L + kQRows - 1) / kQRows;
  if ((long long)n_seqs * A.qtiles >= (1ll << 31)) return cudaErrorInvalidValue;
  return n_seqs == 0 ? -1 : 0;
}

}  // namespace
