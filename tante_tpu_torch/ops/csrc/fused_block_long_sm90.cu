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

#include "block_sm90.cuh"

namespace {

constexpr int kQRows = 64;       // queries of an attention tile
constexpr int kKeyBlk = 64;      // keys of a streamed k|v block
constexpr int kQLd = 64 + 8;     // bf16 row stride of the staged q tile (bank spread)
constexpr int kKvLd = 128 + 8;   // bf16 row stride of a k|v block: k columns 0-63, v 64-127
constexpr int kQLdF = 64 + 4;    // the same in f32
constexpr int kKvLdF = 128 + 4;

// One launch of either entry.  ws: (3, n_seqs, C/64, L, 64) q|k|v in the
// activation type.  sh: C, HID, R (the qkv entry's tile rows; 64 in the
// attention entry), stages and the column passes of the block's four
// matmuls.
struct LongArgs {
  const void* p[kNPtr];
  Shape sh;
  const void* x;
  void* ws;
  void* y;
  int n_seqs, L, tokens, causal, qtiles;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~(size_t)127; }

// The qkv entry: the LN1 output (a), the q|k|v tile of a head group (b), the
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One head group's q|k|v of the tile's `valid` token rows (from row0), from
// the row-major tile `src` (ld elements a row: q at columns 0-63, k 64-127,
// v 128-191) to the workspace, in 16-byte pieces.
template <class T>
__device__ void store_qkv(const T* src, int ld, const LongArgs& A, int gi, int row0, int valid) {
  constexpr int E = 16 / sizeof(T);  // elements of a piece
  constexpr int P = 64 / E;          // pieces of a part's 64 columns
  const int G = A.sh.C / 64;
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

// ---- the qkv entry --------------------------------------------------------------

// The entries' layouts (block_cta's Plan).
template <bool F32>
struct QkvPlan {
  __device__ static Layout layout(const Shape& S) {
    return layout_qkv(F32, F32 ? kRowsF : S.R, S.C, S.stages);
  }
  __device__ static int stage_bytes(const Shape&) {
    return F32 ? kSlabKF * kQkvN * 4 : kSlabK * kQkvN * 2;
  }
};
template <bool F32>
struct AttnPlan {
  __device__ static Layout layout(const Shape& S) {
    return layout_attn(F32, S.C, S.HID, S.np, S.stages);
  }
  __device__ static int stage_bytes(const Shape& S) {
    return (F32 ? kSlabKF * 4 : kSlabK * 2) * tail_pass(S.np);
  }
};

// The weight stream of matmuls [m0, m1) of the block's schedule.
template <class T>
__device__ __forceinline__ void produce_range(const LongArgs& A, Ring& ring, int m0, int m1) {
  int idx = 0;
  produce_tile<T>(static_cast<const unsigned char*>(A.p[WARR]), A.sh, ring, idx, m0, m1);
}

__global__ void __launch_bounds__(kThreads, 1) block_long_qkv_kernel(const __grid_constant__ LongArgs A) {
  const Shape& S = A.sh;
  const int groups = S.C / 64;
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
          store_qkv<bf16>(sQkv, kQkvLd, A, gi, row0, valid);
          consumers_sync();  // the next group's projection overwrites q|k|v
        }
      });
}

__global__ void __launch_bounds__(kThreads, 1) block_long_qkv_f32_kernel(const __grid_constant__ LongArgs A) {
  const Shape& S = A.sh;
  const int groups = S.C / 64;
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
          store_qkv<float>(sQkv, kQkvLdF, A, gi, row0, valid);
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
// Output: the attention-output tile ao (core-matrix layout, C wide) at head
// column (gi*64/D + j)*D; rows past `valid` get zeros.
template <int D, bool SAFE>
__device__ void attention_long(const LongArgs& A, int s, int gi, int q0, int valid, bf16* sQ,
                               bf16* sKV, bf16* ao) {
  constexpr int HG = 64 / D;
  constexpr int ITEMS = (kQRows / 16) * HG;
  constexpr int IPW = (ITEMS + 7) / 8;  // items a warp holds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int G = A.sh.C / 64, L = A.L, causal = A.causal, C = A.sh.C;
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
        *reinterpret_cast<uint32_t*>(ao + blk(r0 + g + 8 * h, hc * D + nn * 8 + 2 * t, C)) =
            pack_bf16(o[m][nn][2 * h] * inv[h], o[m][nn][2 * h + 1] * inv[h]);
  }
}

// f32: one thread per (query row, head of the group), its admitted keys of
// each block in order (scores with four partial sums), attention_group_f32's
// arithmetic.  Output to the attention-output tile (ld_f(C)) at head column
// (gi*64/D + j)*D; rows past `valid` get zeros.
template <int D, bool SAFE>
__device__ void attention_long_f32(const LongArgs& A, int s, int gi, int q0, int valid,
                                   float* sQ, float* sKV, float* ao) {
  constexpr int HG = 64 / D;
  const int G = A.sh.C / 64, L = A.L, causal = A.causal;
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
    float* out = ao + i * ld_f(A.sh.C) + (gi * HG + j) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(out + d) =
          make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
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
          attention_long<D, SAFE>(A, s, gi, q0, valid, sA, sKV, sB);
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
          attention_long_f32<D, SAFE>(A, s, gi, q0, valid, sA, sKV, sB);
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

template <class K>
cudaError_t launch_kernel(K k, const LongArgs& A, int grid, long long smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return cudaGetLastError();
}

// The checks both entries share; fills A.  0 = launch, else a cudaError_t
// (or -1: nothing to run).
int prepare(LongArgs& A, long long& smem, const void* const* w, const int* plan, int n_seqs,
            int L, int C, int HID, bool f32, bool attn, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  A = LongArgs{};
  smem = long_shape(A.sh, plan, C, HID, f32, attn);
  const long long tokens = (long long)n_seqs * L;
  if (!smem || L < 1 || n_seqs < 0 || tokens >= (1ll << 31)) return cudaErrorInvalidValue;
  err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  for (int k = 0; k < kNPtr; ++k) A.p[k] = w[k];
  A.n_seqs = n_seqs;
  A.L = L;
  A.tokens = (int)tokens;
  A.qtiles = (L + kQRows - 1) / kQRows;
  if ((long long)n_seqs * A.qtiles >= (1ll << 31)) return cudaErrorInvalidValue;
  return n_seqs == 0 ? -1 : 0;
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
