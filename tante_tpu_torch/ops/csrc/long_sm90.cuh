// What the two kernel pairs for sequences longer than a tile share: the long
// block (fused_block_long_sm90.cu) and the tensor-parallel attention half at
// L > 64 (fused_half_long_sm90.cu).  Each pair is a qkv kernel (LN1 and the
// q|k|v products of token tiles into a workspace laid out head group by head
// group) and an attention kernel.  Both pairs share:
// - the qkv body (long_qkv, long_qkv_f32);
// - the attention kernels' machinery (attn_cta and below): a persistent
//   grid over work items (R query rows of a sequence, every head group, then
//   the kernel's tail on those rows), three producer warps copying q and k|v
//   into an mbarrier ring released per consumer warp, bf16 QK^T on wgmma
//   with AV on mma.sync, f32 QK^T and AV as 3xTF32 mma.sync, and in bf16 the
//   pair items of a ragged last wave.  fused_block_long_sm90.cu's header
//   describes the design; each kernel brings its layout, weight stream and
//   tail (the block: out-projection, residual, LN2, MLP; the half: the
//   out-projection partial alone).
// What bounds the attention where the tail is light (the half, PERF.md):
// the softmax's ex2 on the SFU and, at head dim 16, the k|v copies.  Left
// for later (ROADMAP): k|v resident across a sequence's items, AV on wgmma,
// f32 products on wgmma's TF32, the qkv body's own redesign.
//
// Widths.  C is the LayerNorm's (the token width); W is the attention width,
// a multiple of 64: W = C for the block, the shard's local width padded to
// whole 64-column head groups for the half (carried in Shape's HID: the
// half has no MLP).  The workspace is (3, S, W/64, L, 64); the attention
// output tile is R x W.  The block's kernels read W as C
// (attn_width<false>), which compiles to the code they had before W existed.

#pragma once

#include "block_sm90.cuh"

namespace {

constexpr int kQRows = 64;       // query rows of an f32 item (and of a bf16 pair item)
constexpr int kKeyBlk = 64;      // keys of a streamed k|v block
constexpr int kQLdF = 64 + 4;    // f32 row stride of a q slot (bank spread)
constexpr int kKvLdF = 128 + 4;  // f32 row stride of a k|v stage: k columns 0-63, v 64-127

// One launch of either kernel of a pair.  ws: (3, n_seqs, W/64, L, 64) q|k|v
// in the activation type.  sh: C, HID (the block's MLP width; the half, which
// has no MLP, carries W there), R (the qkv kernel's tile rows; the
// attention kernel's item rows), stages and the column passes.  qtiles: the
// attention kernel's item tiles of a sequence.
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

// ---- the attention kernels ---------------------------------------------------------
//
// The block's attention entry and the half's attention kernel: one design,
// the attention width W a template switch (HALF: W = HID, else C), as the
// qkv body takes it (attn_width).  Each kernel supplies its shared-memory
// layout, its weight stream and its tail.

constexpr int kMaxKv = 4;     // k|v stages of an attention kernel's ring
constexpr int kMaxQ = 2;      // q slots
constexpr int kCopyWarp = 9;  // the first of the producer warps that copy q and k|v
constexpr int kCopyLanes = 96;  // warps 9-11

// Phase cycles of an attention kernel (measurement builds only,
// -DTANTE_PHASE_TIMING; tools/kernel_phases.py --long / --long-half, each
// library its own counters): per CTA, the SM
// cycles consumer thread 0 spent waiting for k|v stages, in the scores, the
// softmax, the AV product, waiting for q tiles, in the tail, at the barrier
// between an item's attention and its tail, in LN2 (the block's, part of
// the tail, with its barriers), and its items.  The tail's
// matmuls also count their slab waits, products and epilogues per CTA (the
// body's g_gemm_cycles, slot = blockIdx.x).
enum { PH_KV, PH_SCORES, PH_SOFTMAX, PH_AV, PH_Q, PH_TAIL, PH_BETWEEN, PH_LN2, PH_ITEMS,
       kLongPhases };
#ifdef TANTE_PHASE_TIMING
__device__ unsigned long long g_long_cycles[kPhaseSlots][kLongPhases];
// Thread 0's sums while the CTA runs (a shared-memory add keeps the counting
// off the phases it counts); added to g_long_cycles at the CTA's end.
__shared__ unsigned long long s_long_cycles[kLongPhases];
#define LCLK(v) const long long v = clock64()
#define LADD(k, dt)                                                        \
  do {                                                                     \
    if (threadIdx.x == 0) s_long_cycles[k] += (unsigned long long)(dt);    \
  } while (0)
#else
#define LCLK(v) \
  do {          \
  } while (0)
#define LADD(k, dt) \
  do {              \
  } while (0)
#endif

// An attention kernel's plan past the Shape: item rows, k|v stages, q slots,
// and (the block's) whether the tail's tiles overlap the q slots and the ring.
struct AttnPlan {
  int R, kv, qs, overlap;
  int keep;   // x' stays in shared memory (bf16: where one out-projection pass covers C)
  int tiles;  // R-row tiles (set by the launch: sequences x tiles of a sequence)
  int big;    // the first `big` tiles are one item each; each later tile is two
              // 64-row "pair" items (bf16, R = 128, no overlap: see pair_items)
};

// bf16 pair items' exchange area in the tail's tile h (free during the
// attention when the layout keeps h apart from the q slots and the ring): per
// consumer thread of the second warpgroup its outputs and denominators
// (at most 32 + 8 floats), then every consumer thread's row maxima (at most
// 8 floats; safe).
constexpr int kPairScratch = 128 * 40 * 4 + 256 * 8 * 4;

// Bytes of a q slot and of a k|v stage: bf16 core-matrix tiles of 64 columns
// (R x 64; k then v, 64 x 64 each), f32 row-major with 4 floats of padding
// (64 x 68; 64 x 132, k in columns 0-63, v 64-127).
__host__ __device__ inline size_t q_bytes(bool f32, int R) {
  return f32 ? (size_t)kQRows * kQLdF * 4 : (size_t)R * 64 * 2;
}
__host__ __device__ inline size_t kv_bytes(bool f32) {
  return f32 ? (size_t)kKeyBlk * kKvLdF * 4 : (size_t)kKeyBlk * 128 * 2;
}

// An attention kernel's shared memory: the attention output ao, the tail's
// tile h (at least a pair item's exchange area in bf16), x (the block's
// kept x'), the q slots, the k|v ring, the weight ring, the barriers
// (weight ring full / empty, k|v full / empty, q full / empty, the item's
// end); byte offsets, each region on 128 bytes (fused_block_long_sm90.cu:
// layout_attn, fused_half_long_sm90.cu:layout_half_attn).
struct AttnLayout {
  size_t ao, h, x, q, kv, ring, bars, total;
};
constexpr int kAttnBars = 2 * kMaxStages + 2 * kMaxKv + 2 * kMaxQ + 1;

// ---- work items, copies, rings ---------------------------------------------------

// Item i: sequence s, query rows [q0, q0 + valid) of a `rows`-row item
// (valid <= 0: an empty second half of a ragged tile, skipped by all),
// key blocks 0 .. nkb - 1 (the keys any of its queries admits); pair: a
// 64-row item whose warpgroups share the rows and alternate key blocks.
struct Item {
  int s, q0, valid, nkb, rows;
  bool pair;
};
__host__ __device__ __forceinline__ int attn_items(const AttnPlan& P) {
  return P.big + 2 * (P.tiles - P.big);
}
__device__ __forceinline__ Item item_at(const LongArgs& A, const AttnPlan& P, int i) {
  Item it;
  const int tile = i < P.big ? i : P.big + ((i - P.big) >> 1);
  it.s = tile / A.qtiles;
  it.q0 = (tile - it.s * A.qtiles) * P.R;
  it.pair = i >= P.big;
  it.rows = it.pair ? 64 : P.R;
  if (it.pair) it.q0 += ((i - P.big) & 1) * 64;
  it.valid = min(it.rows, A.L - it.q0);
  const int kend = A.causal ? it.q0 + it.valid : A.L;
  it.nkb = (kend + kKeyBlk - 1) / kKeyBlk;
  return it;
}

// The q slots, the k|v ring and their barriers.  Producer and consumers
// each count the q tiles (qi) and k|v blocks (ki) they have passed, so a
// slot's or stage's phase parity carries across groups and items.
struct Pipe {
  unsigned char* q;
  unsigned char* kv;
  uint64_t *qfull, *qempty, *kvfull, *kvempty, *done;
  int qs, kvs;
  size_t qb, kvb;
  int qi, ki;
};

// 16 bytes from global to shared memory; zeros where !ok (src-size 0).
__device__ __forceinline__ void cp_async16_z(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
// An arrival on `bar` once this thread's cp.async copies so far have landed
// (the barrier counts the producer warp's 32 lanes).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// A consumer warp is done with a slot or stage (one arrival per warp).  Its
// reads may have been wgmma's (async proxy) and the refill is cp.async; the
// tail's tiles (overlap) take the weight ring's bulk copies too.
__device__ __forceinline__ void warp_release(uint64_t* bar) {
  fence_async_smem();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// `rows` rows of 64 values (row r at src + r*64; zeros from row `valid` on)
// into a slot or stage by the copy lanes' 16-byte cp.async copies: bf16 into
// a core-matrix tile, f32 into rows `ld` floats apart.
template <class T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int rows, int valid,
                                          int lane) {
  constexpr int E = 16 / sizeof(T), P = 64 / E;  // values a piece, pieces a row
  for (int k = lane; k < rows * P; k += kCopyLanes) {
    const int r = k / P, c = (k - r * P) * E;
    const bool ok = r < valid;
    cp_async16_z(dst + (sizeof(T) == 4 ? r * ld + c : blk(r, c, 64)),
                 src + (size_t)(ok ? r : 0) * 64 + c, ok);
  }
}

// The producer's copy warps (kCopyLanes lanes, `lane` 0 .. kCopyLanes - 1):
// per item and head group (W/64 of them), the q tile of the item's rows,
// then the group's k|v blocks (twice for "safe"), each into the next free
// slot or stage, an arrival from each lane once its copies land.  `base` is the group's q of
// the sequence in the workspace; k and v sit `part` and 2 * part elements
// further.
template <class T, int PASSES, bool HALF>
__device__ void produce_qkv(const LongArgs& A, const AttnPlan& AP, Pipe& P) {
  const int lane = threadIdx.x - kCopyWarp * 32, G = attn_width<HALF>(A) / 64, L = A.L;
  constexpr bool F32 = sizeof(T) == 4;
  const size_t part = (size_t)A.n_seqs * G * L * 64;
  const T* ws = static_cast<const T*>(A.ws);
  const int items = attn_items(AP);
  int n = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_at(A, AP, i);
    if (it.valid <= 0) continue;
    if (AP.overlap && n > 0) mbar_wait(P.done, (n - 1) & 1);  // the last item's tail is done
    ++n;
    for (int gi = 0; gi < G; ++gi) {
      const T* base = ws + ((size_t)it.s * G + gi) * L * 64;
      {
        const int slot = P.qi % P.qs;
        if (P.qi >= P.qs) mbar_wait(&P.qempty[slot], ((P.qi / P.qs) - 1) & 1);
        copy_rows<T>(reinterpret_cast<T*>(P.q + slot * P.qb), kQLdF,
                     base + (size_t)it.q0 * 64, it.rows, L - it.q0, lane);
        cp_async_arrive(&P.qfull[slot]);
        ++P.qi;
      }
      for (int b = 0; b < PASSES * it.nkb; ++b) {
        const int st = P.ki % P.kvs, key0 = (b % it.nkb) * kKeyBlk;
        if (P.ki >= P.kvs) mbar_wait(&P.kvempty[st], ((P.ki / P.kvs) - 1) & 1);
        T* dst = reinterpret_cast<T*>(P.kv + st * P.kvb);
        const T* k = base + part + (size_t)key0 * 64;
        copy_rows<T>(dst, kKvLdF, k, kKeyBlk, L - key0, lane);
        copy_rows<T>(dst + (F32 ? 64 : 4096), kKvLdF, k + part, kKeyBlk, L - key0, lane);
        cp_async_arrive(&P.kvfull[st]);
        ++P.ki;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the warp
}

// ---- the softmax of one 16-key chunk ------------------------------------------
//
// A thread's 8 scores of a 16-query x 16-key chunk in mma's accumulator
// layout: element e is query row g + 8*((e >> 1) & 1), key key + 8*(e >> 2)
// + 2t + (e & 1).  MASKED: the chunk may hold keys past the sequence or (causal)
// after a row's query; else every key counts (a block inside the sequence and
// below the diagonal of all the warp's rows: no per-element test).  A row
// past the item's valid rows reads a zero q and weighs finite values that no
// store keeps.

// 2^x on the SFU (ex2.approx.ftz: results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool MASKED>
__device__ __forceinline__ bool admitted(int e, int key, int t, const int* qrow, int L,
                                         int causal) {
  if (!MASKED) return true;
  const int k = key + 8 * (e >> 2) + 2 * t + (e & 1);
  return k < L && (!causal || k <= qrow[(e >> 1) & 1]);
}

// Each row's largest admitted score (safe, first pass).
template <bool MASKED>
__device__ __forceinline__ void max16(const float* sc, int key, int t, const int* qrow, int L,
                                      int causal, float* mx) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (admitted<MASKED>(e, key, t, qrow, L, causal))
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
}

// The unnormalised weights p (0 where not admitted), summed into den in the
// order the first design summed them.
template <bool SAFE, bool MASKED>
__device__ __forceinline__ void weights16(const float* sc, float* p, int key, int t,
                                          const int* qrow, int L, int causal, const float* mx,
                                          float* den) {
  const float clamp = 60.f * kLog2e;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int h = (e >> 1) & 1;
    const float v = exp2_ftz(SAFE ? sc[e] - mx[h] : fminf(sc[e], clamp));
    p[e] = admitted<MASKED>(e, key, t, qrow, L, causal) ? v : 0.f;
    den[h] += p[e];
  }
}

// ---- bf16 attention of one head group (consumer warpgroups) -----------------------
//
// Warpgroup w takes rows [64w, 64w + 64) of the item (none past R or the
// item's valid rows), its warp l rows 16l .. 16l + 15 of those, every head
// of the group.  Per key block and head: S (64 x 64) by wgmma from the q slot
// and the k tile, then on the warp's fragment the maxima (safe, first pass)
// or the weights, P packed to bf16 and AV by mma.sync.  Output: the
// attention-output tile ao (core-matrix layout, W wide) at head column
// (gi*64/D + j)*D.

// One head's scores, weights and AV on a k|v block (MASKED as weights16).
template <int D, bool SAFE, bool MASKED>
__device__ __forceinline__ void head_block_bf16(const float* sc, const bf16* vt, int j, int key0,
                                                int khi_w, bool weigh, int lane, int t,
                                                const int* qrow, int L, int causal, float* mx,
                                                float* den, float (*o)[4]) {
  if (!weigh) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      if (!MASKED || key0 + kc * 16 < khi_w)
        max16<MASKED>(sc + 8 * kc, key0 + kc * 16, t, qrow, L, causal, mx);
    return;
  }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if (MASKED && key0 + kc * 16 >= khi_w) continue;
    float p[8];
    weights16<SAFE, MASKED>(sc + 8 * kc, p, key0 + kc * 16, t, qrow, L, causal, mx, den);
    // A fragment order: (g, k 0-7), (g+8, k 0-7), (g, k 8-15), (g+8, k 8-15).
    const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]), pack_bf16(p[4], p[5]),
                            pack_bf16(p[6], p[7])};
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t b[4];
      ldsm_x4_t(b, vt + blk(kc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1),
                            j * D + dt * 16 + 8 * (lane >> 4), 64));
      mma16816(o[2 * dt], pa, b[0], b[1]);
      mma16816(o[2 * dt + 1], pa, b[2], b[3]);
    }
  }
}

// S (64 x 64, f32) = q (the warpgroup's 64 rows of head j) k^T: D/16
// wgmma m64n64k16, the first with scale-d 0 (no accumulator to clear);
// committed as one group.
template <int D>
__device__ __forceinline__ void qk_wgmma(float* d, const bf16* sq, const bf16* kt, int j) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = wg_desc(sq + ((j * D + kk * 16) >> 3) * 64, 128, 1024);
    const uint64_t db = wg_desc(kt + ((j * D + kk * 16) >> 3) * 64, 128, 1024);
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(kk));
  }
  wg_commit();
}

template <int D, bool SAFE, bool HALF>
__device__ void attention_wg(const LongArgs& A, const Item& it, int gi, Pipe& P, bf16* ao,
                             float* scratch) {
  constexpr int HG = 64 / D;
  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = A.L, causal = A.causal, W = attn_width<HALF>(A), R = it.rows;
  const int r_wg = it.pair ? 0 : wg * 64, r0 = r_wg + wl * 16;
  const bool rows_here = r_wg < R && r_wg < it.valid;
  // Keys the warpgroup's rows, and the warp's, admit (exclusive).
  const int khi_wg = causal ? min(L, it.q0 + r_wg + 64) : L;
  const int khi_w = causal ? min(L, it.q0 + r0 + 16) : L;
  const int qrow[2] = {it.q0 + r0 + g, it.q0 + r0 + g + 8};

  float o[HG][D / 8][4], den[HG][2], mx[HG][2];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[j][n][0] = o[j][n][1] = o[j][n][2] = o[j][n][3] = 0.f;
    den[j][0] = den[j][1] = 0.f;
    mx[j][0] = mx[j][1] = -1e30f;
  }

  const int qslot = P.qi % P.qs;
  LCLK(tq0);
  mbar_wait(&P.qfull[qslot], (P.qi / P.qs) & 1);
  LCLK(tq1);
  LADD(PH_Q, tq1 - tq0);
  const bf16* sq = reinterpret_cast<const bf16*>(P.q + qslot * P.qb) + r_wg * 64;
  const int steps = (SAFE ? 2 : 1) * it.nkb;
  for (int n = 0; n < steps; ++n) {
    const int st = P.ki % P.kvs;
    LCLK(tw0);
    mbar_wait(&P.kvfull[st], (P.ki / P.kvs) & 1);
    LCLK(tw1);
    LADD(PH_KV, tw1 - tw0);
    const int b = n % it.nkb, key0 = b * kKeyBlk;
    const bool weigh = !SAFE || n >= it.nkb;  // safe: the first pass takes maxima only
    if (SAFE && n == it.nkb) {
#pragma unroll
      for (int j = 0; j < HG; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[j][h] = fmaxf(mx[j][h], __shfl_xor_sync(0xffffffffu, mx[j][h], 1));
          mx[j][h] = fmaxf(mx[j][h], __shfl_xor_sync(0xffffffffu, mx[j][h], 2));
        }
      if (it.pair) {  // each row's maximum over both warpgroups' blocks
        float* xm = scratch + 128 * 40;
#pragma unroll
        for (int j = 0; j < HG; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) xm[threadIdx.x * 8 + 2 * j + h] = mx[j][h];
        consumers_sync();
#pragma unroll
        for (int j = 0; j < HG; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mx[j][h] = fmaxf(mx[j][h], xm[(threadIdx.x ^ 128) * 8 + 2 * j + h]);
      }
    }
    // A pair item's warpgroup w weighs the key blocks b with b % 2 == w.
    const bool mine = !it.pair || (b & 1) == wg;
    if (rows_here && mine && key0 < khi_wg) {  // uniform over the warpgroup (wgmma)
      fence_async_smem();  // the cp.async copies (generic proxy) before wgmma reads them
      const bf16* kt = reinterpret_cast<const bf16*>(P.kv + st * P.kvb);
      const bf16* vt = kt + 4096;
      const bool masked = key0 + kKeyBlk > L || (causal && key0 + kKeyBlk - 1 > it.q0 + r0);
      // Accumulator: element 4*jt + e is row r0 + g + 8*(e >> 1), key
      // key0 + 8*jt + 2t + (e & 1); 8 elements a 16-key chunk.  Two
      // buffers: head j + 1's products run while head j is weighed.
      float sc[2][32];
      qk_wgmma<D>(sc[0], sq, kt, 0);
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        LCLK(ts0);
        if (j + 1 < HG) {
          qk_wgmma<D>(sc[(j + 1) & 1], sq, kt, j + 1);
          wg_wait<1>();
        } else {
          wg_wait<0>();
        }
        LCLK(ts1);
        LADD(PH_SCORES, ts1 - ts0);
        if (masked)
          head_block_bf16<D, SAFE, true>(sc[j & 1], vt, j, key0, khi_w, weigh, lane, t, qrow, L,
                                         causal, mx[j], den[j], o[j]);
        else
          head_block_bf16<D, SAFE, false>(sc[j & 1], vt, j, key0, khi_w, weigh, lane, t, qrow,
                                          L, causal, mx[j], den[j], o[j]);
        LCLK(ts2);
        LADD(PH_SOFTMAX, ts2 - ts1);  // with the AV product
      }
    }
    warp_release(&P.kvempty[st]);
    ++P.ki;
  }
  warp_release(&P.qempty[qslot]);
  ++P.qi;
  if (it.pair) {  // the second warpgroup's sums join the first's
    float* xo = scratch + (threadIdx.x & 127) * 40;
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < HG; ++j) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) xo[(j * (D / 8) + n) * 4 + e] = o[j][n][e];
        xo[32 + 2 * j] = den[j][0];
        xo[33 + 2 * j] = den[j][1];
      }
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < HG; ++j) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][n][e] += xo[(j * (D / 8) + n) * 4 + e];
        den[j][0] += xo[32 + 2 * j];
        den[j][1] += xo[33 + 2 * j];
      }
    }
    consumers_sync();  // the exchange area is free again
    if (wg == 1) return;
  }
  if (r0 >= R) return;
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const int hc = gi * HG + j;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      den[j][h] += __shfl_xor_sync(0xffffffffu, den[j][h], 1);
      den[j][h] += __shfl_xor_sync(0xffffffffu, den[j][h], 2);
      inv[h] = 1.f / (den[j][h] + 1e-30f);
    }
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(ao + blk(r0 + g + 8 * h, hc * D + nn * 8 + 2 * t, W)) =
            pack_bf16(o[j][nn][2 * h] * inv[h], o[j][nn][2 * h + 1] * inv[h]);
  }
}

// ---- f32 attention of one head group (3xTF32 on the tensor cores) -----------------
//
// Item (16-query block rb, head j) on warp w: items w, w + 8 of the group's
// 4 * 64/D.  The q fragments are split once (the slot is free after that);
// per key block and 16-key chunk the scores S = q k^T (each 16 of D into a
// fresh fragment), the maxima or the weights (f32), and O += P V with the
// chunk's two 8-key steps into a fresh fragment.  Output: the
// attention-output tile (ld_f(W)) at head column (gi*64/D + j)*D.

// A warp's items' 16-key chunk (MASKED as weights16; `act`: the items that
// weigh it).  A warp's items share a head (items w, w + 8), so each k and v
// fragment is loaded and split once for all of them.
template <int D, int IPW, bool SAFE, bool MASKED>
__device__ __forceinline__ void chunk_f32(const float* kb, const float* vb, int kc, int key0,
                                          bool weigh, int g, int t, const int (*qrow)[2],
                                          const bool* act, int L, int causal,
                                          const uint32_t (*qh)[D / 8][4],
                                          const uint32_t (*ql)[D / 8][4], float (*mx)[2],
                                          float (*den)[2], float (*o)[D / 8][4]) {
  LCLK(ts0);
  // Scores of the chunk's two 8-key tiles (tile nt: elements 4nt .. 4nt + 3).
  float sc[IPW][8];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const float* kr = kb + (kc * 16 + nt * 8 + g) * kKvLdF + t;
#pragma unroll
    for (int k2 = 0; k2 < D / 16; ++k2) {
      float part[IPW][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = 2 * k2 + kk;
        uint32_t bh[2], bl[2];
        split_tf32(kr[8 * ks], bh[0], bl[0]);
        split_tf32(kr[8 * ks + 4], bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < IPW; ++m) {
          if (!act[m]) continue;
          if (kk == 0)
            mma_3xtf32<true>(part[m], qh[m][ks], ql[m][ks], bh, bl);
          else
            mma_3xtf32(part[m], qh[m][ks], ql[m][ks], bh, bl);
        }
      }
#pragma unroll
      for (int m = 0; m < IPW; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[m][4 * nt + e] = k2 == 0 ? part[m][e] : sc[m][4 * nt + e] + part[m][e];
    }
  }
  LCLK(ts1);
  LADD(PH_SCORES, ts1 - ts0);
  if (!weigh) {
#pragma unroll
    for (int m = 0; m < IPW; ++m)
      if (act[m]) max16<MASKED>(sc[m], key0 + kc * 16, t, qrow[m], L, causal, mx[m]);
    LCLK(ts2);
    LADD(PH_SOFTMAX, ts2 - ts1);
    return;
  }
  // The A fragment of each 8-key step: k index t <-> key 2t, t + 4 <-> key
  // 2t + 1 (rows g, g + 8).
  uint32_t ph[IPW][2][4], pl[IPW][2][4];
#pragma unroll
  for (int m = 0; m < IPW; ++m) {
    if (!act[m]) continue;
    float p[8];
    weights16<SAFE, MASKED>(sc[m], p, key0 + kc * 16, t, qrow[m], L, causal, mx[m], den[m]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      split_tf32(p[4 * nt], ph[m][nt][0], pl[m][nt][0]);
      split_tf32(p[4 * nt + 2], ph[m][nt][1], pl[m][nt][1]);
      split_tf32(p[4 * nt + 1], ph[m][nt][2], pl[m][nt][2]);
      split_tf32(p[4 * nt + 3], ph[m][nt][3], pl[m][nt][3]);
    }
  }
  LCLK(ts3);
  LADD(PH_SOFTMAX, ts3 - ts1);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    float part[IPW][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // B: V[key 8nt + 2t (+1)][8dt + g] of the chunk, the same permutation.
      const float* vr = vb + (kc * 16 + nt * 8 + 2 * t) * kKvLdF + dt * 8 + g;
      uint32_t bh[2], bl[2];
      split_tf32(vr[0], bh[0], bl[0]);
      split_tf32(vr[kKvLdF], bh[1], bl[1]);
#pragma unroll
      for (int m = 0; m < IPW; ++m) {
        if (!act[m]) continue;
        if (nt == 0)
          mma_3xtf32<true>(part[m], ph[m][nt], pl[m][nt], bh, bl);
        else
          mma_3xtf32(part[m], ph[m][nt], pl[m][nt], bh, bl);
      }
    }
#pragma unroll
    for (int m = 0; m < IPW; ++m)
      if (act[m])
#pragma unroll
        for (int e = 0; e < 4; ++e) o[m][dt][e] += part[m][e];
  }
  LCLK(ts4);
  LADD(PH_AV, ts4 - ts3);
}

template <int D, bool SAFE, bool HALF>
__device__ void attention_f32(const LongArgs& A, const Item& it, int gi, Pipe& P, float* ao) {
  constexpr int HG = 64 / D;
  constexpr int ITEMS = 4 * HG;
  constexpr int IPW = (ITEMS + 7) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int L = A.L, causal = A.causal, W = attn_width<HALF>(A);

  const int qslot = P.qi % P.qs;
  LCLK(tq0);
  mbar_wait(&P.qfull[qslot], (P.qi / P.qs) & 1);
  LCLK(tq1);
  LADD(PH_Q, tq1 - tq0);
  const float* sq = reinterpret_cast<const float*>(P.q + qslot * P.qb);
  uint32_t qh[IPW][D / 8][4], ql[IPW][D / 8][4];
#pragma unroll
  for (int m = 0; m < IPW; ++m) {
    const int item = warp + 8 * m;
    if (item >= ITEMS) break;
    const int rb = item / HG, j = item - rb * HG;
    const float* a = sq + (16 * rb + g) * kQLdF + j * D + t;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      split_tf32(a[8 * ks], qh[m][ks][0], ql[m][ks][0]);
      split_tf32(a[8 * kQLdF + 8 * ks], qh[m][ks][1], ql[m][ks][1]);
      split_tf32(a[8 * ks + 4], qh[m][ks][2], ql[m][ks][2]);
      split_tf32(a[8 * kQLdF + 8 * ks + 4], qh[m][ks][3], ql[m][ks][3]);
    }
  }
  warp_release(&P.qempty[qslot]);
  ++P.qi;

  float o[IPW][D / 8][4], den[IPW][2], mx[IPW][2];
#pragma unroll
  for (int m = 0; m < IPW; ++m) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
    den[m][0] = den[m][1] = 0.f;
    mx[m][0] = mx[m][1] = -1e30f;
  }
  const int steps = (SAFE ? 2 : 1) * it.nkb;
  for (int n = 0; n < steps; ++n) {
    const int st = P.ki % P.kvs;
    LCLK(tw0);
    mbar_wait(&P.kvfull[st], (P.ki / P.kvs) & 1);
    LCLK(tw1);
    LADD(PH_KV, tw1 - tw0);
    const float* kv = reinterpret_cast<const float*>(P.kv + st * P.kvb);
    const int key0 = (n % it.nkb) * kKeyBlk;
    const bool weigh = !SAFE || n >= it.nkb;
    if (SAFE && n == it.nkb) {
#pragma unroll
      for (int m = 0; m < IPW; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(0xffffffffu, mx[m][h], 1));
          mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(0xffffffffu, mx[m][h], 2));
        }
    }
    // The warp's items share head j (items w, w + 8 when there are two).
    const int j = warp % HG;
    int qrow[IPW][2], khi[IPW];
    bool live[IPW], masked = false, any = false;
#pragma unroll
    for (int m = 0; m < IPW; ++m) {
      const int item = warp + 8 * m, r0 = 16 * (item / HG);
      qrow[m][0] = it.q0 + r0 + g;
      qrow[m][1] = it.q0 + r0 + g + 8;
      khi[m] = causal ? min(L, it.q0 + r0 + 16) : L;
      live[m] = item < ITEMS && r0 < it.valid && key0 < khi[m];
      any = any || live[m];
      masked = masked || (live[m] && (key0 + kKeyBlk > L ||
                                       (causal && key0 + kKeyBlk - 1 > it.q0 + r0)));
    }
    if (any) {
      const float* kb = kv + j * D;
      const float* vb = kv + 64 + j * D;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (masked) {
          bool act[IPW], some = false;
#pragma unroll
          for (int m = 0; m < IPW; ++m) {
            act[m] = live[m] && key0 + kc * 16 < khi[m];
            some = some || act[m];
          }
          if (!some) continue;
          chunk_f32<D, IPW, SAFE, true>(kb, vb, kc, key0, weigh, g, t, qrow, act, L, causal, qh,
                                        ql, mx, den, o);
        } else {
          chunk_f32<D, IPW, SAFE, false>(kb, vb, kc, key0, weigh, g, t, qrow, live, L, causal,
                                         qh, ql, mx, den, o);
        }
      }
    }
    warp_release(&P.kvempty[st]);
    ++P.ki;
  }
  const int ld = ld_f(W);
#pragma unroll
  for (int m = 0; m < IPW; ++m) {
    const int item = warp + 8 * m;
    if (item >= ITEMS) break;
    const int rb = item / HG, j = item - rb * HG, r0 = 16 * rb, hc = gi * HG + j;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      den[m][h] += __shfl_xor_sync(0xffffffffu, den[m][h], 1);
      den[m][h] += __shfl_xor_sync(0xffffffffu, den[m][h], 2);
      inv[h] = 1.f / (den[m][h] + 1e-30f);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ao + (r0 + g + 8 * h) * ld + hc * D + dt * 8 + 2 * t) =
            make_float2(o[m][dt][2 * h] * inv[h], o[m][dt][2 * h + 1] * inv[h]);
  }
}

// ---- an attention kernel's CTA --------------------------------------------------------
//
// Lay out the shared memory (Tail::layout; weight slabs of
// Tail::stage_bytes), start the barriers, split the threads: the producer
// warpgroup gives its registers to the consumers (setmaxnreg 40 / 232); its
// thread 0 streams the tail's weight slabs item after item
// (Tail::weights), its last three warps copy q and k|v of the W/64 head
// groups; the two consumer warpgroups run each item's attention and tail
// (item(it, ring, P, ao, h, x)).  Tail: the kernel's layout and weight
// stream (fused_block_long_sm90.cu:BlockTail, fused_half_long_sm90.cu:
// HalfTail).
template <class T, int PASSES, bool HALF, class Tail, class Item_>
__device__ __forceinline__ void attn_cta(const LongArgs& A, const AttnPlan& AP, Item_&& item) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool F32 = sizeof(T) == 4;
  const Shape& S = A.sh;
  const AttnLayout lay = Tail::layout(F32, S, AP);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Ring ring{smem + lay.ring, bars, bars + kMaxStages, S.stages, Tail::stage_bytes(F32, S), 0};
  uint64_t* kvb = bars + 2 * kMaxStages;
  Pipe P{smem + lay.q, smem + lay.kv, kvb + 2 * kMaxKv, kvb + 2 * kMaxKv + kMaxQ, kvb,
         kvb + kMaxKv, kvb + 2 * kMaxKv + 2 * kMaxQ, AP.qs, AP.kv, q_bytes(F32, AP.R),
         kv_bytes(F32), 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < S.stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    for (int s = 0; s < AP.kv; ++s) {
      mbar_init(&P.kvfull[s], kCopyLanes);
      mbar_init(&P.kvempty[s], kConsumers / 32);
    }
    for (int s = 0; s < AP.qs; ++s) {
      mbar_init(&P.qfull[s], kCopyLanes);
      mbar_init(&P.qempty[s], kConsumers / 32);
    }
    mbar_init(P.done, kConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#ifdef TANTE_PHASE_TIMING
    for (int k = 0; k < kLongPhases; ++k) s_long_cycles[k] = 0;
#endif
  }
  __syncthreads();

  const int items = attn_items(AP);
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      Tail::template weights<T>(A, AP, ring, items);
    } else if (threadIdx.x >= kCopyWarp * 32) {
      produce_qkv<T, PASSES, HALF>(A, AP, P);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  T* ao = reinterpret_cast<T*>(smem + lay.ao);
  T* h = reinterpret_cast<T*>(smem + lay.h);
  T* xk = reinterpret_cast<T*>(smem + lay.x);
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_at(A, AP, i);
    if (it.valid <= 0) continue;
    item(it, ring, P, ao, h, xk);
    if (AP.overlap) warp_release(P.done);
    LADD(PH_ITEMS, 1);
  }
#ifdef TANTE_PHASE_TIMING
  if (threadIdx.x == 0 && blockIdx.x < kPhaseSlots)
    for (int k = 0; k < kLongPhases; ++k) g_long_cycles[blockIdx.x][k] += s_long_cycles[k];
#endif
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

template <class K>
cudaError_t launch_attn_kernel(K k, const LongArgs& A, const AttnPlan& AP, int grid,
                               long long smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, AP);
  return cudaGetLastError();
}

// An attention kernel's grid: one CTA per SM, at most one per item.
int attn_grid(int items, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1)
    sms = 1;
  return items < sms ? items : sms;
}

// The big tiles of a launch (AttnPlan::big).  Where 128-row tiles leave a
// ragged last wave on the grid (one CTA per SM), the tiles past the last
// whole wave may run as two 64-row pair items each: the launch takes them
// so when (pair items at kPairShare of a tile's time; measured ~0.56 at the
// flagship's A block) that takes fewer waves' time; bf16 128-row plans
// whose tile h is apart from the ring only (ops/fused_block.py:
// long_big_tiles mirrors this).
constexpr double kPairShare = 0.6;
int pair_items(const AttnPlan& AP, bool f32, int device) {
  if (f32 || AP.R != 128 || AP.overlap) return AP.tiles;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1)
    return AP.tiles;
  const int full = AP.tiles / sms, rest = AP.tiles - full * sms;
  const int pair_waves = (2 * rest + sms - 1) / sms;
  return rest && kPairShare * pair_waves < 1 ? full * sms : AP.tiles;
}

}  // namespace
