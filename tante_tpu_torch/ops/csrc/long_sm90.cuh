// What the two kernel pairs for sequences longer than a tile share: the long
// block (fused_block_long_sm90.cu) and the tensor-parallel attention half at
// L > 64 (fused_half_long_sm90.cu).  Each pair is a qkv kernel (LN1 and the
// q|k|v products of token tiles into a workspace laid out head group by head
// group) and an attention kernel.  Both pairs share:
// - the qkv body (qkv_cta and above): a persistent grid over R-row token
//   tiles, each tile's x bulk-copied ahead into shared memory, the q|k|v
//   weights resident where they fit, the workspace written by asynchronous
//   bulk stores from staging buffers;
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
// f32 products on wgmma's TF32.
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the qkv kernels ---------------------------------------------------------------
//
// LN1 over C of R-row tiles of the (S*L, C) token matrix (sequences
// ignored), then for each of the W/64 head groups the q|k|v product (K = C,
// N = 192), + bias, rounded to the activation type, into the workspace
// (3, S, W/64, L, 64).  The block's and the half's qkv kernels run this one
// body, the width a template switch (attn_width<HALF>).
// - A persistent grid: one CTA per SM walks the tiles i, i + grid, ... in
//   that order.  A row's arithmetic never depends on the CTA that runs it,
//   so two launches are bit-equal.
// - x prefetched.  The producer thread copies a tile's rows, one contiguous
//   run of R*C values, into the x slot with one cp.async.bulk completed on
//   an mbarrier.  LN1 reads the slot and writes its own tile (a), so the
//   slot is free once LN1 has read it: the next tile's x lands under this
//   tile's products.  LN1 is layer_norm_g's / layer_norm_f32's arithmetic
//   on shared memory, its roundings spelled out: the same values.
// - Weights resident where the plan has room (S.stages == 0): the q|k|v
//   slabs of all W/64 groups bulk-copied once per CTA from the re-laid array
//   (WARR), in the layout the products read.  Elsewhere the slab ring of
//   S.stages slabs streams them per tile, as before.
// - Asynchronous workspace stores.  The epilogue (+ bias, rounding) writes
//   each part's R x 64 tile row-major into a staging buffer (a ring of
//   `parts` of them), then fence.proxy.async, and each consumer warp
//   arrives on the buffer's full barrier.  A store thread of the producer
//   warpgroup issues one cp.async.bulk per run of rows of one sequence (a
//   contiguous run of 128- (bf16) or 256-byte (f32) workspace rows),
//   commits the part, and hands a buffer back (its empty barrier) once
//   cp.async.bulk.wait_group.read has seen its stores read.  No consumer
//   barrier and no store issue in the epilogue: the consumers wait only for
//   a buffer still being read, and the next group's products start at once.
// - L2 hints: the weights' copies evict last, x's and the stores evict
//   first.
// bf16: the single-block kernel's wgmma products (m64n192k16 over 128-row
// tiles, a warpgroup's 64 rows each; m64n96k16 over 64-row tiles, a
// warpgroup's 96 columns each) in the same order, so the same sums.  Over
// 128-row tiles each warpgroup runs LN1 on its own 64 rows and syncs with
// itself alone, so one warpgroup's LN1 and epilogue overlap the other's
// products.  The epilogue stores 4 bytes a lane, a warp's 32 lanes on 32
// banks: the lanes of row g (= lane/4) write their 16-byte chunks of a
// 64-byte half-row in an order rotated by g, rows g and g + 4 the two
// halves of the row first.
// f32: gemm_f32's 3xTF32 products per element (the same 16-deep slabs,
// each slab's products in a fresh fragment, the same order of sums), with
// all twelve (row block, column tile) fragments of a slab in flight at once,
// over 64-row tiles: the plan has no room for 128-row f32 tiles beside the
// x slot, the padded LN1 tile and three staging buffers.  Where the plan
// has room (C <= 128), LN1 stores its output already split into TF32 hi /
// lo tiles, so that no warp splits A in the products.
// Bound: bytes at the bf16 C block (x in, 3 W values a token out: 1.92 ms
// for the block's entry, 1.20 for the tp 2 shard's kernel at 3.35 TB/s);
// in f32 the 3xTF32 products on mma.sync hold it (PERF.md: slab, LN1 and
// epilogue cycles per tile, tools/kernel_phases.py --long-qkv).

constexpr int kQkvSlab = kSlabK * kQkvN * 2;  // bytes of a q|k|v weight slab
static_assert(kQkvSlab == kSlabKF * kQkvN * 4, "bf16 and f32 q|k|v slabs differ in size");
constexpr int kMaxParts = 6;                  // staging buffers of a qkv kernel
constexpr int kQkvMaxStages = 8;              // weight slabs of a qkv kernel's ring
// Barriers: the ring's full / empty, the x slot's full / empty, the
// resident weights', the staging buffers' full / empty.
constexpr int kQkvBars = 2 * kQkvMaxStages + 3 + 2 * kMaxParts;

// The qkv kernel's plan past the Shape (whose stages are the ring's, 0 for
// resident weights): staging buffers, the launch's R-row tiles.
struct QkvPlan {
  int parts, tiles;
  int split;  // f32: LN1 stores its output split in TF32 hi / lo tiles
};

// The qkv kernel's shared memory: the x slot (R x C row-major), the LN1
// tile a (bf16 core matrices; f32 row-major, ld_f(C), and with `split` its
// TF32 hi tile then its lo tile), the staging buffers
// (R x 64 row-major each), the resident weights or the slab ring, the
// barriers; byte offsets, each region on 128 bytes.
struct QkvLayout {
  size_t x, a, st, w, bars, total;
};
__host__ __device__ inline QkvLayout layout_qkv(bool f32, int R, int C, int W, int stages,
                                                int parts, int split) {
  QkvLayout l{};
  const size_t e = f32 ? 4 : 2;
  l.x = 0;
  l.a = align128((size_t)R * C * e);
  l.st = align128(l.a + (f32 ? (size_t)(split ? 2 : 1) * R * ld_f(C) * 4 : (size_t)R * C * 2));
  l.w = align128(l.st + (size_t)parts * R * 64 * e);
  const size_t w = stages ? (size_t)stages * kQkvSlab : (size_t)(W / 64) * C * kQkvN * e;
  l.bars = align128(l.w + w);
  l.total = l.bars + kQkvBars * sizeof(uint64_t);
  return l;
}

// The qkv kernel's shared memory bytes under S (R, C, stages) for attention
// width W, `parts` staging buffers and `split`; 0 outside the kernels: R 64
// or 128 (bf16, C <= 256; f32 64), resident weights (stages 0) or a ring of
// 2 to kQkvMaxStages slabs, 3 to kMaxParts staging buffers, split only in
// f32 at C <= 128.
inline long long qkv_smem(const Shape& S, int W, int parts, int split, bool f32) {
  if (f32 ? S.R != kRowsF : (S.R != 64 && (S.R != 128 || S.C > 256))) return 0;
  if ((S.stages && (S.stages < 2 || S.stages > kQkvMaxStages)) || parts < 3 || parts > kMaxParts)
    return 0;
  if (split != 0 && (split != 1 || !f32 || S.C > 128)) return 0;
  return (long long)layout_qkv(f32, S.R, S.C, W, S.stages, parts, split).total;
}

// Phase cycles of a qkv kernel (measurement builds only, -DTANTE_PHASE_TIMING;
// tools/kernel_phases.py --long-qkv): per CTA, the SM cycles consumer thread
// 0 spent waiting for a tile's x, in LN1 (with its barrier), in the
// products (summed over the groups), waiting for staging buffers, in the
// epilogue, waiting for weight slabs (part of the products); the store
// thread's cycles issuing the stores, waiting for written buffers and for
// the stores' reads; the tiles and groups.
enum { QP_XWAIT, QP_LN1, QP_MMA, QP_STAGE_WAIT, QP_EPILOGUE, QP_SLAB_WAIT, QP_STORE_ISSUE,
       QP_STORE_FULL_WAIT, QP_STORE_READ_WAIT, QP_TILES, QP_GROUPS, kQkvPhases };
#ifdef TANTE_PHASE_TIMING
__device__ unsigned long long g_qkv_cycles[kPhaseSlots][kQkvPhases];
__shared__ unsigned long long s_qkv_slab_wait;  // thread 0's ring waits (in the products)
#define QSLAB(v) const long long v = clock64()
#define QSLAB_ADD(t0)                                                              \
  do {                                                                             \
    if (threadIdx.x == 0) s_qkv_slab_wait += (unsigned long long)(clock64() - t0); \
  } while (0)
#define QCLK(v) const long long v = clock64()
#define QTICK(v) v = clock64()
#define QADD(k, dt)                                            \
  do {                                                         \
    if (threadIdx.x == 0) qc[k] += (unsigned long long)(dt);   \
  } while (0)
#else
#define QCLK(v) \
  do {          \
  } while (0)
#define QTICK(v) \
  do {           \
  } while (0)
#define QSLAB(v) \
  do {           \
  } while (0)
#define QSLAB_ADD(t0) \
  do {                \
  } while (0)
#define QADD(k, dt) \
  do {              \
  } while (0)
#endif

// L2 policies of the qkv kernels' bulk copies: the weights (read by every
// CTA, per tile where they stream) evict last; x and the workspace (each
// byte moved once) evict first, so that they do not push the weights out.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ void bulk_load_l2(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)), "l"(policy) : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(policy) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Until at most n of this thread's committed store groups still read
// shared memory (n = parts - 3 <= kMaxParts - 3).
__device__ __forceinline__ void bulk_wait_read_upto(int n) {
  switch (n) {
    case 0: bulk_wait_read<0>(); break;
    case 1: bulk_wait_read<1>(); break;
    case 2: bulk_wait_read<2>(); break;
    default: bulk_wait_read<3>(); break;
  }
}

// LN1 of the x slot's R rows (row-major, C wide) into the core-matrix tile
// dst: layer_norm_g's lanes, loads, sums and stores (the same values), its
// scale and bias read per 8-column block (from L1).  At R = 128 (GROUPS 2)
// a warpgroup's warps take its own 64 rows (8-row groups wl and wl + 4 of
// them), at R = 64 the eight warps one 8-row group each.  A lane of an odd
// row loads its blocks in pairs swapped, so that the two rows of a
// quarter-warp read the two halves of 128 bytes (no bank conflict); the
// blocks go back in order before any sum.  Rows past `valid` read as
// zeros.  EXACT (NB = C/32, the 128-row tiles) drops the run-time block
// count, so the two groups' chains interleave.
// LN1's arithmetic spelled out in the roundings the single-block kernel's
// layer_norm_g / layer_norm_f32 compile to (found by comparing workspaces
// with that code's), so that no instantiation here fuses a multiply and an
// add differently: a pair's squares x^2 + y^2 as fma(x, x, y^2), then added
// to the running sum; the variance fma(-mu, mu, ss / C); the output
// fma((v - mu) * rs, scale, bias).
__device__ __forceinline__ float ln_sq2(float x, float y) {
  return __fmaf_rn(x, x, __fmul_rn(y, y));
}
__device__ __forceinline__ float ln_var(float ss, float mu, int C) {
  return __fmaf_rn(-mu, mu, __fdiv_rn(ss, (float)C));
}
__device__ __forceinline__ float ln_out(float v, float mu, float rs, float sc, float bi) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(v, mu), rs), sc, bi);
}
template <int NB, int GROUPS, bool EXACT>  // EXACT: NB == C / 32
__device__ void ln_slot(const bf16* xs, int valid, bf16* dst, int R, int C,
                        const bf16* __restrict__ scale, const bf16* __restrict__ bias) {
  constexpr int kWarps = kConsumers / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int odd = (lane >> 2) & 1, nb = C / 32;  // nb even: C is a multiple of 64
  uint4 raw[GROUPS][NB];
  auto row_of = [&](int g) {
    return GROUPS == 2 ? 64 * (warp >> 2) + ((warp & 3) + 4 * g) * 8 + (lane >> 2)
                       : (warp + g * kWarps) * 8 + (lane >> 2);
  };
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int r = row_of(g);
    const bf16* row = xs + (size_t)r * C;
    uint4 got[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      got[i] = make_uint4(0u, 0u, 0u, 0u);
      if ((EXACT || i < nb) && r < valid)
        got[i] = *reinterpret_cast<const uint4*>(row + (q + 4 * (i ^ odd)) * 8);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) raw[g][i] = odd ? got[i ^ 1] : got[i];
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int r = row_of(g);  // < R
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint32_t* pu = &raw[g][i].x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack_bf16(pu[e]);
        s = __fadd_rn(s, __fadd_rn(a.x, a.y));
        ss = __fadd_rn(ss, ln_sq2(a.x, a.y));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = __fdiv_rn(s, (float)C);
    const float var = fmaxf(ln_var(ss, mu, C), 0.f);
    const float rs = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (!EXACT && i >= nb) break;
      const int c0 = (q + 4 * i) * 8;
      const uint4 scv = __ldg(reinterpret_cast<const uint4*>(scale + c0));
      const uint4 biv = __ldg(reinterpret_cast<const uint4*>(bias + c0));
      const uint32_t *ps = &scv.x, *pb = &biv.x, *pv = &raw[g][i].x;
      uint4 u;
      uint32_t* pu = &u.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 sc = unpack_bf16(ps[e]), bi = unpack_bf16(pb[e]), v = unpack_bf16(pv[e]);
        pu[e] = pack_bf16(ln_out(v.x, mu, rs, sc.x, bi.x), ln_out(v.y, mu, rs, sc.y, bi.y));
      }
      *reinterpret_cast<uint4*>(dst + blk(r, c0, C)) = u;
    }
  }
}

// LN1 of the x slot's 64 rows (row-major, C wide) into the row-major tile
// dst (ld_f(C)), with layer_norm_f32's sums: there a warp takes a row, lane
// l holds the float4 column blocks l and l + 32, and the row's sums meet in
// warp_sum's butterfly (xor 16, 8, 4, 2, 1).  Here four lanes take a row
// (eight rows a warp at once): lane q holds the blocks l = q + 4m (m < 8)
// and l + 32, so that the butterfly's first three levels (m ^ 4, m ^ 2,
// m ^ 1) are adds inside the lane and the last two shuffles: the same sums
// in the same order, the same values.  NG = C/16 blocks a lane (C 64, 128,
// 192 or 256).  A lane of an odd row loads and stores its blocks in pairs
// swapped (the two rows of a quarter-warp on other banks).  SPLIT: each
// output stored as its TF32 hi (dst) and lo (64 rows on) parts, split once
// here rather than by every warp in every slab's products.  Rows past
// `valid` read as zeros.
template <int NG, bool SPLIT>
__device__ void ln_slot_f32(const float* xs, int valid, float* dst, int C,
                            const float* __restrict__ scale, const float* __restrict__ bias) {
  static_assert(NG % 4 == 0 && NG >= 4 && NG <= 16, "C = 16 NG in 64 .. 256");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int r = warp * 8 + (lane >> 2), odd = (lane >> 2) & 1, ld = ld_f(C);
  const float4* row = reinterpret_cast<const float4*>(xs + (size_t)r * C);
  float4 got[NG], v[NG];  // v[k]: block q + 4 k
#pragma unroll
  for (int k = 0; k < NG; ++k)
    got[k] = r < valid ? row[q + 4 * (k ^ odd)] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < NG; ++k) v[k] = odd ? got[k ^ 1] : got[k];
  // The butterfly's leaves: lane l's sums over its blocks l and l + 32.
  float s[8], ss[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    s[m] = 0.f;
    ss[m] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = m + 8 * h;
      if (k < NG) {
        const float4 a = v[k];
        s[m] = __fadd_rn(s[m], __fadd_rn(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w)));
        ss[m] = __fadd_rn(ss[m], __fadd_rn(ln_sq2(a.x, a.y), ln_sq2(a.z, a.w)));
      }
    }
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)  // xor 16, 8, 4: leaves m and m ^ (o)
#pragma unroll
    for (int m = 0; m < o; ++m) {
      s[m] = __fadd_rn(s[m], s[m + o]);
      ss[m] = __fadd_rn(ss[m], ss[m + o]);
    }
  float st = s[0], sst = ss[0];
#pragma unroll
  for (int o = 2; o > 0; o >>= 1) {  // xor 2, 1
    st = __fadd_rn(st, __shfl_xor_sync(0xffffffffu, st, o));
    sst = __fadd_rn(sst, __shfl_xor_sync(0xffffffffu, sst, o));
  }
  const float mu = __fdiv_rn(st, (float)C);
  const float var = fmaxf(ln_var(sst, mu, C), 0.f);
  const float rs = rsqrtf(var + 1e-5f);
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    const int b = q + 4 * (kk ^ odd);
    const float4 a = odd ? v[kk ^ 1] : v[kk];
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale) + b);
    const float4 bi = __ldg(reinterpret_cast<const float4*>(bias) + b);
    const float4 o =
        make_float4(ln_out(a.x, mu, rs, sc.x, bi.x), ln_out(a.y, mu, rs, sc.y, bi.y),
                    ln_out(a.z, mu, rs, sc.z, bi.z), ln_out(a.w, mu, rs, sc.w, bi.w));
    if constexpr (SPLIT) {
      uint4 hi, lo;
      split_tf32(o.x, hi.x, lo.x);
      split_tf32(o.y, hi.y, lo.y);
      split_tf32(o.z, hi.z, lo.z);
      split_tf32(o.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(dst + r * ld + 4 * b) = hi;
      *reinterpret_cast<uint4*>(dst + (kRowsF + r) * ld + 4 * b) = lo;
    } else {
      *reinterpret_cast<float4*>(dst + r * ld + 4 * b) = o;
    }
  }
}

// A bf16 head group's products (gemm<NW>'s instructions and order):
// acc (this thread's NW/2) = A (R x K, the LN1 tile) . the group's K/32
// slabs, from `w` (resident) or, where w is null, the ring's next slabs.
template <int NW>
__device__ __forceinline__ void qkv_mma(const bf16* A, int K, int R, const unsigned char* w,
                                        Ring& ring, float* acc) {
  const int wg = threadIdx.x >> 7;
  const bool split_rows = R == 128;
  const int c_off = split_rows ? 0 : wg * NW;
  const uint32_t a_sbo = (uint32_t)(K >> 3) * 128;
  const bf16* a_rows = A + ((split_rows ? wg : 0) * 8) * (K >> 3) * 64;
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
  const int nk = K / kSlabK;
  auto slab_mma = [&](const bf16* slab, int kc) {
#pragma unroll
    for (int ks = 0; ks < kSlabK / 16; ++ks)
      wgmma<NW>(acc, wg_desc(a_rows + ((kc * kSlabK + ks * 16) >> 3) * 64, 128, a_sbo),
                wg_desc(slab + ((c_off >> 3) * (kSlabK / 8) + ks * 2) * 64, 128,
                        (kSlabK / 8) * 128));
  };
  if (w) {
    wg_fence();
    for (int kc = 0; kc < nk; ++kc)
      slab_mma(reinterpret_cast<const bf16*>(w + (size_t)kc * kQkvSlab), kc);
    wg_commit();
    wg_wait<0>();
    return;
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int s = ring.idx % ring.stages;
    QSLAB(w0);
    mbar_wait(&ring.full[s], (ring.idx / ring.stages) & 1);
    QSLAB_ADD(w0);
    wg_fence();
    slab_mma(reinterpret_cast<const bf16*>(ring.base + (size_t)s * ring.stage_bytes), kc);
    wg_commit();
    wg_wait<1>();  // the slab before this one is no longer read
    if (kc > 0) release(ring, ring.idx - 1);
    ++ring.idx;
  }
  wg_wait<0>();
  release(ring, ring.idx - 1);
}

// A bf16 head group's epilogue: acc + bias (bb: this thread's bias pairs,
// gemm's), rounded, into the staging buffers of the group's parts q, k, v
// (st[0..2], R x 64 row-major each).  The thread's columns in 8-column
// chunks j (global chunk c0 + j: part (c0 + j) / 8), taken 8 at a time (a
// pair of 4-chunk blocks: one 128-byte row of a part) or 4 (the last block
// of a 64-row tile's 96 columns): at step s, lane (g, t) writes chunk
// ((s / 4) ^ (g / 4)) * 4 + (s + g) % 4 of the pair at 4t bytes into it, so
// that the warp's 32 lanes store on 32 banks (a lone block: 16, two lanes a
// bank).
template <int NW>
__device__ __forceinline__ void qkv_stage(const float* acc, const uint32_t* bb,
                                          unsigned char* st0, unsigned char* st1,
                                          unsigned char* st2, int R) {
  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rot = g & 3, hi = g >> 2;
  const bool split_rows = R == 128;
  const int c0 = split_rows ? 0 : wg * (NW / 8);
  const int row = (split_rows ? wg * 64 : 0) + wl * 16 + g;
  constexpr int kBlocks = NW / 32;
#pragma unroll
  for (int bl = 0; bl < kBlocks; bl += 2) {
    const int n = bl + 1 < kBlocks ? 8 : 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        v[m] = 0u;
        if (m < n) {
          const int j = 4 * bl + m;
          const float2 f = unpack_bf16(bb[j]);
          v[m] = pack_bf16(acc[4 * j + 2 * h] + f.x, acc[4 * j + 2 * h + 1] + f.y);
        }
      }
      // Each half rotated by rot (w[s] = v[half + (s + rot) % 4]), then the
      // halves swapped where hi.
      uint32_t u[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) u[m] = (rot & 1) ? v[(m & 4) | ((m + 1) & 3)] : v[m];
#pragma unroll
      for (int m = 0; m < 8; ++m) v[m] = (rot & 2) ? u[(m & 4) | ((m + 2) & 3)] : u[m];
#pragma unroll
      for (int m = 0; m < 8; ++m) u[m] = (hi && n == 8) ? v[m ^ 4] : v[m];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s >= n) break;
        const int m = (n == 8 ? (((s >> 2) ^ hi) << 2) : 0) | ((s + rot) & 3);
        const int cj = c0 + 4 * bl + m, p = cj >> 3;
        unsigned char* st = p == 0 ? st0 : (p == 1 ? st1 : st2);
        *reinterpret_cast<uint32_t*>(st + (row + 8 * h) * 128 + (cj & 7) * 16 + 4 * t) = u[s];
      }
    }
  }
}

// An f32 head group's products (gemm_f32_rb<3, 4>'s arithmetic): acc =
// A (64 x K, the LN1 tile, ld_f(K); SPLIT: its TF32 hi and lo tiles) . the
// group's K/16 slabs, from `w` (RES: resident) or the ring's next slabs.  Warp w takes the
// 8-column tiles w + 8j (j < 3: column 8w of part j) of the 64 rows.
template <bool RES, bool SPLIT>
__device__ __forceinline__ void qkv_mma_f32(const float* A, int K, const unsigned char* w,
                                            Ring& ring, float (&acc)[4][3][4]) {
  constexpr int NJ = 3, RB = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lda = ld_f(K);
  const float* arow = A + g * lda + t;
  // SPLIT: A's TF32 parts as LN1 stored them (hi, then lo 64 rows on).
  const uint32_t* hrow = reinterpret_cast<const uint32_t*>(arow);
  const uint32_t* lrow = hrow + kRowsF * lda;
  auto frag = [&](int off, uint32_t& h, uint32_t& l) {
    if constexpr (SPLIT) {
      h = hrow[off];
      l = lrow[off];
    } else {
      split_tf32(arow[off], h, l);
    }
  };
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rb][j][e] = 0.f;
  for (int kc = 0; kc < K / kSlabKF; ++kc) {
    // The slab's first k8 step of A, split while its B may still be in
    // flight.
    uint32_t a0h[RB][4], a0l[RB][4], a1h[RB][4], a1l[RB][4];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int o = 16 * rb * lda + kc * kSlabKF;
      frag(o, a0h[rb][0], a0l[rb][0]);
      frag(o + 8 * lda, a0h[rb][1], a0l[rb][1]);
      frag(o + 4, a0h[rb][2], a0l[rb][2]);
      frag(o + 8 * lda + 4, a0h[rb][3], a0l[rb][3]);
    }
    const unsigned char* base;
    if constexpr (RES) {
      base = w + (size_t)kc * kQkvSlab;
    } else {
      const int s = ring.idx % ring.stages;
      QSLAB(w0);
      mbar_wait(&ring.full[s], (ring.idx / ring.stages) & 1);
      QSLAB_ADD(w0);
      base = ring.base + (size_t)s * ring.stage_bytes;
    }
    // This warp's B fragments of the slab: tile w + 8j is 32 float4s,
    // lane l's at 4l: rows t, t + 4 (the first k8 step), 8 + t, 12 + t.
    const float4* slab = reinterpret_cast<const float4*>(base) + warp * 32 + lane;
    uint32_t bh[NJ][4], bl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b = slab[j * 256];
      split_tf32(b.x, bh[j][0], bl[j][0]);
      split_tf32(b.y, bh[j][1], bl[j][1]);
      split_tf32(b.z, bh[j][2], bl[j][2]);
      split_tf32(b.w, bh[j][3], bl[j][3]);
    }
    if constexpr (!RES) {
      // Generic-proxy reads of the stage before the producer's next bulk
      // copy into it (gemm_f32's fence).
      fence_async_smem();
      release(ring, ring.idx);
      ++ring.idx;
    }
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int o = 16 * rb * lda + kc * kSlabKF + 8;
      frag(o, a1h[rb][0], a1l[rb][0]);
      frag(o + 8 * lda, a1h[rb][1], a1l[rb][1]);
      frag(o + 4, a1h[rb][2], a1l[rb][2]);
      frag(o + 8 * lda + 4, a1h[rb][3], a1l[rb][3]);
    }
    // Each fragment's six products in gemm_f32's order (a fresh fragment,
    // the first k8 step, the second), the twelve fragments' chains side by
    // side; then added to the totals.
    float part[RB][NJ][4];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_3xtf32<true>(part[rb][j], a0h[rb], a0l[rb], &bh[j][0], &bl[j][0]);
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_3xtf32(part[rb][j], a1h[rb], a1l[rb], &bh[j][2], &bl[j][2]);
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rb][j][e] += part[rb][j][e];
  }
}

// The store thread: for each head group of each of this CTA's tiles, in the
// consumers' order, and each part (q, k, v: part n of the CTA in staging
// buffer n % parts), once the consumer warps have written it (full), one
// bulk copy per run of the tile's rows inside one sequence, then one
// commit; a buffer goes back to the consumers (empty) once its stores have
// read it, keeping parts - 3 parts' reads in flight.
template <class T, bool HALF>
__device__ void qkv_stores(const LongArgs& A, const QkvPlan& P, const unsigned char* st,
                           uint64_t* full, uint64_t* empty) {
  const Shape& S = A.sh;
  const int G = attn_width<HALF>(A) / 64, keep = P.parts - 3;
  const size_t part = (size_t)A.n_seqs * G * A.L * 64;  // elements of a workspace part
  const size_t part_bytes = (size_t)S.R * 64 * sizeof(T);
  T* ws = static_cast<T*>(A.ws);
  const uint64_t once = l2_evict_first();
#ifdef TANTE_PHASE_TIMING
  unsigned long long sc[3] = {};
#endif
  int n = 0;
  for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) {
    const int row0 = t * S.R, valid = min(S.R, A.tokens - row0);
    for (int gi = 0; gi < G; ++gi) {
      for (int p = 0; p < 3; ++p, ++n) {
        const int b = n % P.parts;
        QCLK(s0);
        mbar_wait(&full[b], (n / P.parts) & 1);
        QCLK(s1);
        const unsigned char* buf = st + (size_t)b * part_bytes;
        for (int r = 0; r < valid;) {
          const int tok = row0 + r, s = tok / A.L, pos = tok - s * A.L;
          const int cnt = min(valid - r, A.L - pos);
          bulk_store(ws + p * part + (((size_t)s * G + gi) * A.L + pos) * 64,
                     buf + (size_t)r * 64 * sizeof(T), (uint32_t)(cnt * 64 * sizeof(T)), once);
          r += cnt;
        }
        bulk_commit();
        QCLK(s2);
        if (n >= keep) {
          bulk_wait_read_upto(keep);
          mbar_arrive(&empty[(n - keep) % P.parts]);
        }
        QCLK(s3);
#ifdef TANTE_PHASE_TIMING
        sc[0] += s2 - s1;
        sc[1] += s1 - s0;
        sc[2] += s3 - s2;
#endif
      }
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#ifdef TANTE_PHASE_TIMING
  if (blockIdx.x < kPhaseSlots)
    for (int k = 0; k < 3; ++k) g_qkv_cycles[blockIdx.x][QP_STORE_ISSUE + k] += sc[k];
#endif
}

// The producer thread: the resident weights (once), each tile's x into the
// slot once the consumers' LN1 has read the last one, and where the weights
// stream, each tile's slabs (all W/64 groups', in order); the next tile's x
// goes out after the first ring-full of this tile's slabs, so that it is
// issued as soon as this tile's LN1 frees the slot.  xbar: x full, x empty,
// weights full.
template <class T>
__device__ void qkv_produce(const LongArgs& A, const QkvPlan& P, unsigned char* xs,
                            unsigned char* wsm, Ring& ring, uint64_t* xbar, int groups) {
  const Shape& S = A.sh;
  const unsigned char* w = static_cast<const unsigned char*>(A.p[WARR]);
  const unsigned char* xg = static_cast<const unsigned char*>(A.x);
  const size_t row_bytes = (size_t)S.C * sizeof(T);
  const int slabs = groups * (S.C / Elem<T>::slab_k);  // a tile's
  const uint64_t keep = l2_evict_last(), once = l2_evict_first();
  if (!S.stages) {
    mbar_expect_tx(&xbar[2], (uint32_t)slabs * kQkvSlab);
    for (int i = 0; i < slabs; ++i)
      bulk_load_l2(wsm + (size_t)i * kQkvSlab, w + (size_t)i * kQkvSlab, kQkvSlab, &xbar[2],
                   keep);
  }
  auto load_x = [&](int t) {
    const int row0 = t * S.R, valid = min(S.R, A.tokens - row0);
    mbar_expect_tx(&xbar[0], (uint32_t)(valid * row_bytes));
    bulk_load_l2(xs, xg + (size_t)row0 * row_bytes, (uint32_t)(valid * row_bytes), &xbar[0],
                 once);
  };
  load_x(blockIdx.x);
  const int lead = S.stages ? min(S.stages, slabs) : 0;
  int idx = 0, n = 0;
  for (int t = blockIdx.x; t < P.tiles; t += gridDim.x, ++n) {
    const bool next = t + (int)gridDim.x < P.tiles;
    for (int i = 0; i < (S.stages ? slabs : 0); ++i, ++idx) {
      const int s = idx % ring.stages;
      if (idx >= ring.stages) mbar_wait(&ring.empty[s], ((idx / ring.stages) - 1) & 1);
      mbar_expect_tx(&ring.full[s], kQkvSlab);
      bulk_load_l2(ring.base + (size_t)s * ring.stage_bytes, w + (size_t)i * kQkvSlab, kQkvSlab,
                   &ring.full[s], keep);
      if (i == lead - 1 && next) {
        mbar_wait(&xbar[1], n & 1);
        load_x(t + gridDim.x);
      }
    }
    if (!S.stages && next) {
      mbar_wait(&xbar[1], n & 1);
      load_x(t + gridDim.x);
    }
  }
}

// A qkv kernel's CTA (see the section's head): the producer warpgroup's
// first thread loads weights and x, its second warp's first thread issues
// the workspace stores; the two consumer warpgroups run LN1, the products
// and the epilogue.
template <bool F32, bool HALF>
__device__ __forceinline__ void qkv_cta(const LongArgs& A, const QkvPlan& P) {
  using T = typename std::conditional<F32, float, bf16>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape& S = A.sh;
  const int R = S.R, C = S.C, groups = attn_width<HALF>(A) / 64;
  const QkvLayout lay = layout_qkv(F32, R, C, attn_width<HALF>(A), S.stages, P.parts, P.split);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Ring ring{smem + lay.w, bars, bars + kQkvMaxStages, S.stages, kQkvSlab, 0};
  uint64_t* xbar = bars + 2 * kQkvMaxStages;  // x full, x empty, weights full
  uint64_t* st_full = xbar + 3;
  uint64_t* st_empty = st_full + kMaxParts;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S.stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], kConsumers / 32);
    mbar_init(&xbar[2], 1);
    for (int b = 0; b < P.parts; ++b) {
      mbar_init(&st_full[b], kConsumers / 32);
      mbar_init(&st_empty[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#ifdef TANTE_PHASE_TIMING
    s_qkv_slab_wait = 0;
#endif
  }
  __syncthreads();
  unsigned char* st = smem + lay.st;
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers)
      qkv_produce<T>(A, P, smem + lay.x, smem + lay.w, ring, xbar, groups);
    else if (threadIdx.x == kConsumers + 32)
      qkv_stores<T, HALF>(A, P, st, st_full, st_empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
#ifdef TANTE_PHASE_TIMING
  unsigned long long qc[kQkvPhases] = {};
#endif
  const T* xs = reinterpret_cast<const T*>(smem + lay.x);
  T* a = reinterpret_cast<T*>(smem + lay.a);
  const size_t part_bytes = (size_t)R * 64 * sizeof(T);
  const unsigned char* wres = S.stages ? nullptr : smem + lay.w;
  const size_t group_bytes = (size_t)C * kQkvN * sizeof(T);
  const T* ln_s = static_cast<const T*>(A.p[LN1S]);
  const T* ln_b = static_cast<const T*>(A.p[LN1B]);
  const T* bqkv = static_cast<const T*>(A.p[BQKV]);
  const int lane = threadIdx.x & 31, wgi = threadIdx.x >> 7;
  // 128-row bf16 tiles: each warpgroup its own rows, synced with itself.
  const bool own_rows = !F32 && R == 128;
  if (wres) mbar_wait(&xbar[2], 0);
  int n = 0, ng = 0;
  for (int t = blockIdx.x; t < P.tiles; t += gridDim.x, ++n) {
    const int valid = min(R, A.tokens - t * R);
    // Where every warp reads every row of the LN1 tile (f32; bf16 64-row
    // tiles), no warp writes it before all have done the last tile's
    // products.
    if (!own_rows && n > 0) consumers_sync();
    QCLK(c0);
    mbar_wait(&xbar[0], n & 1);
    QCLK(c1);
    QADD(QP_XWAIT, c1 - c0);
    if constexpr (F32) {
      switch (C + P.split) {  // split only at C <= 128
        case 64: ln_slot_f32<4, false>(xs, valid, a, C, ln_s, ln_b); break;
        case 65: ln_slot_f32<4, true>(xs, valid, a, C, ln_s, ln_b); break;
        case 128: ln_slot_f32<8, false>(xs, valid, a, C, ln_s, ln_b); break;
        case 129: ln_slot_f32<8, true>(xs, valid, a, C, ln_s, ln_b); break;
        case 192: ln_slot_f32<12, false>(xs, valid, a, C, ln_s, ln_b); break;
        default: ln_slot_f32<16, false>(xs, valid, a, C, ln_s, ln_b); break;
      }
    }
    else if (R == 128)
      switch (C) {  // 64 <= C <= 256
        case 64: ln_slot<2, 2, true>(xs, valid, a, R, C, ln_s, ln_b); break;
        case 128: ln_slot<4, 2, true>(xs, valid, a, R, C, ln_s, ln_b); break;
        case 192: ln_slot<6, 2, true>(xs, valid, a, R, C, ln_s, ln_b); break;
        default: ln_slot<8, 2, true>(xs, valid, a, R, C, ln_s, ln_b); break;
      }
    else
      ln_slot<kMaxC / 32, 1, false>(xs, valid, a, R, C, ln_s, ln_b);
    // The slot's reads and the tile's writes before the async proxy's next
    // copy into the slot and (bf16) wgmma's reads of the tile.
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(&xbar[1]);
    if (own_rows)
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wgi) : "memory");
    else
      consumers_sync();
    QCLK(c2);
    QADD(QP_LN1, c2 - c1);
    QADD(QP_TILES, 1);
    for (int gi = 0; gi < groups; ++gi, ++ng) {
      const unsigned char* wg_w = wres ? wres + gi * group_bytes : nullptr;
      unsigned char* sp[3];
      int bufs[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        bufs[p] = (3 * ng + p) % P.parts;
        sp[p] = st + (size_t)bufs[p] * part_bytes;
      }
      // Wait until the store thread has handed back part p's buffer (part
      // 3 ng + p - parts read).
      auto buffer_free = [&](int p) {
        if (3 * ng + p >= P.parts)
          mbar_wait(&st_empty[bufs[p]], (((3 * ng + p) / P.parts) - 1) & 1);
      };
#ifdef TANTE_PHASE_TIMING
      long long m2 = 0;  // the staging buffers free
#endif
      QCLK(m0);
      if constexpr (F32) {
        const int warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
        float2 bias[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          bias[j] = __ldg(reinterpret_cast<const float2*>(bqkv + gi * kQkvN + 8 * (warp + 8 * j) +
                                                          2 * tq));
        float acc[4][3][4];
        if (wres && P.split)
          qkv_mma_f32<true, true>(a, C, wg_w, ring, acc);
        else if (wres)
          qkv_mma_f32<true, false>(a, C, wg_w, ring, acc);
        else if (P.split)
          qkv_mma_f32<false, true>(a, C, wg_w, ring, acc);
        else
          qkv_mma_f32<false, false>(a, C, wg_w, ring, acc);
        QCLK(m1);
        QADD(QP_MMA, m1 - m0);
        buffer_free(0);
        QTICK(m2);
        QADD(QP_STAGE_WAIT, m2 - m1);
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int rb = 0; rb < 4; ++rb) {
            if (rb == 0 && j > 0) buffer_free(j);
            float* d = reinterpret_cast<float*>(sp[j]) + (16 * rb + g) * 64 + 8 * warp + 2 * tq;
            *reinterpret_cast<float2*>(d) =
                make_float2(acc[rb][j][0] + bias[j].x, acc[rb][j][1] + bias[j].y);
            *reinterpret_cast<float2*>(d + 8 * 64) =
                make_float2(acc[rb][j][2] + bias[j].x, acc[rb][j][3] + bias[j].y);
          }
      } else {
        constexpr int kMaxNW = 192;
        uint32_t bb[kMaxNW / 8];
        float acc[kMaxNW / 2];
        const int col = (R == 128 ? 0 : wgi * 96) + 2 * (lane & 3);
        const bf16* b = bqkv + gi * kQkvN;
        if (R == 128) {
#pragma unroll
          for (int j = 0; j < 24; ++j) bb[j] = *reinterpret_cast<const uint32_t*>(b + col + 8 * j);
          qkv_mma<192>(a, C, R, wg_w, ring, acc);
        } else {
#pragma unroll
          for (int j = 0; j < 12; ++j) bb[j] = *reinterpret_cast<const uint32_t*>(b + col + 8 * j);
          qkv_mma<96>(a, C, R, wg_w, ring, acc);
        }
        QCLK(m1);
        QADD(QP_MMA, m1 - m0);
#pragma unroll
        for (int p = 0; p < 3; ++p) buffer_free(p);
        QTICK(m2);
        QADD(QP_STAGE_WAIT, m2 - m1);
        if (R == 128)
          qkv_stage<192>(acc, bb, sp[0], sp[1], sp[2], R);
        else
          qkv_stage<96>(acc, bb, sp[0], sp[1], sp[2], R);
      }
      // The staging writes before the bulk copies read them; each warp's
      // arrival tells the store thread.
      fence_async_smem();
      __syncwarp();
      if (lane == 0)
#pragma unroll
        for (int p = 0; p < 3; ++p) mbar_arrive(&st_full[bufs[p]]);
      QCLK(m3);
      QADD(QP_EPILOGUE, m3 - m2);
      QADD(QP_GROUPS, 1);
    }
  }
#ifdef TANTE_PHASE_TIMING
  qc[QP_SLAB_WAIT] = s_qkv_slab_wait;
  if (threadIdx.x == 0 && blockIdx.x < kPhaseSlots)
    for (int k = 0; k < kQkvPhases; ++k)
      if (k < QP_STORE_ISSUE || k > QP_STORE_READ_WAIT) g_qkv_cycles[blockIdx.x][k] += qc[k];
#endif
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
cudaError_t launch_qkv_kernel(K k, const LongArgs& A, const QkvPlan& P, int grid, long long smem,
                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, P);
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
