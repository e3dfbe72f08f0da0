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
// 128).  A query past a tile's rows attends to keys that another CTA
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
//     contiguous run of 64 x 64 values (long_sm90.cuh).
//   tante_block_long_attn_sm90[_f32]_fwd  the attention entry, below.
//
// The attention entry (redesigned after the first design's one CTA per
// (sequence, 64-query tile), which ran the C block in 745 waves of short
// CTAs, each staging its k|v behind two CTA barriers a key block and
// streaming the tail's weights for 64 rows):
// - A persistent grid: one CTA per SM (its registers allow one), each
//   walking the work items i, i + grid, ... in that fixed order.  A
//   sequence is cut into tiles of R query rows (R = 128 in bf16 where
//   C <= 256, else 64; f32 64); an item is a tile's rows, every head group,
//   then the tail on those rows.  In bf16 at R = 128 the tiles past the
//   grid's last whole wave may run as two 64-row "pair" items each, whose
//   two warpgroups share the rows, weigh the even and the odd key blocks,
//   and add their sums (pair_items: where 128-row tiles leave a ragged last
//   wave, the flagship's A and L blocks, 192 tiles on 132 SMs).  A row's
//   arithmetic depends on the launch's shape and SM count, never on which
//   CTA runs it, and no sum is shared between CTAs: two launches are
//   bit-equal.
// - Warp specialisation.  Three producer warps copy each head group's q
//   tile and its k|v blocks of 64 keys (16-byte cp.async, bf16 into core
//   matrices, f32 into rows padded by 4 floats; rows past the sequence
//   zero-filled) into a ring of 2-4 stages and a q buffer of 1-2 slots,
//   completed on mbarriers (cp.async.mbarrier.arrive), and run on into the
//   next item while the consumers finish this one (where the tail's tiles do
//   not overlap the ring; the plan's `overlap` otherwise holds the next
//   item's copies until the tail is done).  One producer thread streams the
//   tail's weight slabs (the single-block kernel's ring) item after item.
//   The consumer warps release each stage per warp: no CTA barrier per key
//   block, two per item before the tail.
// - bf16: each consumer warpgroup owns 64 query rows of the item (R = 64:
//   the first alone) and runs QK^T on wgmma m64n64k16 per head (A the q
//   tile, B the k block, both K-major core matrices in shared memory; the
//   next head's products in flight while this head is weighed), the masks
//   (only in blocks that cross the sequence's end or the diagonal) and the
//   softmax on the accumulator fragments, and AV on mma.sync
//   m16n8k16 with P from those fragments (the accumulator of m64nN is, per
//   warp, mma.sync's C layout) and V by ldmatrix.trans.
// - f32: QK^T and AV on the tensor cores as 3xTF32 mma.sync m16n8k8 (the
//   body's hi / lo split, gemm_f32), each 16-deep product into a fresh
//   fragment added in f32; a warp takes (16-query block, head) items; P
//   stays f32 and is split, its accumulator fragment the A operand of AV
//   under a permutation of each 8-key step (k index t <-> key 2t, t + 4 <->
//   2t + 1), which V's B fragment follows.
// - The tail: the single-block kernel's out-projection + bo + residual
//   (x' to y), LN2 (bf16: ln_rows, the body's LayerNorm with a lighter
//   register footprint), fc1 + GELU, fc2 + b2 + residual on the item's rows
//   (bf16 128-row items: each weight slab streamed once per 128 rows).
//   Where the plan has room (`keep`: the C block in both dtypes), x' stays
//   in shared memory from the out-projection to fc2, so neither LN2 nor fc2
//   reads a residual from device memory and y is written once.
//
// Softmax.  "fast" (the default) has no max-subtract, so each key block adds
// bf16(unnorm) V to the output fragment (f32: unnorm itself) and unnorm (f32)
// to the denominator, unnorm = exp2(min(s, 60*log2 e)) over the admitted
// keys: every element is the Pallas kernel's own value and only the order of
// the f32 sums differs.  "safe" takes two passes over the keys: each row's
// maximum over all its admitted keys first, then exp2(s - max).  That
// repeats QK^T but keeps JAX's per-element values (an online rescale would
// change which value is rounded to bf16).  Causal: key <= query; key blocks
// wholly above the diagonal of an item are not loaded, blocks above a
// warpgroup's (bf16) or an item's (f32) last query not multiplied, 16-key
// chunks above a 16-query block's not weighed.  The result is scaled by
// 1/(sum + 1e-30) and rounded.
//
// Bound: operations (chip_smoke.py:long_bounds).  At the flagship (8 heads,
// MLP ratio 1) an L block is 38.7 GFLOP and a C block 2,062 GFLOP (1,237
// projections, 825 attention): 0.039 / 2.09 ms at 989 TFLOP/s bf16, three
// times the TF32 time in f32 (3xTF32).  Bytes: x and y once, plus the
// workspace's write and read (3 C values a token each way), which the split
// adds; the attention entry reads each k|v block once per item
// (ops/fused_block.py:long_attn_reads).  What bounds this design, by
// tools/kernel_phases.py --long (cycles of consumer thread 0 per item): in
// bf16 at C (head dim 16, 256 keys) the tail is half of an item (its
// epilogues and the weight slabs), the softmax 44% (ex2 on the SFU, 16 a
// cycle per SM); at A and L the softmax and AV are half, the k|v waits a
// fifth at A; in f32 the 3xTF32 products on mma.sync (half wgmma's TF32
// rate) in the tail and the attention.  Left for later (ROADMAP):
// whole-sequence items with the k|v resident across a sequence's tiles, the
// tail's weights resident across items at C, x' in shared memory at C 256,
// AV on wgmma, f32 products on wgmma's TF32, and the long half's attention
// on this design.
//
// The pieces the tensor-parallel attention half at L > 64 shares with this
// block (fused_half_long_sm90.cu) are in long_sm90.cuh.

#include "long_sm90.cuh"

namespace {

constexpr int kMaxKv = 4;     // k|v stages of the attention entry's ring
constexpr int kMaxQ = 2;      // q slots
constexpr int kCopyWarp = 9;  // the first of the producer warps that copy q and k|v
constexpr int kCopyLanes = 96;  // warps 9-11

// Phase cycles of the attention entry (measurement builds only,
// -DTANTE_PHASE_TIMING; tools/kernel_phases.py --long): per CTA, the SM
// cycles consumer thread 0 spent waiting for k|v stages, in the scores, the
// softmax, the AV product, waiting for q tiles, in the tail, at the barrier
// between an item's attention and its tail, in LN2 (part of the tail, with
// its barriers), and its items.  The tail's
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

// The widest column pass of the attention entry's matmuls (out-projection,
// fc1, fc2).
__host__ __device__ inline int tail_pass(const int* np) {
  const int m = np[1] > np[2] ? np[1] : np[2];
  return m > np[3] ? m : np[3];
}

// The attention entry's plan past the Shape: item rows, k|v stages, q slots,
// and whether the tail's tiles overlap the q slots and the ring.
struct AttnPlan {
  int R, kv, qs, overlap;
  int keep;   // x' stays in shared memory (bf16: where one out-projection pass covers C)
  int tiles;  // R-row tiles (set by the launch: sequences x tiles of a sequence)
  int big;    // the first `big` tiles are one item each; each later tile is two
              // 64-row "pair" items (bf16, R = 128, no overlap: see pair_items)
};

// bf16 pair items' exchange area in the tail's tile h (free during the
// attention when the plan keeps h apart from the q slots and the ring): per
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

// The attention entry's shared memory: the attention output (later the LN2
// output, then fc2's staging tile in bf16); the tail's tile h (bf16: the
// out-projection's staging tile, then the MLP hidden; f32: the hidden); with
// `keep`, the out-projection's staging tile x apart, holding x' until fc2;
// the q slots and the k|v ring (after h, or over it where `overlap`); the
// weight ring; the barriers (weight ring full / empty, k|v full / empty, q
// full / empty, the item's end).  Each region on 128 bytes.
struct AttnLayout {
  size_t ao, h, x, q, kv, ring, bars, total;
};
constexpr int kAttnBars = 2 * kMaxStages + 2 * kMaxKv + 2 * kMaxQ + 1;

__host__ __device__ inline AttnLayout layout_attn(bool f32, int C, int HID, const int* np,
                                                  int stages, const AttnPlan& P) {
  AttnLayout l{};
  const size_t e = f32 ? 4 : 2;
  const size_t ao = f32 ? (size_t)P.R * ld_f(C) * 4 : (size_t)P.R * C * 2;
  size_t h = f32 ? (size_t)P.R * ld_f(HID) * 4 : (size_t)P.R * HID * 2;
  // x' (keep): bf16 the out-projection's staging tile, f32 a row-major tile.
  const size_t stage = f32 ? (size_t)P.R * ld_f(C) * 4 : (size_t)P.R * (np[1] + 8) * 2;
  if (!f32) {
    if (!P.keep) h = stage > h ? stage : h;
    h = h > (size_t)kPairScratch ? h : (size_t)kPairScratch;
  }
  l.ao = 0;
  l.h = align128(ao);
  l.x = align128(l.h + h);
  l.q = P.overlap ? l.h : align128(l.x + (P.keep ? stage : 0));
  l.kv = align128(l.q + (size_t)P.qs * q_bytes(f32, P.R));
  size_t end = l.kv + (size_t)P.kv * kv_bytes(f32);
  if (P.overlap && l.h + h > end) end = l.h + h;
  l.ring = align128(end);
  l.bars = l.ring + (size_t)stages * (f32 ? kSlabKF : kSlabK) * tail_pass(np) * e;
  l.total = l.bars + kAttnBars * sizeof(uint64_t);
  return l;
}

// ---- the qkv entry --------------------------------------------------------------
//
// long_sm90.cuh's qkv body over all C/64 head groups.

__global__ void __launch_bounds__(kThreads, 1) block_long_qkv_kernel(const __grid_constant__ LongArgs A) {
  long_qkv<false>(A);
}

__global__ void __launch_bounds__(kThreads, 1) block_long_qkv_f32_kernel(const __grid_constant__ LongArgs A) {
  long_qkv_f32<false>(A);
}

// ---- the attention entry: work items, copies, rings -------------------------------

// Item i: sequence s, query rows [q0, q0 + valid), key blocks 0 .. nkb - 1
// (the keys any of its queries admits).
// Item i: sequence s, query rows [q0, q0 + valid) of a `rows`-row item
// (valid <= 0: an empty second half of a ragged tile, skipped by all),
// key blocks 0 .. nkb - 1 (the keys any of its queries admits); pair: a
// 64-row item whose warpgroups share the rows and alternate key blocks.
struct Item {
  int s, q0, valid, nkb, rows;
  bool pair;
};
__device__ __forceinline__ int attn_items(const AttnPlan& P) {
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
// per item and head group, the q tile of the item's rows, then the group's
// k|v blocks (twice for "safe"), each into the next free slot or stage, an
// arrival from each lane once its copies land.  `base` is the group's q of
// the sequence in the workspace; k and v sit `part` and 2 * part elements
// further.
template <class T, int PASSES>
__device__ void produce_qkv(const LongArgs& A, const AttnPlan& AP, Pipe& P) {
  const int lane = threadIdx.x - kCopyWarp * 32, G = A.sh.C / 64, L = A.L;
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
// attention-output tile ao (core-matrix layout, C wide) at head column
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

template <int D, bool SAFE>
__device__ void attention_wg(const LongArgs& A, const Item& it, int gi, Pipe& P, bf16* ao,
                             float* scratch) {
  constexpr int HG = 64 / D;
  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = A.L, causal = A.causal, C = A.sh.C, R = it.rows;
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
        *reinterpret_cast<uint32_t*>(ao + blk(r0 + g + 8 * h, hc * D + nn * 8 + 2 * t, C)) =
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
// attention-output tile (ld_f(C)) at head column (gi*64/D + j)*D.

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

template <int D, bool SAFE>
__device__ void attention_f32(const LongArgs& A, const Item& it, int gi, Pipe& P, float* ao) {
  constexpr int HG = 64 / D;
  constexpr int ITEMS = 4 * HG;
  constexpr int IPW = (ITEMS + 7) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int L = A.L, causal = A.causal, C = A.sh.C;

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
  const int ld = ld_f(C);
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

// ---- LN2 of an item's rows (bf16) -------------------------------------------------
//
// layer_norm_g's arithmetic and stores (lane l: row l/4 of a warp's 8-row
// group, the 8-column blocks l%4 + 4i of it, so that one 16-byte store of
// the warp fills four whole core matrices), lighter on registers: a warp's
// groups (two at R = 128, one at 64) are loaded first, then each normalised
// with its scale and bias read per block (from L1), NB = C/32 blocks a lane.
// Rows past `valid` read as zeros.
template <int NB, class Load>
__device__ void ln_rows(Load load, int valid, bf16* dst, int R, int C,
                        const bf16* __restrict__ scale, const bf16* __restrict__ bias) {
  constexpr int kWarps = kConsumers / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  uint4 raw[2][NB];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r = (warp + g * kWarps) * 8 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      raw[g][i] = r < valid && r < R ? load(r, (q + 4 * i) * 8) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r = (warp + g * kWarps) * 8 + (lane >> 2);
    if (r >= R) break;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint32_t* pu = &raw[g][i].x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack_bf16(pu[e]);
        s += a.x + a.y;
        ss += a.x * a.x + a.y * a.y;
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / C;
    const float var = fmaxf(ss / C - mu * mu, 0.f);
    const float rs = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int c0 = (q + 4 * i) * 8;
      const uint4 sc4 = __ldg(reinterpret_cast<const uint4*>(scale + c0));
      const uint4 bi4 = __ldg(reinterpret_cast<const uint4*>(bias + c0));
      const uint32_t *ps = &sc4.x, *pb = &bi4.x, *pv = &raw[g][i].x;
      uint4 u;
      uint32_t* pu = &u.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 sc = unpack_bf16(ps[e]), bi = unpack_bf16(pb[e]), v = unpack_bf16(pv[e]);
        pu[e] = pack_bf16((v.x - mu) * rs * sc.x + bi.x, (v.y - mu) * rs * sc.y + bi.y);
      }
      *reinterpret_cast<uint4*>(dst + blk(r, c0, C)) = u;
    }
  }
}

// LN2 of the item's rows: ln_rows where C <= 256 (rows from device memory
// at src + rows.off(r), or with `xs` from x' kept in shared memory, `ldx`
// values a row), the body's layer_norm past it (64-row items).
template <class Rows>
__device__ void ln2_item(const bf16* src, const Rows& rows, const bf16* xs, int ldx, int valid,
                         bf16* dst, int R, int C, const bf16* scale, const bf16* bias) {
  if (C > 256) return layer_norm(src, rows, valid, dst, R, C, scale, bias);
  auto run = [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    if (xs)
      ln_rows<NB>([&](int r, int c) { return *reinterpret_cast<const uint4*>(xs + r * ldx + c); },
                  valid, dst, R, C, scale, bias);
    else
      ln_rows<NB>([&](int r, int c) {
        return __ldcg(reinterpret_cast<const uint4*>(src + rows.off(r) + c));
      }, valid, dst, R, C, scale, bias);
  };
  switch (C) {
    case 64: return run(std::integral_constant<int, 2>{});
    case 128: return run(std::integral_constant<int, 4>{});
    case 192: return run(std::integral_constant<int, 6>{});
    default: return run(std::integral_constant<int, 8>{});
  }
}

// The out-projection's epilogue that keeps x' = x + bf16(v + bias) in its
// staging tile (rows past `valid` hold no value anyone keeps) and writes
// nothing to y: LN2 and fc2 read it there.
struct EpiKeepX : EpiResidual<ContigTile, ContigTile> {
  __device__ void finish(int, int) const { consumers_sync(); }
};

// fc2's epilogue with x' in shared memory (xs, ldx values a row): y =
// bf16(x' + bf16(v + bias)) through the staging tile, as EpiResidual's.
struct EpiResidualKept {
  const bf16* xs;
  int ldx;
  bf16* y;
  ContigTile yr;
  const bf16* b;
  bf16* stage;
  int ld, valid;
  __device__ uint32_t bias(int c) const { return *reinterpret_cast<const uint32_t*>(b + c); }
  __device__ void begin(int, int) const {}
  __device__ void ready() const {}
  __device__ void store(int r, int c, int n0, int, float v0, float v1, uint32_t bb) const {
    const float2 f = unpack_bf16(bb);
    const float2 x = unpack_bf16(*reinterpret_cast<const uint32_t*>(xs + r * ldx + c));
    *reinterpret_cast<uint32_t*>(stage + r * ld + (c - n0)) =
        pack_bf16(x.x + round_bf16(v0 + f.x), x.y + round_bf16(v1 + f.y));
  }
  __device__ void finish(int n0, int np) const {
    consumers_sync();
    const int chunks = np >> 3;
    for (int i = threadIdx.x; i < valid * chunks; i += kConsumers) {
      const int r = i / chunks, k = i - r * chunks;
      *reinterpret_cast<uint4*>(y + yr.off(r) + n0 + k * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ld + k * 8);
    }
    consumers_sync();
  }
};

// f32 x' kept in shared memory (`keep`): the out-projection's epilogue adds
// the residual x as EpiResidualF does and stores x' = x + v to a row-major
// tile (ld floats a row) in place of y; fc2's reads x' there.  The sums are
// EpiResidualF's, so the results are those of the path through y.
struct EpiKeepXF {
  const float* res_;
  ContigTile rr;
  float* xs;
  int ld;
  const float* b;
  int valid;
  __device__ float2 bias(int c) const { return __ldg(reinterpret_cast<const float2*>(b + c)); }
  __device__ float2 res(int r, int c) const {
    return r < valid ? __ldcg(reinterpret_cast<const float2*>(res_ + rr.off(r) + c))
                     : make_float2(0.f, 0.f);
  }
  __device__ void store(int r, int c, float2 v, float2 x) const {
    *reinterpret_cast<float2*>(xs + r * ld + c) = make_float2(x.x + v.x, x.y + v.y);
  }
};
struct EpiResidualKeptF {
  const float* xs;
  int ld;
  float* y;
  ContigTile yr;
  const float* b;
  int valid;
  __device__ float2 bias(int c) const { return __ldg(reinterpret_cast<const float2*>(b + c)); }
  __device__ float2 res(int r, int c) const {
    return *reinterpret_cast<const float2*>(xs + r * ld + c);
  }
  __device__ void store(int r, int c, float2 v, float2 x) const {
    if (r < valid)
      *reinterpret_cast<float2*>(y + yr.off(r) + c) = make_float2(x.x + v.x, x.y + v.y);
  }
};

// LN2 of an f32 item from x' in shared memory: layer_norm_f32's arithmetic
// (one-pass moments; warp w rows w + 8g, lane l the float4 columns l and
// l + 32), its rows past `valid` zeros.
__device__ void ln_f32_kept(const float* xs, int ld, int valid, float* dst, int C,
                            const float* __restrict__ scale, const float* __restrict__ bias) {
  constexpr int kWarps = kConsumers / 32, G = kRowsF / kWarps, NB = kMaxCF / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nq = C / 4, ldd = ld_f(C);
  float4 v[G][NB];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r = warp + g * kWarps;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int q = lane + 32 * i;
      v[g][i] = q < nq && r < valid ? *reinterpret_cast<const float4*>(xs + r * ld + 4 * q)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r = warp + g * kWarps;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float4 a = v[g][i];
      s += (a.x + a.y) + (a.z + a.w);
      ss += (a.x * a.x + a.y * a.y) + (a.z * a.z + a.w * a.w);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float var = fmaxf(ss / C - mu * mu, 0.f);
    const float rs = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int q = lane + 32 * i;
      if (q >= nq) break;
      const float4 a = v[g][i];
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale) + q);
      const float4 bi = __ldg(reinterpret_cast<const float4*>(bias) + q);
      *reinterpret_cast<float4*>(dst + r * ldd + 4 * q) =
          make_float4((a.x - mu) * rs * sc.x + bi.x, (a.y - mu) * rs * sc.y + bi.y,
                      (a.z - mu) * rs * sc.z + bi.z, (a.w - mu) * rs * sc.w + bi.w);
    }
  }
}

// ---- the attention entry's CTA --------------------------------------------------------
//
// Lay out the shared memory, start the barriers, split the threads: the
// producer warpgroup gives its registers to the consumers (setmaxnreg 40 /
// 232); its thread 0 streams the tail's weight slabs item after item, its
// last three warps copy q and k|v; the two consumer warpgroups run each
// item's attention and tail.
template <class T, int PASSES, class Item_>
__device__ __forceinline__ void attn_cta(const LongArgs& A, const AttnPlan& AP, Item_&& item) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool F32 = sizeof(T) == 4;
  const Shape& S = A.sh;
  const AttnLayout lay = layout_attn(F32, S.C, S.HID, S.np, S.stages, AP);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Ring ring{smem + lay.ring, bars, bars + kMaxStages, S.stages,
            (F32 ? kSlabKF * 4 : kSlabK * 2) * tail_pass(S.np), 0};
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
      int idx = 0;
      const int groups = S.C / 64;
      for (int i = blockIdx.x; i < items; i += gridDim.x)
        if (item_at(A, AP, i).valid > 0)
          produce_tile<T>(static_cast<const unsigned char*>(A.p[WARR]), S, ring, idx, groups,
                          groups + 3);
    } else if (threadIdx.x >= kCopyWarp * 32) {
      produce_qkv<T, PASSES>(A, AP, P);
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

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
    block_long_attn_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ AttnPlan AP) {
  attn_cta<bf16, SAFE ? 2 : 1>(A, AP, [&](const Item& it, Ring& ring, Pipe& P, bf16* ao, bf16* h,
                                           bf16* xs) {
    const Shape& S = A.sh;
    const int C = S.C, HID = S.HID, R = it.rows;
    for (int gi = 0; gi < C / 64; ++gi)
      attention_wg<D, SAFE>(A, it, gi, P, ao, reinterpret_cast<float*>(h));
    LCLK(t0);
    fence_async_smem();  // the attention output (generic stores) before wgmma reads it
    consumers_sync();
    LCLK(t1);
    LADD(PH_BETWEEN, t1 - t0);
    const ContigTile rows{((size_t)it.s * A.L + it.q0) * C, C};
    const bf16* x = static_cast<const bf16*>(A.x);
    bf16* y = static_cast<bf16*>(A.y);
    auto w = [&](int k) { return static_cast<const bf16*>(A.p[k]); };
    // x' = x + bf16(attn wo + bo): kept in shared memory (xs) or to y; the
    // residual staged in h (or xs).
    const int ldx = S.np[1] + 8;
    const EpiResidual<ContigTile, ContigTile> oproj{x, rows, y, rows, w(BO), AP.keep ? xs : h,
                                                    ldx, it.valid};
    if (AP.keep)
      gemm_np(ao, C, C, S.np[1], R, ring, EpiKeepX{oproj}, 1, blockIdx.x);
    else
      gemm_np(ao, C, C, S.np[1], R, ring, oproj, 1, blockIdx.x);
    consumers_sync();
    LCLK(t3);
    ln2_item(y, rows, AP.keep ? xs : nullptr, ldx, it.valid, ao, R, C, w(LN2S), w(LN2B));
    fence_async_smem();
    consumers_sync();
    LCLK(t4);
    LADD(PH_LN2, t4 - t3);
    gemm_np(ao, C, HID, S.np[2], R, ring, EpiGelu{h, w(B1), HID}, 2, blockIdx.x);
    fence_async_smem();
    consumers_sync();
    const int ld2 = S.np[3] + 8 <= C ? S.np[3] + 8 : S.np[3];
    if (AP.keep)
      gemm_np(h, HID, C, S.np[3], R, ring,
              EpiResidualKept{xs, ldx, y, rows, w(B2), ao, ld2, it.valid}, 3, blockIdx.x);
    else
      gemm_np(h, HID, C, S.np[3], R, ring,
              EpiResidual<ContigTile, ContigTile>{y, rows, y, rows, w(B2), ao, ld2, it.valid}, 3,
              blockIdx.x);
    LCLK(t2);
    LADD(PH_TAIL, t2 - t1);
  });
}

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
    block_long_attn_f32_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ AttnPlan AP) {
  attn_cta<float, SAFE ? 2 : 1>(A, AP, [&](const Item& it, Ring& ring, Pipe& P, float* ao, float* h,
                                            float* xs) {
    const Shape& S = A.sh;
    const int C = S.C, HID = S.HID;
    for (int gi = 0; gi < C / 64; ++gi) attention_f32<D, SAFE>(A, it, gi, P, ao);
    LCLK(t0);
    consumers_sync();  // the attention output in place before the out-projection reads it
    LCLK(t1);
    LADD(PH_BETWEEN, t1 - t0);
    const ContigTile rows{((size_t)it.s * A.L + it.q0) * C, C};
    const float* x = static_cast<const float*>(A.x);
    float* y = static_cast<float*>(A.y);
    auto w = [&](int k) { return static_cast<const float*>(A.p[k]); };
    const int ldx = ld_f(C);
    if (AP.keep)
      gemm_f32_np(ao, C, C, S.np[1], it.valid, ring,
                  EpiKeepXF{x, rows, xs, ldx, w(BO), it.valid}, 1, blockIdx.x);
    else
      gemm_f32_np(ao, C, C, S.np[1], it.valid, ring,
                  EpiResidualF<ContigTile, ContigTile>{x, rows, y, rows, w(BO), it.valid}, 1,
                  blockIdx.x);
    consumers_sync();  // x' stored; the attention output is read no more
    LCLK(t3);
    if (AP.keep)
      ln_f32_kept(xs, ldx, it.valid, ao, C, w(LN2S), w(LN2B));
    else
      layer_norm_f32(y, rows, it.valid, ao, C, w(LN2S), w(LN2B));
    consumers_sync();
    LCLK(t4);
    LADD(PH_LN2, t4 - t3);
    gemm_f32_np(ao, C, HID, S.np[2], it.valid, ring, EpiGeluF{h, w(B1), ld_f(HID)}, 2,
                blockIdx.x);
    consumers_sync();
    if (AP.keep)
      gemm_f32_np(h, HID, C, S.np[3], it.valid, ring,
                  EpiResidualKeptF{xs, ldx, y, rows, w(B2), it.valid}, 3, blockIdx.x);
    else
      gemm_f32_np(h, HID, C, S.np[3], it.valid, ring,
                  EpiResidualF<ContigTile, ContigTile>{y, rows, y, rows, w(B2), it.valid}, 3,
                  blockIdx.x);
    consumers_sync();  // the hidden and LN2 tiles free for the next item
    LCLK(t2);
    LADD(PH_TAIL, t2 - t1);
  });
}

// ---- host side -------------------------------------------------------------------

// plan: the qkv entry's tile rows, its ring stages, the four column passes
// (q|k|v, out-projection, fc1, fc2), the attention entry's weight ring
// stages, its item rows, k|v stages, q slots, overlap and keep
// (ops/fused_block.py:long_plan).  Fills S (and AP) for the entry (`attn`)
// and returns its shared memory bytes, 0 when the plan is outside the
// kernels.

long long long_shape(Shape& S, AttnPlan& AP, const int* plan, int C, int HID, bool f32,
                     bool attn) {
  S.C = C;
  S.HID = HID;
  for (int i = 0; i < 4; ++i) S.np[i] = plan[2 + i];
  S.R = attn ? plan[7] : plan[0];
  S.stages = attn ? plan[6] : plan[1];
  AP = AttnPlan{plan[7], plan[8], plan[9], plan[10], plan[11]};
  const int maxc = f32 ? kMaxCF : kMaxC;
  if (C % 64 || C < 64 || C > maxc || HID % 64 || HID < 64 || HID > 2 * C || S.stages < 2 ||
      S.stages > kMaxStages || S.np[0] != kQkvN || !np_ok(S.np[1], C) || !np_ok(S.np[2], HID) ||
      !np_ok(S.np[3], C))
    return 0;
  if (f32 && (S.np[1] > 128 || S.np[2] > 128 || S.np[3] > 128)) return 0;
  if (attn) {
    const int R = f32 ? kRowsF : (C <= 256 ? 128 : 64);  // a 128-row LayerNorm holds C <= 256
    if (AP.R != R || AP.kv < 2 || AP.kv > kMaxKv || AP.qs < 1 || AP.qs > kMaxQ ||
        (AP.overlap != 0 && AP.overlap != 1) || (AP.keep != 0 && AP.keep != 1) ||
        (AP.keep && (AP.overlap || (!f32 && S.np[1] != C))))
      return 0;
    return (long long)layout_attn(f32, C, HID, S.np, S.stages, AP).total;
  }
  if (f32 ? S.R != kRowsF : (S.R != 64 && (S.R != 128 || C > 256))) return 0;
  return (long long)layout_qkv(f32, S.R, C, S.stages).total;
}

// The checks both entries share; fills A.  0 = launch, else a cudaError_t
// (or -1: nothing to run).
int prepare(LongArgs& A, AttnPlan& AP, long long& smem, const void* const* w, const int* plan,
            int n_seqs, int L, int C, int HID, bool f32, bool attn, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  A = LongArgs{};
  smem = long_shape(A.sh, AP, plan, C, HID, f32, attn);
  for (int k = 0; k < kNPtr; ++k) A.p[k] = w[k];
  return prepare_sizes(A, smem, n_seqs, L, device);
}

template <bool F32>
int launch_qkv(const void* x, void* ws, const void* const* w, const int* plan, int n_seqs, int L,
               int C, int HID, int device, void* stream) {
  LongArgs A;
  AttnPlan AP;
  long long smem = 0;
  const int rc = prepare(A, AP, smem, w, plan, n_seqs, L, C, HID, F32, false, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  A.x = x;
  A.ws = ws;
  const int grid = (A.tokens + A.sh.R - 1) / A.sh.R;
  if (F32) return launch_kernel(block_long_qkv_f32_kernel, A, grid, smem, stream);
  return launch_kernel(block_long_qkv_kernel, A, grid, smem, stream);
}

template <class K>
cudaError_t launch_attn_kernel(K k, const LongArgs& A, const AttnPlan& AP, int grid,
                               long long smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, AP);
  return cudaGetLastError();
}

template <bool F32, int D>
cudaError_t launch_attn_d(const LongArgs& A, const AttnPlan& AP, int safe, int grid,
                          long long smem, void* stream) {
  if constexpr (F32)
    return safe ? launch_attn_kernel(block_long_attn_f32_kernel<D, true>, A, AP, grid, smem, stream)
                : launch_attn_kernel(block_long_attn_f32_kernel<D, false>, A, AP, grid, smem, stream);
  else
    return safe ? launch_attn_kernel(block_long_attn_kernel<D, true>, A, AP, grid, smem, stream)
                : launch_attn_kernel(block_long_attn_kernel<D, false>, A, AP, grid, smem, stream);
}

// The attention entry's grid: one CTA per SM, at most one per item.
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

template <bool F32>
int launch_attn(const void* x, const void* ws, void* y, const void* const* w, const int* plan,
                int n_seqs, int L, int C, int HID, int heads, int causal, int safe, int device,
                void* stream) {
  LongArgs A;
  AttnPlan AP;
  long long smem = 0;
  const int rc = prepare(A, AP, smem, w, plan, n_seqs, L, C, HID, F32, true, device);
  if (rc) return rc < 0 ? cudaSuccess : rc;
  if ((long long)n_seqs * ((L + AP.R - 1) / AP.R) * 2 >= (1ll << 31)) return cudaErrorInvalidValue;
  const int d = head_dim(C, heads);
  if (!d) return cudaErrorInvalidValue;
  A.x = x;
  A.ws = const_cast<void*>(ws);
  A.y = y;
  A.causal = causal ? 1 : 0;
  A.qtiles = (L + AP.R - 1) / AP.R;  // tiles of a sequence
  AP.tiles = n_seqs * A.qtiles;
  AP.big = pair_items(AP, F32, device);
  const int grid = attn_grid(AP.big + 2 * (AP.tiles - AP.big), device);
  if (d == 16) return launch_attn_d<F32, 16>(A, AP, safe, grid, smem, stream);
  if (d == 32) return launch_attn_d<F32, 32>(A, AP, safe, grid, smem, stream);
  return launch_attn_d<F32, 64>(A, AP, safe, grid, smem, stream);
}

}  // namespace

extern "C" {

// x: (S, L, C) bf16; ws: (3, S, C/64, L, 64) bf16, written.  w: the 9 device
// pointers of tante_fused_block_sm90_fwd (ln1_scale, ln1_bias, each head
// group's q|k|v bias with q prescaled, bo, ln2_scale, ln2_bias, b1, b2, the
// re-laid weights: ops/fused_block.py:sm90_weights).  plan: 12 ints
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
  AttnPlan AP;
  bytes[0] = long_shape(S, AP, plan, C, HID, f32 != 0, false);
  bytes[1] = long_shape(S, AP, plan, C, HID, f32 != 0, true);
  return 0;
}

// The attention entry's work on n_seqs sequences of L under `plan` on the
// device: out = its R-row tiles, the big ones (one item each; the others two
// pair items each), its items and its grid.  Returns a cudaError_t.
int tante_block_long_attn_items(const int* plan, int n_seqs, int L, int C, int HID, int f32,
                                int device, int* out) {
  Shape S;
  AttnPlan AP;
  if (!long_shape(S, AP, plan, C, HID, f32 != 0, true) || L < 1 || n_seqs < 1)
    return cudaErrorInvalidValue;
  AP.tiles = n_seqs * ((L + AP.R - 1) / AP.R);
  AP.big = pair_items(AP, f32 != 0, device);
  out[0] = AP.tiles;
  out[1] = AP.big;
  out[2] = AP.big + 2 * (AP.tiles - AP.big);
  out[3] = attn_grid(out[2], device);
  return cudaSuccess;
}

#ifdef TANTE_PHASE_TIMING
int tante_block_long_phase_count() { return kLongPhases; }
// Copies (and zeroes) the attention entry's phase cycles of the first n CTAs
// (n x kLongPhases values, see g_long_cycles).
int tante_block_long_phase_read(unsigned long long* host, int n) {
  if (n > kPhaseSlots) n = kPhaseSlots;
  const size_t bytes = sizeof(unsigned long long) * kLongPhases * n;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_long_cycles, bytes);
  if (err != cudaSuccess) return err;
  static unsigned long long zeros[kPhaseSlots * kLongPhases];
  return cudaMemcpyToSymbol(g_long_cycles, zeros, bytes);
}
#endif

}  // extern "C"
