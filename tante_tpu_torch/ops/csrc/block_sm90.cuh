// Fused pre-LN axial transformer block for Hopper (sm_90a), bf16, and its
// f32 instantiation (block_tile_f32, the "f32 tile body" section; the element
// type is a policy, Elem<T>, of the weight stream): one tile
// body, redesigned for this card, shared by three sources (each its own
// library, built in parallel; fused_half_sm90.cu, the two tensor-parallel
// halves, runs its parts: LayerNorm, the slab ring, gemm_np with EpiQkv,
// EpiGelu and EpiPartial, attention_group; fused_half_sm90_f32.cu runs the
// f32 body's: layer_norm_f32, gemm_f32 with EpiQkvF, EpiGeluF and
// EpiPartialF, attention_group_f32):
//
//   y = x' + fc2(gelu_tanh(fc1(ln2(x'))))      x' = x + wo(attn(ln1(x)))
//
// The body runs a tile of whole sequences; where a tile's rows sit in device
// memory is a row map (a template argument), read for x and written for y.
//
// fused_block_sm90.cu, one CTA per tile:
//   tante_fused_block_sm90_fwd     rows of (S, L, C): a sequence is L
//                                  consecutive rows (ContigTile).  Replaces
//     tante_tpu/ops/pallas_block.py fused_block_apply (_pallas_block ->
//     _kernel -> _kernel_body = _attn_half_body + _mlp_half_body), in both
//     of its softmax forms ("fast" and "safe", a template flag).
//   tante_fused_block_canon_t_sm90_fwd
//                                  the causal T block on canonical
//                                  (B, T, H, W, C): a sequence is one
//     pixel's T steps at a stride of H*W rows (StridedTile), no transpose on
//     either side.  Replaces pallas_block.py fused_block_canon_t (_roll_body,
//     which rolled k/v by multiples of H*W rows because Mosaic cannot split
//     lanes).
// fused_chain_sm90.cu:
//   tante_fused_chain_sm90_fwd     a run of up to 12 T/H/W blocks on one
//                                  (B, T, H, W) token grid in ONE
//     cooperative launch: a persistent grid (one CTA per SM) walks each
//     block's tiles under that block's strided maps, first axis's token
//     order in, last axis's out, two canonical ping-pong buffers between.
//     Replaces pallas_block.py fused_chain_apply / fused_group_apply (one
//     body, _group_kernel, whose 0/1 permutation matmuls become addressing).
//     The tiles of all blocks form one schedule, dealt round-robin to the
//     CTAs, and a tile waits only for the previous block's tiles of its own
//     batch elements (completion counters, among the consumer warpgroups
//     alone): no CTA idles through a short last wave.  One producer thread
//     streams the slabs of every (block, tile) the CTA runs through one
//     ring, initialised once: weights never depend on activations, so the
//     next tile's slabs, and the next block's, load while the current tile
//     computes or waits.
//
// A strided map gives sequence g = (b, i, j) (i, j over the two other axes,
// j inner) its token p at row b*sb + i*s1 + j*s2 + p*sa.  Within a tile the
// offsets are worked out in registers: a tile whose sequences are evenly
// spaced (all but the few that wrap a line or a batch element) reads tile
// row r = s*L + p at base + s*s2 + p*sa rows = base + (r*sa + s*(s2 - L*sa))*C
// elements, two 32-bit multiply-adds after r / L; the divisions by L, per
// and n2 are multiply-highs by constants made on the host.  Every activation read stays L2-only
// (ld.global.cg, cp.async.cg): inside the chain another SM wrote it earlier
// in the same launch; only the weights, never written in a launch, take the
// bulk-copy (async) proxy.  Rounding points are the same under every map, so
// the canonical T kernel equals the single-block kernel on the rearranged
// tensor, and a chain the single-block kernels in sequence, bit for bit.
//
// Bound at the flagship shape (M = 24576 rows, C = hidden = 256):
// 2*M*(4C^2 + 2C*hidden) = 19.3 GFLOP of matmul plus 4*M*L*C of attention
// -> ~20 us at 989 TFLOP/s dense bf16; ~26 MB of device memory (x in, y
// out, 0.8 MB of weights) -> ~8 us at 3.35 TB/s.  Bound by operations.
//
// What held the first design (fused_block.cu, block_tile) at ~10x the bound:
// mma.sync through wmma at ~1.1 TFLOP/s per SM, 48-64-row tiles that each
// re-read all 0.77 MB of weights from L2 (~0.3-0.4 GB per launch), per-warp
// cp.async weight rings, and phases separated by CTA barriers with nothing
// in flight across them.  This design:
//
// - Tiles of R = 128 rows (two consumer warpgroups of 64 rows; R = 64 when
//   C or the MLP width is too wide for the shared memory) hold whole
//   sequences: 8 of L = 16, 2 of L = 48, 32 of L = 4.  Each tile reads the
//   weights once: half the L2 weight traffic of 64-row tiles.
// - Every matmul is wgmma.mma_async m64n64k16 (bf16, f32 accumulators in
//   registers), A and B from shared memory in the no-swizzle K-major
//   core-matrix layout (8 rows x 16 bytes per 128-byte core matrix).
// - Weights are re-laid by the wrapper, once per weight version, into that
//   layout, slab after slab (32 rows of K x one column pass) in exactly the
//   order the tile consumes them, so one producer thread streams the whole
//   schedule with plain 1-D cp.async.bulk copies into a ring of slabs,
//   completed on mbarriers, while the consumer warpgroups compute: the
//   first slabs load during LayerNorm, the next matmul's during attention.
//   The producer's warpgroup gives its registers to the consumers
//   (setmaxnreg: 40 / 232), whose accumulators and epilogue loads need them.
// - Attention runs head group by head group (64 columns of q, k and v at a
//   time: 2 heads of d = 32), so q/k/v of all heads never need shared memory
//   at once: one m64n192 projection of the group, then each (16-query block,
//   head) item on one warp with mma.sync m16n8k16, scores, softmax and the
//   probabilities kept in registers (the score fragment is the A fragment of
//   the AV product), k and v read with ldmatrix (v transposed).  A query
//   block may span several short sequences (L = 4): keys outside the
//   query's own sequence are masked.
// - The residual stream after attention (x') is written to y, read back by
//   LayerNorm 2 and by the last epilogue (an L2 round trip), which frees the
//   shared memory for the MLP's hidden activations.
//
// Numerics are those of fused_block.cu: q arrives prescaled by
// d^-0.5*log2(e) (folded into wq/bq by the wrapper); "fast": scores
// exp2(min(s, 60*log2 e)) with no max-subtract; "safe": exp2(s - rowmax)
// over the sequence's admitted keys (the Pallas kernel's masked f32 softmax
// with max-subtract).  Masked keys contribute exactly 0, the unnormalised
// weights are rounded to bf16 before the AV product, and the result is
// scaled by 1/(sum + 1e-30).  q/k/v, attention output, fc1 output and both
// residual sums are rounded to bf16; LayerNorm (one-pass moments), GELU,
// softmax and every accumulator are f32.  Only the order of the f32 sums
// differs from the first design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup (one thread issues)
constexpr int kSlabK = 32;                 // K rows of a weight slab
constexpr int kQkvN = 192;                 // q|k|v columns of one head group
constexpr int kQkvLd = kQkvN + 8;          // row stride of the q|k|v tile (bank spread)
constexpr int kMaxStages = 4;
constexpr int kUnits = 3;                  // a pass is at most 3 x 64 columns (96 f32 a thread)
constexpr int kMaxC = 512;
constexpr int kMaxKeyChunks = 8;           // keys of one query block: at most 2L <= 128
constexpr float kLog2e = 1.4426950408889634f;

enum { LN1S, LN1B, BQKV, BO, LN2S, LN2B, B1, B2, WARR, kNPtr };

constexpr int kMaxChain = 12;              // blocks of one chain launch

// What every block of a launch shares: widths and the tile plan (R rows,
// ring stages, column pass width of the qkv, o, fc1, fc2 matmuls).
struct Shape {
  int C, HID, R, stages;
  int np[4];
};

// Sequences of a (B, T, H, W) token grid along one axis, in any token order
// (ops/fused_block.py:chain_plan): sequence g = b*per + i*n2 + j has token p
// at row b*sb + i*s1 + j*s2 + p*sa.  mul/shift: g / per and r / n2 as
// multiply-highs.  lin: 2 when every sequence starts s2 rows after the one
// before, 1 when that holds within a batch element, else 0 (and 0 for a
// tensor of 2^32 elements or more).  sa_c, d_c: sa*C and (s2 - L*sa)*C
// modulo 2^32, the element strides of an evenly spaced tile.
struct RowMap {
  int per, n2, sb, s1, s2, sa;
  uint32_t mul_per, mul_n2;
  int shift_per, shift_n2, lin;
  uint32_t sa_c, d_c;
};

// One block: its parameters (see the extern "C" entries), its sequences,
// tiles and (the chain's) row maps.  mul_l/shift_l: r / L as a multiply-high.
struct Block {
  const bf16* p[kNPtr];
  RowMap in, out;
  int L, causal, n_seqs, seqs, tiles;
  uint32_t mul_l;
  int shift_l;
};

struct Args {
  Block blk;
  Shape sh;
  const bf16* x;
  bf16* y;
};

struct ChainArgs {
  Block step[kMaxChain];
  Shape sh;
  const bf16* x;       // the caller's input, first block's token order
  bf16* y;             // the caller's output, last block's token order
  bf16* buf[2];        // ping-pong, canonical order
  int* done;           // [block][batch element]: tiles finished, zeroed per launch
  int n_steps, n_batch;
};
// Twelve steps of 9 pointers, two row maps and a plan: within the 4 KB of
// kernel parameters every CUDA version takes.
static_assert(sizeof(ChainArgs) <= 4096, "chain argument block exceeds 4 KB");

// Phase timing (measurement builds only, -DTANTE_PHASE_TIMING; see
// tante_tpu_torch/tools/kernel_phases.py).  A slot is a tile of a
// single-block launch (its blockIdx.x), or a (block, CTA) pair of a chain
// (block * gridDim.x + blockIdx.x, where the phases are those of the CTA's
// first tile of that block and the matmul cycles sum over all its tiles).
// Consumer thread 0 stamps the global nanosecond timer after the consumers'
// barrier at each phase boundary: start, LN1, then per head group its q|k|v
// projection and its attention, out-projection, LN2, fc1, fc2.
constexpr int kPhaseSlots = 2048;
constexpr int kStamps = 2 + 2 * (kMaxC / 64) + 4;
#ifdef TANTE_PHASE_TIMING
__device__ unsigned long long g_phase_ns[kPhaseSlots][kStamps];
// Per slot and matmul (q|k|v, out-projection, fc1, fc2): SM cycles consumer
// thread 0 spent waiting for slabs, issuing and waiting on wgmma, and in the
// epilogue.
__device__ unsigned long long g_gemm_cycles[kPhaseSlots][4][3];
// Per chain slot: the start of the CTA's first tile of the block, the ns its
// consumers waited for the previous block's tiles (summed over its tiles),
// the end of its last tile of the block, and the producer's issue of the
// block's first slab (global timer, ns).
__device__ unsigned long long g_chain_ns[kPhaseSlots][4];
#define CLK(v) long long v = clock64()
#define ADD_CYCLES(kind, part, cycles)                                          \
  do {                                                                          \
    if (threadIdx.x == 0 && slot < kPhaseSlots)                                 \
      g_gemm_cycles[slot][kind][part] += (unsigned long long)(cycles);          \
  } while (0)
#define STAMP(i)                                                                 \
  do {                                                                           \
    if (threadIdx.x == 0 && stamp && slot < kPhaseSlots) {                       \
      g_phase_ns[slot][i] = globaltimer();                                       \
    }                                                                            \
  } while (0)
#else
#define STAMP(i) \
  do {           \
  } while (0)
#define CLK(v) \
  do {         \
  } while (0)
#define ADD_CYCLES(kind, part, cycles) \
  do {                                 \
  } while (0)
#endif

// ---- small PTX helpers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// n / d for 0 <= n < 2^31 with mul, shift from fast_div(d) (Granlund and
// Montgomery's round-up multiplier: exact, d = 1 and powers of two included).
__device__ __forceinline__ int fdiv(int n, uint32_t mul, int shift) {
  return (int)((__umulhi((uint32_t)n, mul) + (uint32_t)n) >> shift);
}
void fast_div(int d, uint32_t* mul, int* shift) {
  int l = 0;
  while ((1ll << l) < d) ++l;
  *mul = (uint32_t)((((1ull << 32) * ((1ull << l) - (uint64_t)d)) / (uint64_t)d) + 1);
  *shift = l;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// Generic-proxy writes to shared memory become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start, leading byte offset
// (between the two core matrices along K), stride byte offset (between
// 8-row groups), all in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N f32, this thread's N/2) += A (64 x 16) B (16 x N), both K-major in
// shared memory.  One instruction per width the matmuls use.
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<192>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// c (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col).
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) { return bf2f(__float2bfloat16(v)); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element offset of (row r, column k) in a K-major core-matrix tile that is
// K columns wide: core matrix (r/8, k/8) holds 8 rows of 8 columns.
__device__ __forceinline__ int blk(int r, int k, int K) {
  return (((r >> 3) * (K >> 3) + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}

// ---- row maps: where tile row r (= sequence r / L, token r % L) lives ---------
//
// Bound to one tile; off(r) is an element offset, for r below the tile's
// valid rows.

struct ContigTile {  // sequences of L consecutive rows
  size_t base;
  int C;
  __device__ __forceinline__ size_t off(int r) const { return base + (size_t)r * C; }
};
__device__ __forceinline__ ContigTile contig_tile(const Block& B, int seq0, int C) {
  return ContigTile{(size_t)seq0 * B.L * C, C};
}

struct StridedTile {
  const RowMap* m;
  const Block* B;
  size_t base;  // the first sequence's element offset, when the tile's sequences are evenly spaced
  int seq0, lin, C;
  __device__ __forceinline__ size_t off(int r) const {
    const int s = fdiv(r, B->mul_l, B->shift_l);
    if (lin) return base + (uint32_t)((uint32_t)r * m->sa_c + (uint32_t)s * m->d_c);
    const int p = r - s * B->L, g = seq0 + s;
    const int b = fdiv(g, m->mul_per, m->shift_per), rem = g - b * m->per;
    const int i = fdiv(rem, m->mul_n2, m->shift_n2), j = rem - i * m->n2;
    return ((size_t)b * m->sb + (size_t)i * m->s1 + (size_t)j * m->s2 + (size_t)p * m->sa) * C;
  }
};
// The tile of sequences [seq0, seq0 + nseq): evenly spaced unless it wraps a
// line (i) or a batch element (b) whose rows do not follow on.
__device__ __forceinline__ StridedTile strided_tile(const Block& B, const RowMap& m, int seq0,
                                                    int nseq, int C) {
  const int g1 = seq0 + nseq - 1;
  const int b0 = fdiv(seq0, m.mul_per, m.shift_per), b1 = fdiv(g1, m.mul_per, m.shift_per);
  const int r0 = seq0 - b0 * m.per;
  const int i0 = fdiv(r0, m.mul_n2, m.shift_n2), i1 = fdiv(g1 - b1 * m.per, m.mul_n2, m.shift_n2);
  const int lin = m.lin == 2 || (b0 == b1 && (m.lin == 1 || i0 == i1));
  const size_t base = (size_t)b0 * m.sb + (size_t)i0 * m.s1 + (size_t)(r0 - i0 * m.n2) * m.s2;
  return StridedTile{&m, &B, base * C, seq0, lin, C};
}

// ---- LayerNorm: R rows of C from device memory into a core-matrix tile ------
//
// f32 one-pass moments; rows past `valid` read as zeros.  A warp takes groups
// of 8 rows: lane l owns row l/4 of the group and the 8-column blocks
// l%4, l%4 + 4, ... of it, so that one 16-byte store of the warp fills four
// whole core matrices (conflict-free) and a row's sums meet in 4 lanes.  All
// of a warp's rows (and its scale and bias) are loaded before any row is
// stored: a store to shared memory would otherwise hold each later load
// behind it.  Row r of the tile is read at src + rows.off(r).
template <int NB, int GROUPS, class Rows>  // 8-column blocks a lane owns per row (at most); groups per warp
__device__ void layer_norm_g(const bf16* src, const Rows& rows, int valid, bf16* dst, int R, int C,
                             const bf16* __restrict__ scale, const bf16* __restrict__ bias) {
  constexpr int kWarps = kConsumers / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int nb = C / 32;
  uint4 raw[GROUPS][NB], sc[NB], bi[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (i < nb) {
      sc[i] = *reinterpret_cast<const uint4*>(scale + (q + 4 * i) * 8);
      bi[i] = *reinterpret_cast<const uint4*>(bias + (q + 4 * i) * 8);
    }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int r = (warp + g * kWarps) * 8 + (lane >> 2);
    const bf16* row = r < valid ? src + rows.off(r) : src;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      raw[g][i] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nb && r < valid)
        raw[g][i] = __ldcg(reinterpret_cast<const uint4*>(row + (q + 4 * i) * 8));
    }
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
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
      if (i >= nb) break;
      const int c0 = (q + 4 * i) * 8;
      const uint32_t *ps = &sc[i].x, *pb = &bi[i].x, *pv = &raw[g][i].x;
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

// R = 128 holds C <= 256 (8 blocks a lane, 2 groups a warp); R = 64 any C.
template <class Rows>
__device__ void layer_norm(const bf16* src, const Rows& rows, int valid, bf16* dst, int R, int C,
                           const bf16* __restrict__ scale, const bf16* __restrict__ bias) {
  if (R == 128)
    layer_norm_g<8, 2>(src, rows, valid, dst, R, C, scale, bias);
  else
    layer_norm_g<kMaxC / 32, 1>(src, rows, valid, dst, R, C, scale, bias);
}

// ---- the weight ring ---------------------------------------------------------

struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage_bytes;
  int idx;  // slabs consumed so far in this tile
};

// A consumer warp is done with slab i: one arrival per warp (256 arrivals
// on one barrier would queue on its shared-memory word).
__device__ __forceinline__ void release(Ring& ring, int i) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[i % ring.stages]);
}

// ---- matmul epilogues ------------------------------------------------------
//
// For a pair of adjacent columns (c absolute, of a pass at n0 of np columns):
// bias(c) reads device memory (called before the pass's products, so the
// loads land while the tensor cores work) and store(...) writes.  begin,
// ready and finish run on every consumer thread around a pass.

struct EpiQkv {  // + bias -> bf16, row-major q|k|v tile
  bf16* dst;
  const bf16* b;
  __device__ uint32_t bias(int c) const { return *reinterpret_cast<const uint32_t*>(b + c); }
  __device__ void begin(int, int) const {}
  __device__ void ready() const {}
  __device__ void store(int r, int c, int, int, float v0, float v1, uint32_t bb) const {
    const float2 f = unpack_bf16(bb);
    *reinterpret_cast<uint32_t*>(dst + r * kQkvLd + c) = pack_bf16(v0 + f.x, v1 + f.y);
  }
  __device__ void finish(int, int) const {}
};

struct EpiGelu {  // bf16(gelu_tanh(v + bias)) into a core-matrix tile K = HID wide
  bf16* dst;
  const bf16* b;
  int K;
  // tanh on the SFU (tanh.approx.f32, max relative error ~2^-11, far below
  // the bf16 rounding of the result).
  __device__ static float gelu(float h) {
    float t;
    const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(u));
    return 0.5f * h * (1.f + t);
  }
  __device__ uint32_t bias(int c) const { return *reinterpret_cast<const uint32_t*>(b + c); }
  __device__ void begin(int, int) const {}
  __device__ void ready() const {}
  __device__ void store(int r, int c, int, int, float v0, float v1, uint32_t bb) const {
    const float2 f = unpack_bf16(bb);
    *reinterpret_cast<uint32_t*>(dst + blk(r, c, K)) = pack_bf16(gelu(v0 + f.x), gelu(v1 + f.y));
  }
  __device__ void finish(int, int) const {}
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src) : "memory");
}

// y = bf16(res + bf16(v + bias)) for the tile's valid rows, through a
// row-major staging tile in shared memory (ld elements a row): the pass's
// residual columns come in with 16-byte cp.async copies while the products
// run, the sums go back into the tile, and the tile leaves in 16-byte row
// pieces.  4-byte loads and stores scattered over rows cost more than the
// matmul itself.  Tile row r is read at res + rr.off(r), written at
// y + yr.off(r).
template <class ResRows, class OutRows>
struct EpiResidual {
  const bf16* res;  // x (out-projection) or y itself (fc2: x' stored there)
  ResRows rr;
  bf16* y;
  OutRows yr;
  const bf16* b;
  bf16* stage;
  int ld, valid;
  __device__ uint32_t bias(int c) const { return *reinterpret_cast<const uint32_t*>(b + c); }
  __device__ void begin(int n0, int np) const {
    const int chunks = np >> 3;
    for (int i = threadIdx.x; i < valid * chunks; i += kConsumers) {
      const int r = i / chunks, k = i - r * chunks;
      cp_async16(stage + r * ld + k * 8, res + rr.off(r) + n0 + k * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ void ready() const {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    consumers_sync();
  }
  __device__ void store(int r, int c, int n0, int, float v0, float v1, uint32_t bb) const {
    uint32_t* p = reinterpret_cast<uint32_t*>(stage + r * ld + (c - n0));
    const float2 f = unpack_bf16(bb), x = unpack_bf16(*p);
    *p = pack_bf16(x.x + round_bf16(v0 + f.x), x.y + round_bf16(v1 + f.y));
  }
  __device__ void finish(int n0, int np) const {
    consumers_sync();
    const int chunks = np >> 3;
    for (int i = threadIdx.x; i < valid * chunks; i += kConsumers) {
      const int r = i / chunks, k = i - r * chunks;
      *reinterpret_cast<uint4*>(y + yr.off(r) + n0 + k * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ld + k * 8);
    }
    consumers_sync();  // the staging tile is free for the next pass
  }
};

// y = bf16(v) for the tile's valid rows: no bias, no residual, rounded once
// (a tensor-parallel half's pre-bias partial, fused_half_sm90.cu), through a
// row-major staging tile as EpiResidual's.  Tile row r is written at
// y + yr.off(r).
template <class OutRows>
struct EpiPartial {
  bf16* y;
  OutRows yr;
  bf16* stage;
  int ld, valid;
  __device__ uint32_t bias(int) const { return 0u; }
  __device__ void begin(int, int) const {}
  __device__ void ready() const {}
  __device__ void store(int r, int c, int n0, int, float v0, float v1, uint32_t) const {
    *reinterpret_cast<uint32_t*>(stage + r * ld + (c - n0)) = pack_bf16(v0, v1);
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

// out (R x N) = A (R x K, core-matrix tile in shared memory) . W (K x N, the
// next slabs of the ring), handed to `epi` as f32 pairs.  Columns go in
// passes of np; a pass is K/32 slabs.  With R = 128 each warpgroup owns 64
// rows and the pass's np = NW columns; with R = 64 the two warpgroups share
// the rows and take NW = np/2 columns each.  One wgmma m64nNWk16 per 16 of K:
// the widest product the pass allows, so A is read from shared memory once
// per NW columns.
template <int NW, class Epi>
__device__ void gemm(const bf16* A, int K, int N, int R, Ring& ring, const Epi& epi, int kind,
                     int slot) {
  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool split_rows = R == 128;
  const int rb = split_rows ? wg : 0;
  const int np = split_rows ? NW : 2 * NW;
  const int c_off = split_rows ? 0 : wg * NW;  // this warpgroup's columns within the pass
  const uint32_t a_sbo = (uint32_t)(K >> 3) * 128;
  const bf16* a_rows = A + (rb * 8) * (K >> 3) * 64;
  const int row = rb * 64 + wl * 16 + (lane >> 2);
  constexpr int kG = NW / 8;  // 8-column groups of the warpgroup's columns
  for (int n0 = 0; n0 < N; n0 += np) {
    // Accumulator (this thread): column group j, half h -> row 16*wl +
    // lane/4 + 8h of the warpgroup's 64, columns 8j + 2(lane%4) + {0,1}.
    const int col = n0 + c_off + 2 * (lane & 3);
    uint32_t bb[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) bb[j] = epi.bias(col + 8 * j);
    epi.begin(n0, np);
    float acc[NW / 2];
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
    const int nk = K / kSlabK;
    for (int kc = 0; kc < nk; ++kc) {
      const int s = ring.idx % ring.stages;
      CLK(t0);
      mbar_wait(&ring.full[s], (ring.idx / ring.stages) & 1);
      CLK(t1);
      ADD_CYCLES(kind, 0, t1 - t0);
      const bf16* slab = reinterpret_cast<const bf16*>(ring.base + (size_t)s * ring.stage_bytes);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kSlabK / 16; ++ks)
        wgmma<NW>(acc, wg_desc(a_rows + ((kc * kSlabK + ks * 16) >> 3) * 64, 128, a_sbo),
                  wg_desc(slab + ((c_off >> 3) * (kSlabK / 8) + ks * 2) * 64, 128,
                          (kSlabK / 8) * 128));
      wg_commit();
      wg_wait<1>();  // the slab before this one is no longer read
      if (kc > 0) release(ring, ring.idx - 1);
      ++ring.idx;
      CLK(t2);
      ADD_CYCLES(kind, 1, t2 - t1);
    }
    CLK(t3);
    wg_wait<0>();
    release(ring, ring.idx - 1);
    epi.ready();
#pragma unroll
    for (int j = 0; j < kG; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi.store(row + 8 * h, col + 8 * j, n0, np, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                  bb[j]);
    epi.finish(n0, np);
    CLK(t4);
    ADD_CYCLES(kind, 2, t4 - t3);
  }
}

// The matmul at the instruction width of this pass width and tile.
// slot: the phase-timing slot (measurement builds only).
template <class Epi>
__device__ void gemm_np(const bf16* A, int K, int N, int np, int R, Ring& ring, const Epi& epi,
                        int kind, int slot) {
  switch (R == 128 ? np : np / 2) {
    case 32: gemm<32>(A, K, N, R, ring, epi, kind, slot); break;
    case 64: gemm<64>(A, K, N, R, ring, epi, kind, slot); break;
    case 96: gemm<96>(A, K, N, R, ring, epi, kind, slot); break;
    case 128: gemm<128>(A, K, N, R, ring, epi, kind, slot); break;
    default: gemm<192>(A, K, N, R, ring, epi, kind, slot); break;
  }
}

// ---- attention of one head group ---------------------------------------------
//
// q|k|v of the group's 64/D heads sit row-major in `qkv` (q at column
// j*D, k at 64 + j*D, v at 128 + j*D for head j).  Item = (16-query block,
// head), one warp each.  The keys of a query block are the whole sequences
// its rows belong to (at most 2L keys, in 16-key chunks; a chunk's rows past
// the tile read its last row and weigh 0); a key counts for a
// query of the same sequence (and, causal, not after it).  Output to the
// attention-output tile (core-matrix layout, C wide) at head column hc*D.
template <int D, bool SAFE>
__device__ void attention_group(const bf16* qkv, bf16* ao, int group, int valid, int L, int C,
                                int causal, int R) {
  constexpr int HG = 64 / D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float clamp = 60.f * kLog2e;
  for (int item = warp; item < (R / 16) * HG; item += kConsumers / 32) {
    const int qb = item / HG, j = item - qb * HG;
    const int r0 = qb * 16, hc = group * HG + j;
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float den[2] = {0.f, 0.f};
    if (r0 < valid) {
      const int s_a = r0 / L, s_b = min(r0 + 15, valid - 1) / L;
      const int k0 = s_a * L, nk = (s_b + 1) * L - k0;
      const int nkc = (nk + 15) >> 4;
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], qkv + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kQkvLd + j * D +
                            kk * 16 + 8 * (lane >> 4));
      float s[kMaxKeyChunks][2][4];
#pragma unroll
      for (int kc = 0; kc < kMaxKeyChunks; ++kc) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[kc][nt][e] = 0.f;
        if (kc < nkc) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t b[4];
            ldsm_x4(b, qkv + min(k0 + kc * 16 + (lane & 7) + 8 * (lane >> 4), R - 1) * kQkvLd +
                           64 + j * D + kk * 16 + 8 * ((lane >> 3) & 1));
            mma16816(s[kc][0], qa[kk], b[0], b[1]);
            mma16816(s[kc][1], qa[kk], b[2], b[3]);
          }
        }
      }
      // Which scores count, and (safe) each row's largest.
      // The keys of each of this thread's two query rows: [lo, hi] (its own
      // sequence, up to itself when causal; empty past the valid rows).
      int lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + g + 8 * h;
        lo[h] = (i / L) * L;
        hi[h] = i >= valid ? -1 : causal ? i : lo[h] + L - 1;
      }
      auto admitted = [&](int h, int key) { return key >= lo[h] && key <= hi[h]; };
      float mx[2] = {-1e30f, -1e30f};
      if (SAFE) {
#pragma unroll
        for (int kc = 0; kc < kMaxKeyChunks; ++kc)
          if (kc < nkc)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (admitted(e >> 1, k0 + kc * 16 + nt * 8 + 2 * t + (e & 1)))
                  mx[e >> 1] = fmaxf(mx[e >> 1], s[kc][nt][e]);
      }
      if (SAFE) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
      }
#pragma unroll
      for (int kc = 0; kc < kMaxKeyChunks; ++kc) {
        if (kc < nkc) {
          uint32_t pa[4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float e4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float sv = s[kc][nt][e];
              const float ev =
                  admitted(e >> 1, k0 + kc * 16 + nt * 8 + 2 * t + (e & 1))
                      ? exp2f(SAFE ? sv - mx[e >> 1] : fminf(sv, clamp))
                      : 0.f;
              den[e >> 1] += ev;
              e4[e] = ev;
            }
            pa[2 * nt] = pack_bf16(e4[0], e4[1]);      // row g, keys 8nt + 2t
            pa[2 * nt + 1] = pack_bf16(e4[2], e4[3]);  // row g + 8
          }
          // A fragment order: (g, k 0-7), (g+8, k 0-7), (g, k 8-15), (g+8, k 8-15).
          const uint32_t a[4] = {pa[0], pa[1], pa[2], pa[3]};
#pragma unroll
          for (int dt = 0; dt < D / 16; ++dt) {
            uint32_t b[4];
            ldsm_x4_t(b, qkv + min(k0 + kc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), R - 1) *
                                   kQkvLd + 128 + j * D + dt * 16 + 8 * (lane >> 4));
            mma16816(o[2 * dt], a, b[0], b[1]);
            mma16816(o[2 * dt + 1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
        den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
      }
    }
    const float inv[2] = {1.f / (den[0] + 1e-30f), 1.f / (den[1] + 1e-30f)};
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(ao + blk(r0 + g + 8 * h, hc * D + n * 8 + 2 * t, C)) =
            pack_bf16(o[n][2 * h] * inv[h], o[n][2 * h + 1] * inv[h]);
  }
}

// ---- shared memory plan --------------------------------------------------------

struct Layout {
  size_t a, b, qkv, ring, bars, total;  // byte offsets
};

__host__ __device__ inline Layout layout(int R, int C, int HID, int stages, int max_np) {
  Layout l;
  const size_t xn = (size_t)R * C * 2, qkv = (size_t)R * kQkvLd * 2;
  const size_t h = (size_t)R * HID * 2;
  const size_t a = h > xn + qkv ? h : xn + qkv;  // xn + q|k|v, later the MLP hidden
  l.a = 0;
  l.qkv = xn;
  l.b = a;                                       // attention output, later LN2 output
  l.ring = l.b + (size_t)R * C * 2;
  l.bars = l.ring + (size_t)stages * kSlabK * max_np * 2;
  l.total = l.bars + 2 * kMaxStages * sizeof(uint64_t);
  return l;
}


__device__ __forceinline__ int max_pass(const Shape& S) {
  return max(max(S.np[0], S.np[1]), max(S.np[2], S.np[3]));
}

// ---- the element-type policy ------------------------------------------------------
//
// What the weight stream's slabs are for each activation type: K rows a slab
// and bytes an element (bf16: wgmma's core-matrix slabs; f32: the 3xTF32
// body's mma.sync fragment-order slabs, see the f32 section below).
template <class T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr int slab_k = kSlabK, bytes = 2;
};
template <>
struct Elem<float> {
  static constexpr int slab_k = 16, bytes = 4;
};

// ---- the producer --------------------------------------------------------------
//
// One tile's share of the weight stream: the slabs of matmuls [m0, m1) of
// the block's schedule (0 .. C/64 - 1: each head group's q|k|v; then the
// out-projection, fc1, fc2; by default all of them) from the re-laid
// weights (ops/fused_block.py:sm90_weights), in the consumers' order.  idx
// counts the slabs this CTA has streamed so far, so the ring's phase parity
// carries across tiles and blocks.  With the default range (m0 = 0) the
// skip loop folds away.
template <class T>
__device__ __forceinline__ void slab_run(const Shape& S, int m, uint32_t& bytes, int& n) {
  const int groups = S.C / 64;
  const int kind = m < groups ? 0 : m - groups + 1;
  const int K = kind == 3 ? S.HID : S.C;
  const int N = kind == 0 ? kQkvN : kind == 2 ? S.HID : S.C;
  bytes = (uint32_t)Elem<T>::slab_k * S.np[kind] * Elem<T>::bytes;
  n = (N / S.np[kind]) * (K / Elem<T>::slab_k);
}

template <class T = bf16>
__device__ __forceinline__ void produce_tile(const unsigned char* src, const Shape& S, Ring& ring,
                                             int& idx, int m0 = 0, int m1 = -1) {
  uint32_t bytes;
  int n;
  for (int m = 0; m < m0; ++m) {
    slab_run<T>(S, m, bytes, n);
    src += (size_t)n * bytes;
  }
  if (m1 < 0) m1 = S.C / 64 + 3;
  for (int m = m0; m < m1; ++m) {
    slab_run<T>(S, m, bytes, n);
    for (int i = 0; i < n; ++i, ++idx, src += bytes) {
      const int s = idx % ring.stages;
      if (idx >= ring.stages) mbar_wait(&ring.empty[s], ((idx / ring.stages) - 1) & 1);
      mbar_expect_tx(&ring.full[s], bytes);
      bulk_load(ring.base + (size_t)s * ring.stage_bytes, src, bytes, &ring.full[s]);
    }
  }
}

// ---- the tile body (consumer warpgroups) ----------------------------------------
//
// One tile of whole sequences (`valid` rows) of block B: x read through `in`,
// y written through `out`.  The residual stream after attention (x') goes to
// y and back (an L2 round trip, under `out`): a block never reads the buffer
// it writes, so no other tile reads those rows meanwhile.  Returns with the
// shared tiles free for the next tile.  slot / stamp: phase timing only.
template <int D, bool SAFE, class InRows, class OutRows>
__device__ __forceinline__ void block_tile(const Block& B, const Shape& S, const bf16* x, bf16* y,
                                           const InRows& in, const OutRows& out, int valid,
                                           Ring& ring, bf16* sA, bf16* sB, bf16* sQkv, int slot,
                                           bool stamp) {
  const int C = S.C, HID = S.HID, R = S.R, groups = C / 64;
  STAMP(0);
  layer_norm(x, in, valid, sA, R, C, B.p[LN1S], B.p[LN1B]);
  fence_async_smem();
  consumers_sync();
  STAMP(1);

  for (int gi = 0; gi < groups; ++gi) {
    gemm_np(sA, C, kQkvN, S.np[0], R, ring, EpiQkv{sQkv, B.p[BQKV] + gi * kQkvN}, 0, slot);
    STAMP(2 + 2 * gi);
    consumers_sync();
    attention_group<D, SAFE>(sQkv, sB, gi, valid, B.L, C, B.causal, R);
    consumers_sync();  // the next group's projection overwrites q|k|v
    STAMP(3 + 2 * gi);
  }
  fence_async_smem();
  consumers_sync();
  // x' = x + bf16(attn wo + bo), to y.
  // The out-projection stages its residual in the q|k|v tile (free now), fc2
  // in the LN2 output (free once fc1 has read it).
  gemm_np(sB, C, C, S.np[1], R, ring,
          EpiResidual<InRows, OutRows>{x, in, y, out, B.p[BO], sQkv, S.np[1] + 8, valid}, 1,
          slot);
  consumers_sync();
  STAMP(kStamps - 4);
  layer_norm(y, out, valid, sB, R, C, B.p[LN2S], B.p[LN2B]);
  fence_async_smem();
  consumers_sync();
  STAMP(kStamps - 3);
  gemm_np(sB, C, HID, S.np[2], R, ring, EpiGelu{sA, B.p[B1], HID}, 2, slot);
  fence_async_smem();
  consumers_sync();
  STAMP(kStamps - 2);
  const int ld2 = S.np[3] + 8 <= C ? S.np[3] + 8 : S.np[3];
  gemm_np(sA, HID, C, S.np[3], R, ring,
          EpiResidual<OutRows, OutRows>{y, out, y, out, B.p[B2], sB, ld2, valid}, 3, slot);
#ifdef TANTE_PHASE_TIMING
  consumers_sync();
  STAMP(kStamps - 1);
#endif
}

// ---- the f32 tile body ------------------------------------------------------------
//
// The same block in f32: the Pallas kernel's f32 instantiation (fused_block_apply,
// pallas_block.py:208 / pallas_call :163; fused_block_canon_t, :368 / :401;
// the chain and group body, :989 / :1073; the tp halves, :730), which rounds
// nothing to bf16 (q/k/v, the unnormalised attention weights, the attention
// output, the fc1 output and both residual sums stay f32).  Every matmul
// product runs on the tensor cores as three TF32 products (3xTF32): each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (round to
// nearest, cvt.rna's rounding), and lo.hi + hi.lo + hi.hi is summed in f32
// with mma.sync m16n8k8; lo.lo (below 2^-22 relative) is dropped.  That is as
// close to the exact product as an f32 FMA is (relative L2 ~1.3e-7 over a
// block against the plain version), where one TF32 pass (~8e-5) is not
// (tests/test_torch_f32_tf32x3.py).
//
// Bound: 3 * 2*M*(4C^2 + 2C*hidden) TF32 FLOP at 495 TFLOP/s (chip_smoke.py:
// bound_f32; ~0.12 ms at the flagship's H block).  That rate is wgmma's;
// mma.sync m16n8k8 TF32 issues at about half of it, and three passes with
// no split reach ~100 TFLOP/s of f32 products (tools/mma_rate.py), so this
// body's own ceiling is ~0.19 ms of products at H; what it reaches is set
// by the splits (integer operations beside the tensor cores), the weight
// ring's waits and the FFMA attention.  What the design does about
// the limits of the FFMA body it replaces:
// - The FFMA ceiling (67 TFLOP/s): the products run on the tensor cores.
//   Both operands are split in registers, so the ring carries the f32
//   bytes: weight slabs are 16 x np in B-fragment order (ops/fused_block.py:
//   arrange_weight_f32), a lane's b0, b1 of both k8 steps in one 16-byte
//   load, a warp's 512 bytes contiguous; a warp releases a slab as soon as
//   its B values are split (after the proxy fence), and splits the slab's
//   first k8 step of A before it waits for the slab.  Activation tiles are
//   row-major, K + 4 floats a row: an A fragment's 32 loads (row g, column
//   t) fall on banks 4g + t.  The tensor cores truncate each sum into an
//   accumulator, so a slab's six products go to a fresh fragment, added to
//   the total in f32 (one running total drifted ~3e-6).
// - Dead rows: a pass is np columns, warp w taking the 8-column tiles
//   w + 8j of every 16-row block that holds a valid row.  The count of
//   blocks is a template argument (a runtime test in the loop costs ~36%
//   of its time, tools/mma_rate.py):
//   a tile of 33-48 valid rows (the W block's one 48-row sequence) runs 3,
//   evenly on every warp, others all 4.  It depends on the valid row count
//   alone, so a row's arithmetic is the same in every kernel that runs it.
// - Attention: one thread per (query row, head) of the group, its keys in
//   order (scores with four partial sums), exp2 softmax in both forms,
//   normalised after the AV sum, on the CUDA cores: ~16% of a W tile and
//   ~6% of an H tile after the matmuls moved (tools/kernel_phases.py --f32).
//   GELU uses the accurate tanhf.
// - A tile is R = 64 rows (f32 tiles take twice the bytes): x^ 65 KB, the
//   q|k|v tile of a head group 49 KB (later the MLP hidden), the attention
//   output 65 KB (later the LN2 output), three stages of 16-row slabs,
//   ~215 KB at C = hidden = 256.  C <= 256.  The epilogues take what an
//   accumulator fragment holds (two adjacent columns of a row); the
//   residual is read before the pass's products.
// What stays of the bf16 design: the row maps, the weight ring (one
// producer thread streaming slabs with cp.async.bulk, two consumer
// warpgroups, setmaxnreg), the order of the phases, and so the bit equality
// of the canonical T and chain kernels with the single-block kernel.
constexpr int kRowsF = 64;                     // rows of an f32 tile
constexpr int kSlabKF = Elem<float>::slab_k;   // K rows of an f32 weight slab
constexpr int kQkvLdF = kQkvN + 4;             // row stride (floats) of the f32 q|k|v tile
constexpr int kMaxCF = 256;                    // f32 C: LayerNorm holds two float4 a lane

// Row stride (floats) of an f32 activation tile K wide.
__host__ __device__ inline int ld_f(int K) { return K + 4; }

__host__ __device__ inline Layout layout_f32(int C, int HID, int stages, int max_np) {
  Layout l;
  const size_t xn = (size_t)kRowsF * ld_f(C) * 4, qkv = (size_t)kRowsF * kQkvLdF * 4;
  const size_t h = (size_t)kRowsF * ld_f(HID) * 4;
  l.a = 0;
  l.qkv = xn;
  l.b = h > xn + qkv ? h : xn + qkv;  // xn + q|k|v, later the MLP hidden
  l.ring = l.b + (size_t)kRowsF * ld_f(C) * 4;
  l.bars = l.ring + (size_t)stages * kSlabKF * max_np * 4;
  l.total = l.bars + 2 * kMaxStages * sizeof(uint64_t);
  return l;
}

__device__ __forceinline__ const float* fptr(const Block& B, int k) {
  return reinterpret_cast<const float*>(B.p[k]);
}

// LayerNorm of the tile's 64 rows into a row-major tile (ld_f(C)), f32
// one-pass moments; rows past `valid` read as zeros.  Warp w takes rows
// w + 8g; lane l holds the float4 columns l and l + 32 of a row, all eight
// rows loaded before any is stored.
template <class Rows>
__device__ void layer_norm_f32(const float* src, const Rows& rows, int valid, float* dst, int C,
                               const float* __restrict__ scale, const float* __restrict__ bias) {
  constexpr int kWarps = kConsumers / 32, G = kRowsF / kWarps, NB = kMaxCF / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nq = C / 4, ld = ld_f(C);
  float4 v[G][NB];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r = warp + g * kWarps;
    const float4* row = reinterpret_cast<const float4*>(r < valid ? src + rows.off(r) : src);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int q = lane + 32 * i;
      v[g][i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < nq && r < valid) v[g][i] = __ldcg(row + q);
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
      *reinterpret_cast<float4*>(dst + r * ld + 4 * q) =
          make_float4((a.x - mu) * rs * sc.x + bi.x, (a.y - mu) * rs * sc.y + bi.y,
                      (a.z - mu) * rs * sc.z + bi.z, (a.w - mu) * rs * sc.w + bi.w);
    }
  }
}

// f32 epilogues, fed what an mma accumulator fragment holds: bias(c) is the
// float2 of bias columns c, c+1; res(r, c) what the store adds to row r,
// columns c, c+1 (a residual; read before the pass's products, so the
// loads land while the tensor cores work); store(r, c, v, x) takes
// v = product + bias and x = res(r, c).
struct EpiQkvF {  // row-major q|k|v tile
  float* dst;
  const float* b;
  __device__ float2 bias(int c) const { return __ldg(reinterpret_cast<const float2*>(b + c)); }
  __device__ float2 res(int, int) const { return make_float2(0.f, 0.f); }
  __device__ void store(int r, int c, float2 v, float2) const {
    *reinterpret_cast<float2*>(dst + r * kQkvLdF + c) = v;
  }
};

struct EpiGeluF {  // gelu_tanh into a row-major tile ld floats a row
  float* dst;
  const float* b;
  int ld;
  __device__ static float gelu(float h) {
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  }
  __device__ float2 bias(int c) const { return __ldg(reinterpret_cast<const float2*>(b + c)); }
  __device__ float2 res(int, int) const { return make_float2(0.f, 0.f); }
  __device__ void store(int r, int c, float2 v, float2) const {
    *reinterpret_cast<float2*>(dst + r * ld + c) = make_float2(gelu(v.x), gelu(v.y));
  }
};

// y = res + v for the tile's valid rows: row r read at res + rr.off(r)
// (L2-only: inside a chain another SM wrote it), written at y + yr.off(r).
// Each (row, column pair) is read and written by the same thread.
template <class ResRows, class OutRows>
struct EpiResidualF {
  const float* res_;  // x (out-projection) or y itself (fc2: x' stored there)
  ResRows rr;
  float* y;
  OutRows yr;
  const float* b;
  int valid;
  __device__ float2 bias(int c) const { return __ldg(reinterpret_cast<const float2*>(b + c)); }
  __device__ float2 res(int r, int c) const {
    return r < valid ? __ldcg(reinterpret_cast<const float2*>(res_ + rr.off(r) + c))
                     : make_float2(0.f, 0.f);
  }
  __device__ void store(int r, int c, float2 v, float2 x) const {
    if (r < valid)
      *reinterpret_cast<float2*>(y + yr.off(r) + c) = make_float2(x.x + v.x, x.y + v.y);
  }
};

// y = v for the tile's valid rows, written at y + yr.off(r): no bias, no
// residual (a tensor-parallel half's pre-bias partial in f32,
// fused_half_sm90_f32.cu).  The bias is 0, so the product reaches y as the
// tensor cores summed it; a padded shard's zero rows and columns add exact
// zeros.
template <class OutRows>
struct EpiPartialF {
  float* y;
  OutRows yr;
  int valid;
  __device__ float2 bias(int) const { return make_float2(0.f, 0.f); }
  __device__ float2 res(int, int) const { return make_float2(0.f, 0.f); }
  __device__ void store(int r, int c, float2 v, float2) const {
    if (r < valid) *reinterpret_cast<float2*>(y + yr.off(r) + c) = v;
  }
};

// ---- 3xTF32 on the tensor cores -----------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// an f32 bit pattern whose low 13 bits are 0: cvt.rna.tf32.f32's rounding
// of a finite x, in two integer operations (the conversion instruction runs
// on a slower pipe).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to within 2^-22 |x|, both TF32: hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16 x 8 f32) += a (16 x 8) b (8 x 8), TF32 operands, in mma.sync's
// fragments: lane 4g + t holds a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].  FRESH: d = a b (the accumulator input is 0).
template <bool FRESH = false>
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (FRESH)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The f32 product as three TF32 ones: the small terms lo.hi and hi.lo
// first, then hi.hi.
template <bool FRESH = false>
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* bh, const uint32_t* bl) {
  mma_tf32<FRESH>(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// 16-row blocks a tile's matmuls run: 3 for a tile of 33 to 48 valid rows
// (the W block's one 48-row sequence), else all 4 (a ragged last tile of 32
// rows or fewer also runs rows past `valid`, whose results nothing reads).
__device__ __forceinline__ int row_blocks(int valid) { return valid > 32 && valid <= 48 ? 3 : 4; }

// out (RB*16 rows x N) = A (64 x K, row-major in shared memory, ld_f(K)) . W
// (K x N, the ring's next slabs: per pass of NP = 64*NJ columns, K/16 slabs
// of 16 x NP in B-fragment order), 3xTF32 on the tensor cores; each pair of
// adjacent columns of a row handed to `epi` with its bias added.  Warp w
// takes the 8-column tiles w + 8j (j < NJ) of a pass in the tile's first RB
// 16-row blocks.  The tensor cores truncate each sum into an accumulator
// (round toward zero); summed so into one running total over K = 256, a
// product drifted ~3e-6 relative on an H100.  So each slab's six products
// go to a fresh fragment, added to the total by an f32 add that rounds to
// nearest.  kind, slot: phase timing only (the matmul's cycle counters).
template <int NJ, int RB, class Epi>
__device__ void gemm_f32_rb(const float* A, int K, int N, Ring& ring, const Epi& epi, int kind,
                            int slot) {
  constexpr int NP = 64 * NJ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lda = ld_f(K);
  const float* arow = A + g * lda + t;
  for (int n0 = 0; n0 < N; n0 += NP) {
    float2 bias[NJ], res[RB][NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = n0 + 8 * (warp + 8 * j) + 2 * t;
      bias[j] = epi.bias(c);
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        res[rb][j][0] = epi.res(16 * rb + g, c);
        res[rb][j][1] = epi.res(16 * rb + g + 8, c);
      }
    }
    float acc[RB][NJ][4];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rb][j][e] = 0.f;
    for (int kc = 0; kc < K / kSlabKF; ++kc) {
      // The slab's first k8 step of A, split while its B may still be in
      // flight.
      uint32_t a0h[RB][4], a0l[RB][4];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const float* a = arow + 16 * rb * lda + kc * kSlabKF;
        split_tf32(a[0], a0h[rb][0], a0l[rb][0]);
        split_tf32(a[8 * lda], a0h[rb][1], a0l[rb][1]);
        split_tf32(a[4], a0h[rb][2], a0l[rb][2]);
        split_tf32(a[8 * lda + 4], a0h[rb][3], a0l[rb][3]);
      }
      const int s = ring.idx % ring.stages;
      CLK(t0);
      mbar_wait(&ring.full[s], (ring.idx / ring.stages) & 1);
      CLK(t1);
      ADD_CYCLES(kind, 0, t1 - t0);
      // This warp's B fragments of the slab: tile w + 8j is 32 float4s,
      // lane l's at 4l: rows t, t + 4 (the first k8 step), 8 + t, 12 + t.
      const float4* slab =
          reinterpret_cast<const float4*>(ring.base + (size_t)s * ring.stage_bytes) +
          warp * 32 + lane;
      uint32_t bh[NJ][4], bl[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 b = slab[j * 256];
        split_tf32(b.x, bh[j][0], bl[j][0]);
        split_tf32(b.y, bh[j][1], bl[j][1]);
        split_tf32(b.z, bh[j][2], bl[j][2]);
        split_tf32(b.w, bh[j][3], bl[j][3]);
      }
      // This warp's reads of the slab are done (their values are split in
      // registers).  They are generic-proxy loads, and the producer's next
      // bulk copy into the stage writes through the async proxy: the
      // mbarrier alone does not order the two (without this fence the f32
      // tp halves' persistent grid read a slab already refilled in 9 of 96
      // launch pairs on an H100).
      fence_async_smem();
      release(ring, ring.idx);
      ++ring.idx;
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        float part[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_3xtf32<true>(part[j], a0h[rb], a0l[rb], &bh[j][0], &bl[j][0]);
        const float* a = arow + 16 * rb * lda + kc * kSlabKF + 8;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * lda], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * lda + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_3xtf32(part[j], ah, al, &bh[j][2], &bl[j][2]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rb][j][e] += part[j][e];
      }
      CLK(t2);
      ADD_CYCLES(kind, 1, t2 - t1);
    }
    CLK(t3);
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = 16 * rb + g, c = n0 + 8 * (warp + 8 * j) + 2 * t;
        epi.store(r, c, make_float2(acc[rb][j][0] + bias[j].x, acc[rb][j][1] + bias[j].y),
                  res[rb][j][0]);
        epi.store(r + 8, c, make_float2(acc[rb][j][2] + bias[j].x, acc[rb][j][3] + bias[j].y),
                  res[rb][j][1]);
      }
    }
    CLK(t4);
    ADD_CYCLES(kind, 2, t4 - t3);
  }
}

// gemm_f32_rb over the 16-row blocks that hold the tile's `rows` valid rows
// (row_blocks): a W tile's 48 rows run 3 of 4.  kind (q|k|v, out-projection,
// fc1, fc2) and slot: phase timing only; slot kPhaseSlots records nothing.
template <int NJ, class Epi>
__device__ void gemm_f32(const float* A, int K, int N, int rows, Ring& ring, const Epi& epi,
                         int kind = 0, int slot = kPhaseSlots) {
  if (row_blocks(rows) == 3)
    gemm_f32_rb<NJ, 3>(A, K, N, ring, epi, kind, slot);
  else
    gemm_f32_rb<NJ, 4>(A, K, N, ring, epi, kind, slot);
}

// The out-projection, fc1 and fc2 passes are 64 or 128 wide in f32 (the
// q|k|v pass is 192: gemm_f32<3>); fewer instantiations, a shorter build.
template <class Epi>
__device__ void gemm_f32_np(const float* A, int K, int N, int np, int rows, Ring& ring,
                            const Epi& epi, int kind = 0, int slot = kPhaseSlots) {
  if (np == 64)
    gemm_f32<1>(A, K, N, rows, ring, epi, kind, slot);
  else
    gemm_f32<2>(A, K, N, rows, ring, epi, kind, slot);
}

// Attention of one head group in f32: q|k|v row-major in `qkv` (q at column
// j*D, k at 64 + j*D, v at 128 + j*D for head j of the group); one thread
// per (query row, head), over its admitted keys in order (its own sequence,
// up to itself when causal).  Output to the attention-output tile (ld_f(C))
// at head column hc*D; rows past `valid` get zeros.
template <int D, bool SAFE>
__device__ void attention_group_f32(const float* qkv, float* ao, int group, int valid, int L,
                                    int C, int causal) {
  constexpr int HG = 64 / D;
  const int ld = ld_f(C);
  const float clamp = 60.f * kLog2e;
  for (int item = threadIdx.x; item < kRowsF * HG; item += kConsumers) {
    const int j = item / kRowsF, i = item - j * kRowsF;
    float o[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = 0.f;
    float den = 0.f;
    if (i < valid) {
      const int lo = (i / L) * L, hi = causal ? i : lo + L - 1;
      float q[D];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(qkv + i * kQkvLdF + j * D + d);
        q[d] = t.x, q[d + 1] = t.y, q[d + 2] = t.z, q[d + 3] = t.w;
      }
      const float* kb = qkv + 64 + j * D;
      const float* vb = qkv + 128 + j * D;
      auto score = [&](int key) {
        const float* kr = kb + key * kQkvLdF;
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 t = *reinterpret_cast<const float4*>(kr + d);
          p0 = fmaf(q[d], t.x, p0);
          p1 = fmaf(q[d + 1], t.y, p1);
          p2 = fmaf(q[d + 2], t.z, p2);
          p3 = fmaf(q[d + 3], t.w, p3);
        }
        return (p0 + p1) + (p2 + p3);
      };
      float mx = 0.f;
      if (SAFE) {
        mx = -1e30f;
        for (int key = lo; key <= hi; ++key) mx = fmaxf(mx, score(key));
      }
      for (int key = lo; key <= hi; ++key) {
        const float sv = score(key);
        const float e = exp2f(SAFE ? sv - mx : fminf(sv, clamp));
        den += e;
        const float* vr = vb + key * kQkvLdF;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr + d);
          o[d] = fmaf(e, t.x, o[d]);
          o[d + 1] = fmaf(e, t.y, o[d + 1]);
          o[d + 2] = fmaf(e, t.z, o[d + 2]);
          o[d + 3] = fmaf(e, t.w, o[d + 3]);
        }
      }
    }
    const float inv = 1.f / (den + 1e-30f);
    float* out = ao + i * ld + (group * HG + j) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(out + d) =
          make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

// One f32 tile of whole sequences (`valid` rows) of block B, in the bf16
// body's order: LN1, per head group q|k|v and attention, out-projection +
// residual (x' to y), LN2 (from y), fc1 + GELU, fc2 + residual.  Returns
// with the shared tiles free for the next tile.  slot / stamp: phase timing
// only (the bf16 body's stamps, each after the consumers' barrier).
template <int D, bool SAFE, class InRows, class OutRows>
__device__ __forceinline__ void block_tile_f32(const Block& B, const Shape& S, const float* x,
                                               float* y, const InRows& in, const OutRows& out,
                                               int valid, Ring& ring, float* sA, float* sB,
                                               float* sQkv, int slot = 0, bool stamp = false) {
  const int C = S.C, HID = S.HID, groups = C / 64;
  STAMP(0);
  layer_norm_f32(x, in, valid, sA, C, fptr(B, LN1S), fptr(B, LN1B));
  consumers_sync();
  STAMP(1);
  for (int gi = 0; gi < groups; ++gi) {
    gemm_f32<3>(sA, C, kQkvN, valid, ring, EpiQkvF{sQkv, fptr(B, BQKV) + gi * kQkvN}, 0,
                stamp ? slot : kPhaseSlots);
    consumers_sync();
    STAMP(2 + 2 * gi);
    attention_group_f32<D, SAFE>(sQkv, sB, gi, valid, B.L, C, B.causal);
    consumers_sync();  // the next group's projection overwrites q|k|v
    STAMP(3 + 2 * gi);
  }
  gemm_f32_np(sB, C, C, S.np[1], valid, ring,
              EpiResidualF<InRows, OutRows>{x, in, y, out, fptr(B, BO), valid}, 1,
              stamp ? slot : kPhaseSlots);
  consumers_sync();  // x' stored; the attention output is read no more
  STAMP(kStamps - 4);
  layer_norm_f32(y, out, valid, sB, C, fptr(B, LN2S), fptr(B, LN2B));
  consumers_sync();
  STAMP(kStamps - 3);
  gemm_f32_np(sB, C, HID, S.np[2], valid, ring, EpiGeluF{sA, fptr(B, B1), ld_f(HID)}, 2,
              stamp ? slot : kPhaseSlots);
  consumers_sync();
  STAMP(kStamps - 2);
  gemm_f32_np(sA, HID, C, S.np[3], valid, ring,
              EpiResidualF<OutRows, OutRows>{y, out, y, out, fptr(B, B2), valid}, 3,
              stamp ? slot : kPhaseSlots);
  consumers_sync();  // y stored; the hidden tile is free
  STAMP(kStamps - 1);
}

// ---- the CTA ---------------------------------------------------------------------
//
// What a block kernel's CTA does for activations of type T (bf16 or float;
// the chain kernels, the f32 single-block kernel and the long entry's
// kernels; the bf16 single-block kernel spells it out, see
// fused_block_sm90.cu): lay out the dynamic shared memory, start the slab
// ring, split the threads.  The layout is the tile body's, or Plan's (a type
// with static layout(S) and stage_bytes(S): fused_block_long_sm90.cu's).
// The producer warpgroup hands most of its registers to the consumers and
// its first thread runs produce(ring); the two consumer warpgroups (2 x 128
// x 232 + 128 x 40 <= 65536 registers) run consume(ring, sA, sB, sQkv), the
// layout's regions a, b and qkv.
template <class T, class Plan>
__device__ __forceinline__ int cta_stage_bytes(const Shape& S, int max_np) {
  if constexpr (std::is_void<Plan>::value)
    return Elem<T>::slab_k * max_np * Elem<T>::bytes;
  else
    return Plan::stage_bytes(S);
}

template <class T, class Plan = void, class Produce, class Consume>
__device__ __forceinline__ void block_cta(const Shape& S, Produce&& produce, Consume&& consume) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int max_np = max_pass(S);
  Layout lay;
  if constexpr (!std::is_void<Plan>::value)
    lay = Plan::layout(S);
  else if constexpr (std::is_same<T, float>::value)
    lay = layout_f32(S.C, S.HID, S.stages, max_np);
  else
    lay = layout(S.R, S.C, S.HID, S.stages, max_np);
  T* sA = reinterpret_cast<T*>(smem + lay.a);
  T* sB = reinterpret_cast<T*>(smem + lay.b);
  T* sQkv = reinterpret_cast<T*>(smem + lay.qkv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Ring ring{smem + lay.ring, bars, bars + S.stages, S.stages, cta_stage_bytes<T, Plan>(S, max_np),
            0};

  if (threadIdx.x == 0) {
    for (int s = 0; s < S.stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) produce(ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  consume(ring, sA, sB, sQkv);
}

// ---- host side -----------------------------------------------------------------

bool np_ok(int np, int N) { return np >= 64 && np <= 64 * kUnits && np % 64 == 0 && N % np == 0; }

// Shared memory bytes of the plan (R rows, column passes np[4], `stages`
// slabs in the ring) for these sizes; 0 when they are outside the kernel.
long long plan_smem(int R, int C, int HID, const int* np, int stages) {
  if ((R != 64 && R != 128) || (R == 128 && C > 256) || C % 64 || C > kMaxC || HID % 64 ||
      HID > 2 * C || stages < 2 || stages > kMaxStages || !np_ok(np[0], kQkvN) ||
      !np_ok(np[1], C) || !np_ok(np[2], HID) || !np_ok(np[3], C))
    return 0;
  int mx = 0;
  for (int i = 0; i < 4; ++i) mx = np[i] > mx ? np[i] : mx;
  return (long long)layout(R, C, HID, stages, mx).total;
}

// plan: R, sequences per tile, the four column passes, ring stages.
// Returns the shared memory bytes, 0 when the plan is outside the kernel.
long long make_shape(Shape& S, const int* plan, int C, int HID) {
  S.C = C;
  S.HID = HID;
  S.R = plan[0];
  for (int i = 0; i < 4; ++i) S.np[i] = plan[2 + i];
  S.stages = plan[6];
  return plan_smem(S.R, C, HID, S.np, S.stages);
}

// The f32 body's plan: R = 64, C <= 256, q|k|v passes of 192 columns, the
// others 64 or 128 (ops/fused_block.py:sm90_plan with dtype f32 mirrors
// this).  Shared memory bytes, 0 outside the kernel.
long long make_shape_f32(Shape& S, const int* plan, int C, int HID) {
  make_shape(S, plan, C, HID);
  if (S.R != kRowsF || C % 64 || C > kMaxCF || HID % 64 || HID > 2 * C || S.stages < 2 ||
      S.stages > kMaxStages || S.np[0] != kQkvN || !np_ok(S.np[1], C) ||
      !np_ok(S.np[2], HID) || !np_ok(S.np[3], C) || S.np[1] > 128 || S.np[2] > 128 ||
      S.np[3] > 128)
    return 0;
  int mx = 0;
  for (int i = 0; i < 4; ++i) mx = S.np[i] > mx ? S.np[i] : mx;
  return (long long)layout_f32(C, HID, S.stages, mx).total;
}

// v: per, n2, sb, s1, s2, sa (ops/fused_block.py:chain_plan); null: unused
// (contiguous rows).  elems: the elements of the tensor the map addresses.
bool make_map(RowMap& m, const int* v, int L, int C, long long elems) {
  m = RowMap{1, 1, 0, 0, 0, 0, 1u, 1u, 0, 0, 2, 0u, 0u};
  if (!v) return true;
  m.per = v[0]; m.n2 = v[1]; m.sb = v[2]; m.s1 = v[3]; m.s2 = v[4]; m.sa = v[5];
  if (m.per < 1 || m.n2 < 1 || m.per % m.n2) return false;
  fast_div(m.per, &m.mul_per, &m.shift_per);
  fast_div(m.n2, &m.mul_n2, &m.shift_n2);
  const bool lines = (long long)m.s1 == (long long)m.n2 * m.s2;
  m.lin = lines && (long long)m.sb == (long long)(m.per / m.n2) * m.s1 ? 2 : lines ? 1 : 0;
  if (elems >= (1ll << 32)) m.lin = 0;  // the 32-bit strides below would not reach
  m.sa_c = (uint32_t)((long long)m.sa * C);
  m.d_c = (uint32_t)(((long long)m.s2 - (long long)L * m.sa) * C);
  return true;
}

// w: the 9 device pointers of one block (see tante_fused_block_sm90_fwd).
bool make_block(Block& B, const void* const* w, int L, int causal, int n_seqs, int seqs, int R,
                int C, const int* in_map, const int* out_map) {
  for (int k = 0; k < kNPtr; ++k) B.p[k] = static_cast<const bf16*>(w[k]);
  B.L = L;
  B.causal = causal;
  B.n_seqs = n_seqs;
  B.seqs = seqs;
  if (L < 1 || L > 64 || seqs < 1 || seqs * L > R || n_seqs < 0) return false;
  B.tiles = (n_seqs + seqs - 1) / seqs;
  fast_div(L, &B.mul_l, &B.shift_l);
  const long long elems = (long long)n_seqs * L * C;
  return make_map(B.in, in_map, L, C, elems) && make_map(B.out, out_map, L, C, elems);
}

// The kernel's head dim (16, 32 or 64), else 0.
int head_dim(int C, int heads) {
  const int d = heads > 0 && C % heads == 0 ? C / heads : 0;
  return d == 16 || d == 32 || d == 64 ? d : 0;
}

cudaError_t smem_fits(long long smem, int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  return smem > optin ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// Phase-timing reads (measurement builds; each library has its own counters).
extern "C" {
#ifdef TANTE_PHASE_TIMING
int tante_sm90_phase_slots() { return kPhaseSlots; }
int tante_sm90_phase_stamps() { return kStamps; }
// Copies the phase stamps of the first n slots of the last launch to host
// memory (n x kStamps nanosecond timestamps; unused head-group slots are 0).
int tante_sm90_phase_read(unsigned long long* host, int n) {
  if (n > kPhaseSlots) n = kPhaseSlots;
  return cudaMemcpyFromSymbol(host, g_phase_ns, sizeof(unsigned long long) * kStamps * n);
}
// Copies (and zeroes) the per-matmul cycle counters of the first n slots:
// n x 4 x 3 values (see g_gemm_cycles).
int tante_sm90_gemm_cycles(unsigned long long* host, int n) {
  if (n > kPhaseSlots) n = kPhaseSlots;
  const size_t bytes = sizeof(unsigned long long) * 12 * n;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_gemm_cycles, bytes);
  if (err != cudaSuccess) return err;
  static unsigned long long zeros[kPhaseSlots * 12];
  return cudaMemcpyToSymbol(g_gemm_cycles, zeros, bytes);
}
#endif
}  // extern "C"
