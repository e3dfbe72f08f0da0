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
//     the single-block kernel's LayerNorm arithmetic and products (wgmma,
//     bf16; 3xTF32 mma.sync, f32), q prescaled by d^-0.5*log2(e) (folded
//     into wq/bq by the wrapper), + bias, rounded to the activation type,
//     into a workspace laid out head group by head group,
//     (3, S, C/64, L, 64): the 64 keys of a block of one head group are one
//     contiguous run of 64 x 64 values.  long_sm90.cuh's qkv body: a
//     persistent grid, each tile's x bulk-copied ahead, the weights resident
//     where they fit (the C block in bf16), bulk stores from staging
//     buffers.
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
// AV on wgmma, f32 products on wgmma's TF32.
//
// The tensor-parallel attention half at L > 64 (fused_half_long_sm90.cu)
// runs this design too: the qkv body and everything of the attention entry
// but its layout, weight stream and tail (layout_attn, produce_tail, the
// kernels below) are in long_sm90.cuh, where the attention width is a
// template switch (HALF = false here: W = C, the code this entry had).

#include "long_sm90.cuh"

namespace {



// The widest column pass of the attention entry's matmuls (out-projection,
// fc1, fc2).
__host__ __device__ inline int tail_pass(const int* np) {
  const int m = np[1] > np[2] ? np[1] : np[2];
  return m > np[3] ? m : np[3];
}



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

__global__ void __launch_bounds__(kThreads, 1)
    block_long_qkv_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ QkvPlan P) {
  qkv_cta<false, false>(A, P);
}

__global__ void __launch_bounds__(kThreads, 1)
    block_long_qkv_f32_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ QkvPlan P) {
  qkv_cta<true, false>(A, P);
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


// The attention entry's layout and weight stream (attn_cta's Tail): per
// item the out-projection's, fc1's and fc2's slabs (matmuls C/64 .. C/64 + 2
// of the block's schedule), through a ring as wide as the widest pass.
struct BlockTail {
  __device__ static AttnLayout layout(bool f32, const Shape& S, const AttnPlan& AP) {
    return layout_attn(f32, S.C, S.HID, S.np, S.stages, AP);
  }
  __device__ static int stage_bytes(bool f32, const Shape& S) {
    return (f32 ? kSlabKF * 4 : kSlabK * 2) * tail_pass(S.np);
  }
  template <class T>
  __device__ static void weights(const LongArgs& A, const AttnPlan& AP, Ring& ring, int items) {
    int idx = 0;
    const int groups = A.sh.C / 64;
    for (int i = blockIdx.x; i < items; i += gridDim.x)
      if (item_at(A, AP, i).valid > 0)
        produce_tile<T>(static_cast<const unsigned char*>(A.p[WARR]), A.sh, ring, idx, groups,
                        groups + 3);
  }
};

template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
    block_long_attn_kernel(const __grid_constant__ LongArgs A, const __grid_constant__ AttnPlan AP) {
  attn_cta<bf16, SAFE ? 2 : 1, false, BlockTail>(A, AP, [&](const Item& it, Ring& ring, Pipe& P,
                                                            bf16* ao, bf16* h, bf16* xs) {
    const Shape& S = A.sh;
    const int C = S.C, HID = S.HID, R = it.rows;
    for (int gi = 0; gi < C / 64; ++gi)
      attention_wg<D, SAFE, false>(A, it, gi, P, ao, reinterpret_cast<float*>(h));
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
  attn_cta<float, SAFE ? 2 : 1, false, BlockTail>(A, AP, [&](const Item& it, Ring& ring, Pipe& P,
                                                              float* ao, float* h, float* xs) {
    const Shape& S = A.sh;
    const int C = S.C, HID = S.HID;
    for (int gi = 0; gi < C / 64; ++gi) attention_f32<D, SAFE, false>(A, it, gi, P, ao);
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

// plan: the qkv entry's tile rows, its ring stages (0: the weights
// resident), the four column passes (q|k|v, out-projection, fc1, fc2), the
// attention entry's weight ring stages, its item rows, k|v stages, q slots,
// overlap and keep, the qkv entry's staging buffers and split (f32: LN1's
// output in TF32 hi / lo tiles) (ops/fused_block.py:long_plan).  Fills S
// (and AP) for the entry (`attn`) and returns its shared memory bytes, 0
// when the plan is outside the kernels.

long long long_shape(Shape& S, AttnPlan& AP, const int* plan, int C, int HID, bool f32,
                     bool attn) {
  S.C = C;
  S.HID = HID;
  for (int i = 0; i < 4; ++i) S.np[i] = plan[2 + i];
  S.R = attn ? plan[7] : plan[0];
  S.stages = attn ? plan[6] : plan[1];
  AP = AttnPlan{plan[7], plan[8], plan[9], plan[10], plan[11]};
  const int maxc = f32 ? kMaxCF : kMaxC;
  if (C % 64 || C < 64 || C > maxc || HID % 64 || HID < 64 || HID > 2 * C ||
      S.np[0] != kQkvN || !np_ok(S.np[1], C) || !np_ok(S.np[2], HID) || !np_ok(S.np[3], C))
    return 0;
  if (f32 && (S.np[1] > 128 || S.np[2] > 128 || S.np[3] > 128)) return 0;
  if (attn) {
    const int R = f32 ? kRowsF : (C <= 256 ? 128 : 64);  // a 128-row LayerNorm holds C <= 256
    if (S.stages < 2 || S.stages > kMaxStages || AP.R != R || AP.kv < 2 || AP.kv > kMaxKv ||
        AP.qs < 1 || AP.qs > kMaxQ ||
        (AP.overlap != 0 && AP.overlap != 1) || (AP.keep != 0 && AP.keep != 1) ||
        (AP.keep && (AP.overlap || (!f32 && S.np[1] != C))))
      return 0;
    return (long long)layout_attn(f32, C, HID, S.np, S.stages, AP).total;
  }
  return qkv_smem(S, C, plan[12], plan[13], f32);
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
  const QkvPlan P{plan[12], (A.tokens + A.sh.R - 1) / A.sh.R, plan[13]};
  const int grid = attn_grid(P.tiles, device);  // one CTA per SM
  if (F32) return launch_qkv_kernel(block_long_qkv_f32_kernel, A, P, grid, smem, stream);
  return launch_qkv_kernel(block_long_qkv_kernel, A, P, grid, smem, stream);
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
// re-laid weights: ops/fused_block.py:sm90_weights).  plan: 14 ints
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
int tante_block_long_qkv_phase_count() { return kQkvPhases; }
// Copies (and zeroes) the qkv entry's phase cycles of the first n CTAs (n x
// kQkvPhases values, see g_qkv_cycles).
int tante_block_long_qkv_phase_read(unsigned long long* host, int n) {
  if (n > kPhaseSlots) n = kPhaseSlots;
  const size_t bytes = sizeof(unsigned long long) * kQkvPhases * n;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_qkv_cycles, bytes);
  if (err != cudaSuccess) return err;
  static unsigned long long zeros[kPhaseSlots * kQkvPhases];
  return cudaMemcpyToSymbol(g_qkv_cycles, zeros, bytes);
}
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
