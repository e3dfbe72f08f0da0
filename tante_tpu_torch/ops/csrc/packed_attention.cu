// Head-packed attention core for Hopper (sm_90a), f32 or bf16.
//
// For every sequence s and head h: the L queries of that head's segment
// attend over the L keys of the same segment (key <= query when causal):
//
//   scores = scale * q . k      (f32)
//   w      = softmax(scores)    (max-subtract, f32; then cast to v's dtype)
//   out    = w @ v              (f32 accumulation; cast to q's dtype)
//
// Replaces the Pallas TPU kernel of tante_tpu/ops/pallas_attention.py
// packed_attention_core (_kernel).  That kernel folds the heads of a
// sequence into one dense (P, P) score tile, P = heads * L, and masks the
// cross-head blocks away: on the TPU it fills the 128x128 matrix unit and
// throws away (heads - 1) / heads of the work.  Here only the same-head
// pairs are computed.
//
// Operands come with element strides for five axes (s0, s1, head, position,
// channel), so a caller hands over its projections as views: the packed
// (S, P, D) form of the JAX signature, (B, L, heads, D) projections, a
// strided q / k / v slice of one fused projection, or a column view of an
// axial layout (two sequence axes).  Nothing is packed or transposed on the
// way in or out.  The channel stride is 1 and every row starts on a 16-byte
// boundary, with its bytes readable up to the next one (the wrapper copies
// an operand that is otherwise; ops/fused_attention.py).
//
// Bound: bytes.  Each input element is read once and each output element
// written once: 4 * S * P * D * itemsize bytes, against 4 * S * P * L * D
// flops, L / 4 flops a byte in f32 (4 at the AViT shape, L = 16), below the
// card's ~20 f32 flops per byte of bandwidth outside the tensor cores.  What
// holds the kernel back on the card is shared memory's delivery to the lanes
// (128 bytes a cycle an SM, however few distinct addresses a load has): the
// tiles below need ~2 bytes of it per FFMA in the scores and ~1.5 in AV.
//
// Design.  The work unit is one (sequence, head): L rows of D channels of
// each operand (12 KB in, 4 KB out at the AViT shape in f32).  Each warp is a
// consumer of its own, with a ring of `stages` unit slots in shared memory
// that runs stages - 1 units ahead of the one it computes.  The grid is
// persistent (as many CTAs as are resident, down to one unit a CTA) and unit
// u = cta + grid * (warp + warps * k) goes to warp `warp` of CTA `cta`, its
// k-th unit, so the SMs' shares differ by at most one unit.  The rows are
// staged with cp.async, 16 bytes a thread, in the operands' own dtype (bf16
// stays bf16 and is converted when read); only __syncwarp orders a warp, no
// CTA barrier is taken.  Unit offsets are computed once per unit from the
// strides; a thread's (row, chunk) place in the staging pattern once per
// launch.  The plan (make_plan) gives each warp two units where the units
// allow, so that the ring, not the launch, brings in half the rows.
//
// Per unit, 16 query rows at a time:
// - scores, 16 keys at a time: a lane holds a 4 x 4 tile (queries qg + 4a,
//   keys kg + 4b) over the 16-byte chunks of one parity of D, read from
//   shared memory, and the two parities are added across lanes; f32 FFMA, no
//   TF32 (the f32 contract is 1e-5) and no tensor cores (wgmma takes 64-row
//   tiles; a head has L rows).  Products of bf16 are exact in f32.
// - softmax of the scores times scale * log2(e): max-subtract, exp2, the
//   sum, a division by it, the weights rounded to v's dtype into a per-warp
//   (L, 16) f32 scratch.  For L <= 16 every key of a row is in its four
//   lanes' registers (the sum: four keys a lane in order, then lanes
//   (0 + 1) + (2 + 3)); for L > 16 the scores go through the scratch and a
//   lane pair per row sums each key parity in order, then the two.  Causal
//   pairs are skipped and get the weight 0, as the plain version's -1e30
//   fill does.
// - out = w @ v: a lane holds a 4 x 8 tile (rows rg + 4a, 8 channels of a
//   64-channel block; its four weights of a key are one 16-byte load) over
//   the keys in order, and stores it 16 bytes at a time through the output
//   strides.
// Keys and channels are summed in a fixed order, whichever warp takes a unit,
// so two launches on one input are equal bit for bit.
//
// Envelope: P = heads * L <= 128, D in [8, 128], f32 or bf16 (the wrapper
// checks it); at most 16 warps of 1-4 ring stages in 227 KB of shared
// memory; the largest unit (L = 128, D = 128, f32) runs one warp with one
// stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxWarps = 16;  // consumer warps per CTA, at most
constexpr int kMaxStages = 4;
constexpr int kRowBlock = 16;   // query rows (and keys) per pass
constexpr int kMaxP = 128;
constexpr int kMinD = 8, kMaxD = 128;
constexpr int kSmemLimit = 232448;  // 227 KB: a CTA's dynamic shared memory on sm_90
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

struct Geom {
  int S0, S1, H, L, D;
  long long qs[5], ks[5], vs[5], os[5];  // strides: s0, s1, head, position, channel
};

// Per-CTA shared memory: `warps` slots, each `stages` units of q, k, v rows
// (row_bytes apart: the row rounded up to 16 bytes and padded, see
// make_plan) and an (L, 16) f32 scratch of scores, then weights.
struct Plan {
  int warps, stages, row_bytes, unit_bytes, scratch_bytes, slot_bytes, smem_bytes;
};

inline Plan make_plan(int l, int d, int itemsize, long long units, int sms) {
  Plan p;
  // A row of n 16-byte chunks padded to n + pad == 2 (mod 4) chunks: the
  // score tile's 4 rows x 2 chunk parities then fall into 8 different banks.
  const int n = (d * itemsize + 15) / 16, pad = (2 - n % 4 + 4) % 4;
  p.row_bytes = 16 * (n + (pad ? pad : 4));
  p.unit_bytes = 3 * l * p.row_bytes;
  p.scratch_bytes = 4 * kRowBlock * l;
  // A ring of two (one unit in flight while one computes) where a warp
  // holds two; as many warps as fit, up to 16, but no more than give each
  // at least two units of an SM's share (so that the ring, not the start,
  // brings in half the rows); then the deepest ring (up to 4) those warps
  // leave room for.
  p.stages = 2 * p.unit_bytes + p.scratch_bytes <= kSmemLimit ? 2 : 1;
  const long long per_sm = (units + sms - 1) / sms;
  const long long want = (per_sm + 1) / 2;
  p.warps = kSmemLimit / (p.stages * p.unit_bytes + p.scratch_bytes);
  if (p.warps > kMaxWarps) p.warps = kMaxWarps;
  if (p.warps > want) p.warps = (int)want;
  while (p.stages < kMaxStages &&
         p.warps * ((p.stages + 1) * p.unit_bytes + p.scratch_bytes) <= kSmemLimit)
    ++p.stages;
  p.slot_bytes = p.stages * p.unit_bytes + p.scratch_bytes;
  p.smem_bytes = p.warps * p.slot_bytes;
  return p;
}

// Phase timing (measurement builds only, -DTANTE_PHASE_TIMING; see
// tante_tpu_torch/tools/kernel_phases.py --packed).  Per unit of the last
// launch: its start and end on the global nanosecond timer, the SM cycles
// its warp's lane 0 spent waiting for the unit's staged rows, in the scores,
// the softmax, the AV product, the stores and issuing the copies of a later
// unit into the freed slot, and the warp that took it (cta * warps + warp).
#ifdef TANTE_PHASE_TIMING
constexpr int kStampUnits = 16384;
constexpr int kStampFields = 9;
__device__ unsigned long long g_unit_stamps[kStampUnits][kStampFields];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct Stamps {
  long long last;
  unsigned long long cycles[6];
  __device__ void start() {
    last = clock64();
    for (int i = 0; i < 6; ++i) cycles[i] = 0;
  }
  __device__ void mark(int phase) {
    const long long t = clock64();
    cycles[phase] += (unsigned long long)(t - last);
    last = t;
  }
};
#define PHASE(i)                   \
  do {                             \
    if (lane == 0) stamps.mark(i); \
  } while (0)
#else
struct Stamps {};
#define PHASE(i) \
  do {           \
  } while (0)
#endif
enum { kWait, kScores, kSoftmax, kAv, kStore, kStage };

// ---- staging -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most n of this thread's groups are pending (0 <= n < 4).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// A lane's place in the staging pattern: a warp instruction copies `rows`
// whole rows of `chunks` 16-byte chunks; this lane copies chunk `chunk` of
// row `row` of each (row < rows; lanes past rows * chunks idle).
struct Stager {
  int rows, row, chunk;
};

__device__ __forceinline__ Stager make_stager(int chunks, int lane) {
  Stager st;
  st.rows = 32 / chunks;
  st.row = lane / chunks;
  st.chunk = lane - st.row * chunks;
  return st;
}

// Element offsets of one unit (s0, s1, head) in each operand.
struct UnitBase {
  long long q, k, v, o;
};

__device__ __forceinline__ UnitBase unit_base(const Geom& g, long long u) {
  long long s, s0;
  if (u <= 0xffffffffLL) {  // 32-bit divisions (a 64-bit one is a called routine)
    s = (unsigned)u / (unsigned)g.H;
    s0 = (unsigned)s / (unsigned)g.S1;
  } else {
    s = u / g.H;
    s0 = s / g.S1;
  }
  const long long h = u - s * g.H, s1 = s - s0 * g.S1;
  return {s0 * g.qs[0] + s1 * g.qs[1] + h * g.qs[2], s0 * g.ks[0] + s1 * g.ks[1] + h * g.ks[2],
          s0 * g.vs[0] + s1 * g.vs[1] + h * g.vs[2], s0 * g.os[0] + s1 * g.os[1] + h * g.os[2]};
}

template <typename T>
__device__ __forceinline__ void stage_rows(char* dst, const T* src, long long row_stride, int l,
                                           int row_bytes, const Stager& st) {
  if (st.row >= st.rows) return;
  const char* s = reinterpret_cast<const char*>(src + st.row * row_stride) + 16 * st.chunk;
  char* d = dst + st.row * row_bytes + 16 * st.chunk;
  const long long s_step = (long long)st.rows * row_stride * (long long)sizeof(T);
  const int d_step = st.rows * row_bytes;
  for (int i = st.row; i < l; i += st.rows, s += s_step, d += d_step) cp_async16(d, s);
}

template <typename T>
__device__ __forceinline__ void stage_unit(char* slot, const T* q, const T* k, const T* v,
                                           const Geom& g, long long u, int row_bytes,
                                           const Stager& st) {
  const UnitBase b = unit_base(g, u);
  const int part = g.L * row_bytes;
  stage_rows(slot, q + b.q, g.qs[3], g.L, row_bytes, st);
  stage_rows(slot + part, k + b.k, g.ks[3], g.L, row_bytes, st);
  stage_rows(slot + 2 * part, v + b.v, g.vs[3], g.L, row_bytes, st);
}

// ---- 16-byte chunks in f32 ------------------------------------------------

__device__ __forceinline__ uint4 lds16(const char* p) { return *reinterpret_cast<const uint4*>(p); }

// A 16-byte chunk of T: its E values as f32 (unpack), T's rounding of an f32
// (round), and a store of its first n values, 16 bytes at once when `vec`.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&x)[E]) {
    x[0] = __uint_as_float(v.x), x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z), x[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* dst, const float (&x)[E], int n, bool vec) {
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      for (int e = 0; e < n; ++e) dst[e] = x[e];
    }
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&x)[E]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&x)[E], int n,
                                               bool vec) {
    if (vec) {
      uint4 v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      for (int e = 0; e < n; ++e) dst[e] = __float2bfloat16(x[e]);
    }
  }
};

// ---- one unit ---------------------------------------------------------------

// Scratch index of (key j, row r of the 16-row block): rows r, r + 4, r + 8,
// r + 12 are adjacent, so the AV tile reads its four weights of a key as one
// 16-byte load.
__device__ __forceinline__ int sw_index(int j, int r) {
  return j * kRowBlock + (r & 3) * 4 + (r >> 2);
}

template <typename T>
__device__ __forceinline__ void compute_unit(const char* slot, float* sw, T* out, long long o_row,
                                             int L, int D, int row_bytes, int causal,
                                             float scale2, bool vec_out, int lane,
                                             Stamps& stamps) {
  using Ch = Chunk<T>;
  constexpr int E = Ch::E;
  constexpr int VC = 8 / E;  // chunks of a lane's 8 channels in the AV tile
  const int chunks = (D * (int)sizeof(T) + 15) / 16;
  const char* sq = slot;
  const char* sk = slot + L * row_bytes;
  const char* sv = sk + L * row_bytes;
  // Score tile: queries qg + 4a, keys kg + 4b (a, b < 4) over the chunks of
  // parity dh; the two parities are added across lanes.
  const int kg = lane & 3, qg = (lane >> 2) & 3, dh = lane >> 4;
  const int my_chunks = (chunks - dh + 1) / 2;
  // Softmax through the scratch (L > 16): row rl, keys of parity half.  AV
  // tile: rows rg + 4a, channels of chunks cg + 8e (e < VC) of a 64-channel
  // block.
  const int rl = lane & 15, half = lane >> 4;
  const int cg = lane & 7, rg = lane >> 3;

  for (int r0 = 0; r0 < L; r0 += kRowBlock) {
    // Keys any row of this block admits (the same on every lane).
    const int jend = causal ? min(L, r0 + kRowBlock) : L;

    for (int j0 = 0; j0 < jend; j0 += kRowBlock) {
      const char* qr[4];
      const char* kr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[i] = sq + min(r0 + qg + 4 * i, L - 1) * row_bytes + 16 * dh;
        kr[i] = sk + min(j0 + kg + 4 * i, L - 1) * row_bytes + 16 * dh;
      }
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      auto chunk = [&](int off) {
        uint4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = lds16(qr[i] + off), kv[i] = lds16(kr[i] + off);
        float qx[4][E];
#pragma unroll
        for (int a = 0; a < 4; ++a) Ch::unpack(qv[a], qx[a]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float kx[E];
          Ch::unpack(kv[b], kx);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[a][b] = fmaf(qx[a][e], kx[e], acc[a][b]);
        }
      };
      // Two chunks an iteration: the second's loads go out before the
      // first's products.
      int m = 0;
      for (; m + 1 < my_chunks; m += 2) {
        chunk(32 * m);
        chunk(32 * m + 32);
      }
      if (m < my_chunks) chunk(32 * m);
      // The two parities' sums (the same sum on both lanes); lane dh takes
      // rows a = 2 dh, 2 dh + 1 of its tile on.
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], 16);
      float x[2][4];
#pragma unroll
      for (int a2 = 0; a2 < 2; ++a2) {
        const int r = r0 + qg + 4 * (a2 + 2 * dh);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + kg + 4 * b;
          x[a2][b] = j < L && (!causal || j <= r) ? (dh ? acc[a2 + 2][b] : acc[a2][b]) * scale2
                                                  : -INFINITY;
        }
      }
      if (L <= kRowBlock) {
        // One key block holds every key of a row: the softmax in registers,
        // over the row's four lanes (kg).  exp2 of a skipped pair is 0.
#pragma unroll
        for (int a2 = 0; a2 < 2; ++a2) {
          const int rr = qg + 4 * (a2 + 2 * dh);
          float m = fmaxf(fmaxf(x[a2][0], x[a2][1]), fmaxf(x[a2][2], x[a2][3]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          float e[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) e[b] = exp2f(x[a2][b] - m);
          float sum = ((e[0] + e[1]) + e[2]) + e[3];
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = kg + 4 * b;
            if (j < L) sw[sw_index(j, rr)] = Ch::round(e[b] / sum);
          }
        }
      } else {
#pragma unroll
        for (int a2 = 0; a2 < 2; ++a2) {
          const int rr = qg + 4 * (a2 + 2 * dh);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + kg + 4 * b;
            if (j < L && (!causal || j <= r0 + rr)) sw[sw_index(j, rr)] = x[a2][b];
          }
        }
      }
    }
    __syncwarp();
    PHASE(kScores);

    // L > 16: the softmax of row r over its admitted keys from the scratch,
    // eight keys of the lane's parity at a time in registers: the max; the
    // sum of exp2 of the differences; then each exp2 again (the same bits)
    // over the sum.
    if (L > kRowBlock) {
      const int r = r0 + rl;
      const int n = causal ? min(r + 1, L) : L;
      float m = -INFINITY;
      for (int jb = half; jb < n; jb += 16) {
        float x[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          x[t] = jb + 2 * t < n ? sw[sw_index(jb + 2 * t, rl)] : -INFINITY;
#pragma unroll
        for (int t = 0; t < 8; ++t) m = fmaxf(m, x[t]);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      float sum = 0.f;
      for (int jb = half; jb < n; jb += 16) {
        float x[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) x[t] = jb + 2 * t < n ? sw[sw_index(jb + 2 * t, rl)] : m;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (jb + 2 * t < n) sum += exp2f(x[t] - m);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      for (int jb = half; jb < jend; jb += 16) {
        float x[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) x[t] = jb + 2 * t < n ? sw[sw_index(jb + 2 * t, rl)] : m;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = jb + 2 * t;
          if (j < jend) sw[sw_index(j, rl)] = j < n ? Ch::round(exp2f(x[t] - m) / sum) : 0.f;
        }
      }
    }
    __syncwarp();
    PHASE(kSoftmax);

    // out = w @ v, one 64-channel block at a time, keys in order.
    for (int c0 = 0; c0 < chunks; c0 += 8 * VC) {
      float acc[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
      // A chunk past D is read in its place (clamped) and not stored.
      int voff[VC];
#pragma unroll
      for (int e = 0; e < VC; ++e) voff[e] = 16 * min(c0 + cg + 8 * e, chunks - 1);
      const float* wr = sw + rg * 4;
      auto key = [&](int j) {
        const float4 w = *reinterpret_cast<const float4*>(wr + j * kRowBlock);
        const float wa[4] = {w.x, w.y, w.z, w.w};
        const char* vr = sv + j * row_bytes;
#pragma unroll
        for (int e = 0; e < VC; ++e) {
          float vx[E];
          Ch::unpack(lds16(vr + voff[e]), vx);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int x = 0; x < E; ++x) acc[a][e * E + x] = fmaf(wa[a], vx[x], acc[a][e * E + x]);
        }
      };
      // Two keys an iteration, as the scores' chunks.
      int j = 0;
      for (; j + 1 < jend; j += 2) {
        key(j);
        key(j + 1);
      }
      if (j < jend) key(j);
      PHASE(kAv);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = r0 + rg + 4 * a;
        if (r < L) {
#pragma unroll
          for (int e = 0; e < VC; ++e) {
            const int c = c0 + cg + 8 * e;
            if (c < chunks) {
              float y[E];
#pragma unroll
              for (int x = 0; x < E; ++x) y[x] = acc[a][e * E + x];
              Ch::store(out + r * o_row + c * E, y, min(E, D - c * E), vec_out);
            }
          }
        }
      }
      PHASE(kStore);
    }
    __syncwarp();  // the scratch is rewritten by the next row block
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
packed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, const Geom g,
                        const Plan plan, const int causal, const float scale2,
                        const int vec_out) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* slots = smem + (size_t)warp * plan.slot_bytes;
  float* sw = reinterpret_cast<float*>(slots + plan.stages * plan.unit_bytes);
  const long long units = (long long)g.S0 * g.S1 * g.H;
  const long long step = (long long)gridDim.x * plan.warps;
  const long long first = blockIdx.x + (long long)gridDim.x * warp;
  const Stager st = make_stager((g.D * (int)sizeof(T) + 15) / 16, lane);
  Stamps stamps;

  // The ring runs stages - 1 units ahead: unit k + stages - 1 is issued into
  // the slot unit k - 1 freed, then unit k is waited for.
  for (int i = 0; i + 1 < plan.stages; ++i) {
    const long long u = first + i * step;
    if (u < units) stage_unit(slots + i * plan.unit_bytes, q, k, v, g, u, plan.row_bytes, st);
    cp_async_commit();
  }
  int slot = 0;
  for (long long u = first; u < units; u += step) {
#ifdef TANTE_PHASE_TIMING
    const unsigned long long t_start = globaltimer();
    if (lane == 0) stamps.start();
#endif
    const int ahead = slot == 0 ? plan.stages - 1 : slot - 1;
    const long long next = u + (plan.stages - 1) * step;
    if (next < units)
      stage_unit(slots + ahead * plan.unit_bytes, q, k, v, g, next, plan.row_bytes, st);
    cp_async_commit();
    PHASE(kStage);
    cp_async_wait_upto(plan.stages - 1);  // this unit's group has landed
    __syncwarp();
    PHASE(kWait);
    compute_unit<T>(slots + slot * plan.unit_bytes, sw, out + unit_base(g, u).o, g.os[3], g.L,
                    g.D, plan.row_bytes, causal, scale2, vec_out != 0, lane, stamps);
    __syncwarp();  // every lane is done with the slot before it is refilled
    slot = slot + 1 == plan.stages ? 0 : slot + 1;
#ifdef TANTE_PHASE_TIMING
    if (lane == 0 && u < kStampUnits) {
      unsigned long long* rec = g_unit_stamps[u];
      rec[0] = t_start;
      rec[1] = globaltimer();
      for (int i = 0; i < 6; ++i) rec[2 + i] = stamps.cycles[i];
      rec[8] = (unsigned long long)blockIdx.x * plan.warps + warp;
    }
#endif
  }
  cp_async_wait<0>();
}

// ---- host side ------------------------------------------------------------

// Fills g from the 25-value geometry; checks the envelope.
int parse(const long long* geom, Geom* g) {
  int* sizes[5] = {&g->S0, &g->S1, &g->H, &g->L, &g->D};
  for (int i = 0; i < 5; ++i) {
    if (geom[i] <= 0 || geom[i] > 0x7fffffffLL) return cudaErrorInvalidValue;
    *sizes[i] = (int)geom[i];
  }
  if (geom[0] * geom[1] > 0x7fffffffLL || g->H * g->L > kMaxP || g->D < kMinD || g->D > kMaxD)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) {
    g->qs[i] = geom[5 + i];
    g->ks[i] = geom[10 + i];
    g->vs[i] = geom[15 + i];
    g->os[i] = geom[20 + i];
  }
  return cudaSuccess;
}

// Every row of the operand starts on a 16-byte boundary (the strides of the
// axes longer than 1, in bytes, and the base) and its channels are adjacent.
bool rows_aligned(const void* p, const long long* strides, const Geom& g, int itemsize) {
  const int sizes[4] = {g.S0, g.S1, g.H, g.L};
  if (strides[4] != 1 || reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 4; ++i)
    if (sizes[i] > 1 && (strides[i] * itemsize) % 16) return false;
  return true;
}

template <typename T>
struct Launcher {
  // The shared-memory attribute, once per device; resident CTAs per SM by
  // (device, warps, shared memory), asked once each.
  std::mutex mu;
  bool attribute_set[kMaxDevices] = {};
  int sms[kMaxDevices] = {};
  struct Entry {
    int device, warps, smem, ctas;
  };
  Entry cache[64];
  int cached = 0;

  cudaError_t sms_of(int device, int* n_sms) {
    std::lock_guard<std::mutex> lock(mu);
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!attribute_set[device]) {
      cudaError_t err = cudaFuncSetAttribute(packed_attention_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kSmemLimit);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
      attribute_set[device] = true;
    }
    *n_sms = sms[device];
    return cudaSuccess;
  }

  cudaError_t ctas_per_sm(int device, const Plan& p, int* ctas) {
    std::lock_guard<std::mutex> lock(mu);
    cudaError_t err;
    for (int i = 0; i < (cached < 64 ? cached : 64); ++i) {
      const Entry& e = cache[i];
      if (e.device == device && e.warps == p.warps && e.smem == p.smem_bytes) {
        *ctas = e.ctas;
        return cudaSuccess;
      }
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, packed_attention_kernel<T>,
                                                        32 * p.warps, p.smem_bytes);
    if (err != cudaSuccess) return err;
    if (*ctas < 1) return cudaErrorInvalidConfiguration;
    cache[cached % 64] = {device, p.warps, p.smem_bytes, *ctas};
    ++cached;
    return cudaSuccess;
  }
};

template <typename T>
Launcher<T>& launcher() {
  static Launcher<T> l;
  return l;
}

// The launch's plan and grid: out = warps, stages, row bytes, unit bytes,
// scratch bytes, shared memory bytes, CTAs, resident CTAs per SM.
template <typename T>
int plan_for(const Geom& g, int device, Plan* p, long long* grid, int* ctas) {
  const long long units = (long long)g.S0 * g.S1 * g.H;
  int sms = 0;
  cudaError_t err = launcher<T>().sms_of(device, &sms);
  if (err != cudaSuccess) return err;
  *p = make_plan(g.L, g.D, sizeof(T), units, sms);
  err = launcher<T>().ctas_per_sm(device, *p, ctas);
  if (err != cudaSuccess) return err;
  // Every SM takes a share, down to one unit a CTA.
  const long long resident = (long long)*ctas * sms;
  *grid = units < resident ? units : resident;
  return cudaSuccess;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const Geom& g, int causal,
           float scale, int device, cudaStream_t st) {
  const int isz = sizeof(T);
  if (!rows_aligned(q, g.qs, g, isz) || !rows_aligned(k, g.ks, g, isz) ||
      !rows_aligned(v, g.vs, g, isz) || g.os[4] != 1)
    return cudaErrorMisalignedAddress;
  const bool vec_out = (g.D * isz) % 16 == 0 && rows_aligned(out, g.os, g, isz);
  Plan p;
  long long grid;
  int ctas;
  int err = plan_for<T>(g, device, &p, &grid, &ctas);
  if (err != cudaSuccess) return err;
  packed_attention_kernel<T><<<(unsigned)grid, 32 * p.warps, p.smem_bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), g, p, causal, scale * kLog2e, vec_out);
  return cudaGetLastError();
}

int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

extern "C" {

// q, k, v, out: (S0, S1, H, L, D) of one dtype (bf16 = 1: bf16, else f32),
// addressed through the element strides in `geom`, a host array of 25
// values: S0, S1, H, L, D, then 5 strides each for q, k, v and out (see
// Geom).  q, k and v have channel stride 1 and 16-byte aligned rows; out has
// channel stride 1.  q is scaled by `scale` inside (1 for pre-scaled q).
// Returns a cudaError_t (0 = launched).
int tante_packed_attention(const void* q, const void* k, const void* v, void* out,
                           const long long* geom, int causal, float scale, int bf16, int device,
                           void* stream) {
  int err = use_device(device);
  if (err != cudaSuccess) return err;
  Geom g;
  err = parse(geom, &g);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, g, causal, scale, device, st)
              : launch<float>(q, k, v, out, g, causal, scale, device, st);
}

// The plan a launch on this geometry takes (ops/fused_attention.py:packed_plan
// mirrors its first six values): out[8] = warps, stages, row bytes, unit
// bytes, scratch bytes, shared memory bytes, CTAs, resident CTAs per SM.
int tante_packed_attention_plan(const long long* geom, int bf16, int device, long long* out) {
  int err = use_device(device);
  if (err != cudaSuccess) return err;
  Geom g;
  err = parse(geom, &g);
  if (err != cudaSuccess) return err;
  Plan p;
  long long grid;
  int ctas;
  err = bf16 ? plan_for<__nv_bfloat16>(g, device, &p, &grid, &ctas)
             : plan_for<float>(g, device, &p, &grid, &ctas);
  if (err != cudaSuccess) return err;
  const long long vals[8] = {p.warps,       p.stages,     p.row_bytes, p.unit_bytes,
                             p.scratch_bytes, p.smem_bytes, grid,        ctas};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return cudaSuccess;
}

#ifdef TANTE_PHASE_TIMING
int tante_packed_stamp_units() { return kStampUnits; }
int tante_packed_stamp_fields() { return kStampFields; }
// Copies the stamps of the first n units of the last launch to host memory
// (n x kStampFields values; see g_unit_stamps).
int tante_packed_phase_read(unsigned long long* host, int n) {
  if (n > kStampUnits) n = kStampUnits;
  return cudaMemcpyFromSymbol(host, g_unit_stamps,
                              sizeof(unsigned long long) * kStampFields * n);
}
#endif

}  // extern "C"
