// Per-mode complex channel mixing for Hopper (sm_90a), f32.
//
//   out[b, m, :] = x[b, m, :] @ w[m, :, :]      (complex, per retained mode m)
//
// on separate re / im f32 arrays:
//
//   out_re = xr.wr - xi.wi        out_im = xr.wi + xi.wr
//
// all four products and the combine in one pass.  Replaces the Pallas TPU
// kernel of tante_tpu/ops/pallas_spectral.py spectral_mode_matmul (_kernel).
// That kernel pads channels to 128 lanes and modes to a tile of 8, wants x
// mode-major and the weight as (M, Cin, Cout); here nothing is padded,
// transposed or copied: every operand comes with its element strides, and
// the mode index may have up to three dimensions, so the callers hand over
//   - x as it leaves the partial DFT (B, K, L, C) or, in the channel-major
//     layout, (B, K, C, L), or as the re / im views of a complex FFT slice,
//   - the weight as it is stored, (Cin, Cout, *modes, 2), seen through a
//     permuted view of its re or im half (modes are then its fastest axis,
//     re and im interleaved).
//
// Bound: bytes.  8*B*M*Cin*Cout flops against 4*(2*B*M*(Cin+Cout) +
// 2*M*Cin*Cout) bytes: ~1.6 us at the main path's shapes, each weight
// element meeting only B inputs.  The shapes are small (the FNO layer is 220
// modes x 48 x 48), so what costs is latency: how many dependent steps a
// thread runs and how few warps there are to hide them.  This design (the
// second; the first staged a fixed 16-mode x 8-channel x 8-batch tile through
// shared memory with four CTA barriers per chunk of input channels):
//
// - A thread owns a pair of adjacent modes x 4 output channels x BT batch
//   entries, in registers.  With the weight as stored, one 16-byte load
//   brings (re, im) of both modes for one (cin, cout): the lanes of a warp
//   run along mode pairs (and LO = 2 lanes along output channels), so a warp
//   reads whole 256-byte runs of the weight, each element once.
// - The tile follows the geometry (the wrapper picks the template): LO = 1
//   when Cout <= 4 (all 32 lanes on modes), 2 otherwise; BT = 4 batch entries
//   per thread (2 for short batches or deep splits); and input channels are
//   split over KS warps of a CTA when there are too few warps to hide the
//   latency (KS up to 8 at Cin >= 32: the FNO shape runs 672 warps instead of
//   42), their partial sums reduced once through shared memory.
// - x is read straight from device memory (L1-cached; 8-byte loads of two
//   channels where x is channel-fastest): no staging, no barrier.  A thread
//   issues all of a chunk's loads before its FMAs, and the next chunk's are in
//   flight while they run.
// - Without a channel split the result leaves straight from registers, in
//   16-byte stores of 4 output channels where the output is channel-fastest.
// Sums run over Cin in order within each split, f32 FMA; the splits are
// added in order: against the plain version (four separately summed
// products) only the rounding order differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOT = 4;  // output channels per thread

struct Geom {
  int B, M0, M1, M2, Cin, Cout;
  long long xs[5];  // x strides in elements: batch, mode0, mode1, mode2, channel
  long long ws[5];  // w strides: mode0, mode1, mode2, cin, cout
  long long os[5];  // out strides: batch, mode0, mode1, mode2, channel
  int mode_tiles;   // CTAs along modes (grid.x = mode_tiles x cout tiles)
  int x_vec;        // x channel-fastest and 8-byte aligned: 2-channel loads
  int o_vec;        // out channel-fastest and 16-byte aligned: 4-channel stores
};

// Element offset of flat mode m = (m0, m1, m2) under strides (s0, s1, s2).
__device__ __forceinline__ long long mode_offset(int m, int M1, int M2, long long s0,
                                                 long long s1, long long s2) {
  return (m / (M2 * M1)) * s0 + ((m / M2) % M1) * s1 + (m % M2) * s2;
}

// One chunk's operands in registers: x of two channels for the thread's two
// modes and BT batch entries (re, im), the weights of the two channels for
// its 4 output channels and two modes (re, im).
template <int BT>
struct Chunk {
  float x[2][BT][2][2];  // [mode][batch][re, im][channel c, c + 1]
  float wr[2][kOT][2], wi[2][kOT][2];  // [channel][cout][mode]
};

// Issue every load of chunk q (channels 2q, 2q + 1); what lies outside the
// operands reads as zero.
template <int BT, bool kWVec>
__device__ __forceinline__ void load_chunk(Chunk<BT>& k, int q, const Geom& g,
                                           const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           const float* __restrict__ wr,
                                           const float* __restrict__ wi, const long long* xo,
                                           const long long* wo, const bool* mv, const bool* ov,
                                           const bool* bv, int b0, int o0) {
  const int c = 2 * q;
  const bool c1 = c + 1 < g.Cin;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const bool live = mv[t] && bv[b];
      const long long off = (long long)(b0 + b) * g.xs[0] + xo[t] + c * g.xs[4];
      if (g.x_vec) {
        const float2 zero = make_float2(0.f, 0.f);
        const float2 r = live ? __ldg(reinterpret_cast<const float2*>(xr + off)) : zero;
        const float2 i = live ? __ldg(reinterpret_cast<const float2*>(xi + off)) : zero;
        k.x[t][b][0][0] = r.x; k.x[t][b][0][1] = r.y;
        k.x[t][b][1][0] = i.x; k.x[t][b][1][1] = i.y;
      } else {
        k.x[t][b][0][0] = live ? __ldg(xr + off) : 0.f;
        k.x[t][b][1][0] = live ? __ldg(xi + off) : 0.f;
        k.x[t][b][0][1] = live && c1 ? __ldg(xr + off + g.xs[4]) : 0.f;
        k.x[t][b][1][1] = live && c1 ? __ldg(xi + off + g.xs[4]) : 0.f;
      }
    }
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
      const bool live = ov[j] && (cc == 0 || c1);
      const long long base = (long long)(c + cc) * g.ws[3] + (long long)(o0 + j) * g.ws[4];
      if (kWVec) {
        const float4 v = live && mv[0] ? __ldg(reinterpret_cast<const float4*>(wr + base + wo[0]))
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        k.wr[cc][j][0] = v.x; k.wi[cc][j][0] = v.y; k.wr[cc][j][1] = v.z; k.wi[cc][j][1] = v.w;
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          k.wr[cc][j][t] = live && mv[t] ? __ldg(wr + base + wo[t]) : 0.f;
          k.wi[cc][j][t] = live && mv[t] ? __ldg(wi + base + wo[t]) : 0.f;
        }
      }
    }
}

// LO: lanes along output channels; BT: batch entries per thread; KS: warps
// splitting the input channels; kWVec: the weight's modes are flat with
// stride 2 and im follows re (the stored layout), so one float4 holds both
// modes of a pair.
template <int LO, int BT, int KS, bool kWVec>
__global__ void __launch_bounds__(32 * KS)
spectral_mode_matmul_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                            const float* __restrict__ wr, const float* __restrict__ wi,
                            float* __restrict__ outr, float* __restrict__ outi, const Geom g) {
  constexpr int kPairs = 32 / LO;            // mode pairs of a CTA
  constexpr int kAcc = 2 * kOT * BT * 2;     // (mode, cout, batch, re/im)
  __shared__ float red[KS > 1 ? KS : 1][KS > 1 ? kAcc : 1][32];

  const int lane = threadIdx.x & 31, ks = threadIdx.x >> 5;
  const int M = g.M0 * g.M1 * g.M2;
  const int mt = blockIdx.x % g.mode_tiles, ot = blockIdx.x / g.mode_tiles;
  const int m0 = (mt * kPairs + lane / LO) * 2;
  const int o0 = (ot * LO + lane % LO) * kOT;
  const int b0 = blockIdx.y * BT;
  const int mm[2] = {m0, m0 + 1};
  bool mv[2];
  long long xo[2], wo[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    mv[t] = mm[t] < M;
    xo[t] = mv[t] ? mode_offset(mm[t], g.M1, g.M2, g.xs[1], g.xs[2], g.xs[3]) : 0;
    wo[t] = mv[t] ? mode_offset(mm[t], g.M1, g.M2, g.ws[0], g.ws[1], g.ws[2]) : 0;
  }
  bool ov[kOT], bv[BT];
#pragma unroll
  for (int j = 0; j < kOT; ++j) ov[j] = o0 + j < g.Cout;
#pragma unroll
  for (int b = 0; b < BT; ++b) bv[b] = b0 + b < g.B;

  float acc[2][kOT][BT][2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < kOT; ++j)
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[t][j][b][0] = acc[t][j][b][1] = 0.f;

  // Input channels two at a time, chunk q to warp q % KS.  Every load of a
  // chunk is issued before any of its FMAs, and the next chunk's loads are in
  // flight while this one is summed: a load left next to its first use
  // would wait out a whole trip to memory per weight vector.
  const int chunks = (g.Cin + 1) / 2;
  Chunk<BT> cur, nxt;
  load_chunk<BT, kWVec>(cur, ks, g, xr, xi, wr, wi, xo, wo, mv, ov, bv, b0, o0);
  for (int q = ks; q < chunks; q += KS) {
    if (q + KS < chunks)
      load_chunk<BT, kWVec>(nxt, q + KS, g, xr, xi, wr, wi, xo, wo, mv, ov, bv, b0, o0);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int j = 0; j < kOT; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            // A missing channel, mode or output channel loaded zeros: its
            // FMAs add exact zeros (and its sums are never stored).
            const float p = cur.x[t][b][0][cc], s = cur.x[t][b][1][cc];
            const float a = cur.wr[cc][j][t], d = cur.wi[cc][j][t];
            float& ar = acc[t][j][b][0];
            float& ai = acc[t][j][b][1];
            ar = fmaf(p, a, ar);
            ar = fmaf(-s, d, ar);
            ai = fmaf(p, d, ai);
            ai = fmaf(s, a, ai);
          }
    cur = nxt;
  }

  if (KS == 1) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (!mv[t]) continue;
      const long long oo = mode_offset(mm[t], g.M1, g.M2, g.os[1], g.os[2], g.os[3]);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (!bv[b]) continue;
        const long long off = (long long)(b0 + b) * g.os[0] + oo + o0 * g.os[4];
        if (g.o_vec && ov[kOT - 1]) {
          *reinterpret_cast<float4*>(outr + off) =
              make_float4(acc[t][0][b][0], acc[t][1][b][0], acc[t][2][b][0], acc[t][3][b][0]);
          *reinterpret_cast<float4*>(outi + off) =
              make_float4(acc[t][0][b][1], acc[t][1][b][1], acc[t][2][b][1], acc[t][3][b][1]);
        } else {
#pragma unroll
          for (int j = 0; j < kOT; ++j)
            if (ov[j]) {
              outr[off + j * g.os[4]] = acc[t][j][b][0];
              outi[off + j * g.os[4]] = acc[t][j][b][1];
            }
        }
      }
    }
    return;
  }

  // Channel split: every warp's partial sums to shared memory, then warp k
  // adds accumulator slots k, k + KS, ... over the warps in order and stores.
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < kOT; ++j)
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          red[ks][((t * kOT + j) * BT + b) * 2 + r][lane] = acc[t][j][b][r];
  __syncthreads();
  for (int a = ks; a < kAcc; a += KS) {
    const int r = a & 1, b = (a >> 1) % BT, j = (a / (2 * BT)) % kOT, t = a / (2 * BT * kOT);
    if (!mv[t] || !bv[b] || !ov[j]) continue;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) v += red[k][a][lane];
    const long long off = (long long)(b0 + b) * g.os[0] +
                          mode_offset(mm[t], g.M1, g.M2, g.os[1], g.os[2], g.os[3]) +
                          (long long)(o0 + j) * g.os[4];
    (r ? outi : outr)[off] = v;
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*, const float*, float*, float*,
                         const Geom);

template <int LO, int BT, int KS>
KernelFn pick_vec(int wvec) {
  return wvec ? spectral_mode_matmul_kernel<LO, BT, KS, true>
              : spectral_mode_matmul_kernel<LO, BT, KS, false>;
}

template <int LO, int BT>
KernelFn pick_ks(int ks, int wvec) {
  switch (ks) {
    case 1: return pick_vec<LO, BT, 1>(wvec);
    case 2: return pick_vec<LO, BT, 2>(wvec);
    case 4: return pick_vec<LO, BT, 4>(wvec);
    case 8:  // a deep split keeps the partial sums within static shared memory
      if constexpr (BT == 2) return pick_vec<LO, BT, 8>(wvec);
      return nullptr;
    default: return nullptr;
  }
}

template <int LO>
KernelFn pick_bt(int bt, int ks, int wvec) {
  return bt == 2 ? pick_ks<LO, 2>(ks, wvec) : bt == 4 ? pick_ks<LO, 4>(ks, wvec) : nullptr;
}

KernelFn pick(int lo, int bt, int ks, int wvec) {
  switch (lo) {
    case 1: return pick_bt<1>(bt, ks, wvec);
    case 2: return pick_bt<2>(bt, ks, wvec);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// xr, xi: (B, M0, M1, M2, Cin) f32; wr, wi: (M0, M1, M2, Cin, Cout) f32;
// outr, outi: (B, M0, M1, M2, Cout) f32; all addressed through the element
// strides in `geom`, a host array of 21 values: B, M0, M1, M2, Cin, Cout,
// then 5 strides each for x, w and out (see Geom).  tile: the wrapper's
// plan, 6 ints: LO (1 or 2), BT (2 or 4), KS (1, 2, 4, or 8 with BT 2), wvec (the
// weight's modes are flat at stride 2 with im one element after re, 16-byte
// aligned: float4 loads), xvec (x channel-fastest, 8-byte aligned), ovec
// (out channel-fastest, 16-byte aligned).  Returns a cudaError_t
// (0 = launched).
int tante_spectral_mode_matmul(const void* xr, const void* xi, const void* wr, const void* wi,
                               void* outr, void* outi, const long long* geom, const int* tile,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geom g;
  int* sizes[6] = {&g.B, &g.M0, &g.M1, &g.M2, &g.Cin, &g.Cout};
  for (int i = 0; i < 6; ++i) {
    if (geom[i] <= 0 || geom[i] > 0x7fffffffLL) return cudaErrorInvalidValue;
    *sizes[i] = (int)geom[i];
  }
  const long long modes = geom[1] * geom[2] * geom[3];
  if (modes > 0x7fffffffLL) return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) {
    g.xs[i] = geom[6 + i];
    g.ws[i] = geom[11 + i];
    g.os[i] = geom[16 + i];
  }
  const int lo = tile[0], bt = tile[1], ks = tile[2];
  const KernelFn k = pick(lo, bt, ks, tile[3]);
  if (!k || (tile[3] && modes % 2)) return cudaErrorInvalidValue;
  g.x_vec = tile[4];
  g.o_vec = tile[5];
  const long long pairs = (modes + 1) / 2;
  g.mode_tiles = (int)((pairs + 32 / lo - 1) / (32 / lo));
  const long long gx = (long long)g.mode_tiles * ((g.Cout + kOT * lo - 1) / (kOT * lo));
  const long long gy = (g.B + bt - 1) / bt;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  k<<<dim3((unsigned)gx, (unsigned)gy), 32 * ks, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(wr), static_cast<const float*>(wi), static_cast<float*>(outr),
      static_cast<float*>(outi), g);
  return cudaGetLastError();
}

}  // extern "C"
