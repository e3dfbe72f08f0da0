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
//     permuted view of its re or im half (modes are then its fastest axis).
//
// Bound: bytes.  8*B*M*Cin*Cout flops against 4*(2*B*M*(Cin+Cout) +
// 2*M*Cin*Cout) bytes; at the FNO shape (B=4, M=220, C=48) the weight (4 MB)
// is nearly all of the traffic and each weight element meets only B inputs,
// so a weight element makes one trip from device memory, straight into the
// registers of the threads that use it (no pass through shared memory), and
// x (small, reused by every output channel) sits in shared memory.
//
// Design: a CTA owns a tile of 16 modes x 8 output channels for up to 8 batch
// entries, with one thread per (mode, cout, pair of batch entries): 512
// threads, 2 complex accumulators each, walking Cin in chunks of 16.  Per
// chunk a thread loads its own 16 wr and 16 wi straight into registers (the
// four threads of a (mode, cout) ask for the same addresses: one trip to
// device memory, the rest are cache hits) and its share of the x chunk, which
// goes to shared memory (mode fastest, padded against bank conflicts) for
// all 8 output channels of a mode to read; 4 FMAs per batch entry and input
// channel.  The shapes are small (the FNO shape gives 84 CTAs), so latency is
// the cost, not bytes or FMAs: the batch is spread over threads to have 16
// warps on an SM instead of 4, every global load of a chunk is started in one
// go, and the loads of chunk k + 1 are in flight while chunk k is computed.
// Every access to device memory follows the operand's own fastest axis: the
// lanes of a warp run along modes when modes are the weight's fastest axis
// (the stored layout) and along output channels when those are (a contiguous
// (M, Cin, Cout) weight; the wrapper picks from the strides); the x chunk is
// staged in whichever order x is contiguous in; and the result leaves
// through shared memory in the output's own order.  More batch entries take
// more CTAs (grid z) and re-read the weight from L2.
// Sums run over Cin in order, f32 FMA: against the plain version (four
// separately summed products) only the rounding order differs.
// What it leaves on the table (times in PERF.md): a CTA still runs a chain
// of dependent steps (mode table, loads, barrier, stores, barrier, FMAs, and
// the output's trip through shared memory) that costs microseconds where the
// bound is one; a persistent grid walking tiles, a deeper prefetch and
// tensor-core (tf32) products are untried.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 8;    // batch entries per CTA
constexpr int kBT = 2;       // batch entries per thread (complex accumulators)
constexpr int kChunk = 16;   // input channels staged per step
constexpr int kTM = 16;      // modes per CTA
constexpr int kTO = 8;       // output channels per CTA
constexpr int kPlaneThreads = kTM * kTO;  // one thread per (mode, cout) ...
constexpr int kThreads = kPlaneThreads * (kBatch / kBT);  // ... and pair of batch entries
// x elements (re and im each) a thread stages per chunk.
constexpr int kStage = kBatch * kChunk * kTM / kThreads;
static_assert(kStage * kThreads == kBatch * kChunk * kTM, "the chunk must tile over the CTA");
static_assert(kBatch * kTM * (kTO + 1) <= kBatch * kChunk * (kTM + 1),
              "the output tile reuses the x chunk's shared memory");

struct Geom {
  int B, M0, M1, M2, Cin, Cout;
  long long xs[5];  // x strides in elements: batch, mode0, mode1, mode2, channel
  long long ws[5];  // w strides: mode0, mode1, mode2, cin, cout
  long long os[5];  // out strides: batch, mode0, mode1, mode2, channel
};

// Element offset of flat mode m = (m0, m1, m2) under strides (s0, s1, s2).
__device__ __forceinline__ long long mode_offset(int m, int M1, int M2, long long s0,
                                                 long long s1, long long s2) {
  return (m / (M2 * M1)) * s0 + ((m / M2) % M1) * s1 + (m % M2) * s2;
}

// One chunk's global loads of a thread: its own weights and its share of x.
struct Chunk {
  float a[kChunk], d[kChunk];    // wr, wi of (mode, cout) for the chunk's channels
  float xr[kStage], xi[kStage];  // staged x elements, in staging order
};

// Staging element e of the thread -> (batch, channel, mode) within the tile;
// whichever of x's channel and mode axes is contiguous runs fastest across
// threads.  Batch is the slowest in both orders.
__device__ __forceinline__ void stage_index(int e, bool channel_fast, int& b, int& c, int& mm) {
  if (channel_fast) {
    c = e % kChunk; mm = (e / kChunk) % kTM;
  } else {
    mm = e % kTM; c = (e / kTM) % kChunk;
  }
  b = e / (kChunk * kTM);
}

template <bool kModeFast>
__global__ void __launch_bounds__(kThreads)
spectral_mode_matmul_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                            const float* __restrict__ wr, const float* __restrict__ wi,
                            float* __restrict__ outr, float* __restrict__ outi, const Geom g) {
  __shared__ float sx[2][kBatch][kChunk][kTM + 1];
  __shared__ long long x_mode[kTM], o_mode[kTM];

  const int tid = threadIdx.x;
  const int lane2d = tid % kPlaneThreads;
  const int tm = kModeFast ? lane2d % kTM : lane2d / kTO;
  const int to = kModeFast ? lane2d / kTM : lane2d % kTO;
  const int tb = tid / kPlaneThreads * kBT;  // first batch entry of the thread (warp-uniform)
  const int M = g.M0 * g.M1 * g.M2;
  const int m_base = blockIdx.x * kTM;
  const int o_base = blockIdx.y * kTO;
  const int m = m_base + tm;
  const int o = o_base + to;
  const int b0 = blockIdx.z * kBatch;
  const int nb = min(kBatch, g.B - b0);
  const bool live = m < M && o < g.Cout;
  const bool x_channel_fast = g.xs[4] == 1;

  if (tid < kTM) {
    const bool in = m_base + tid < M;
    x_mode[tid] = in ? mode_offset(m_base + tid, g.M1, g.M2, g.xs[1], g.xs[2], g.xs[3]) : 0;
    o_mode[tid] = in ? mode_offset(m_base + tid, g.M1, g.M2, g.os[1], g.os[2], g.os[3]) : 0;
  }
  const long long w_off =
      live ? mode_offset(m, g.M1, g.M2, g.ws[0], g.ws[1], g.ws[2]) + o * g.ws[4] : 0;
  __syncthreads();

  // Start every global load of the chunk that begins at channel c0.
  auto load = [&](Chunk& k, int c0) {
    const int nc = min(kChunk, g.Cin - c0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      k.a[c] = k.d[c] = 0.f;
      if (live && tb < nb && c < nc) {
        const long long off = w_off + (c0 + c) * g.ws[3];
        k.a[c] = __ldg(wr + off);
        k.d[c] = __ldg(wi + off);
      }
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      int b, c, mm;
      stage_index(j * kThreads + tid, x_channel_fast, b, c, mm);
      k.xr[j] = k.xi[j] = 0.f;
      if (b < nb && c < nc && m_base + mm < M) {
        const long long off = (long long)(b0 + b) * g.xs[0] + x_mode[mm] + (c0 + c) * g.xs[4];
        k.xr[j] = __ldg(xr + off);
        k.xi[j] = __ldg(xi + off);
      }
    }
  };

  float ar[kBT], ai[kBT];
#pragma unroll
  for (int b = 0; b < kBT; ++b) ar[b] = ai[b] = 0.f;

  Chunk next;
  load(next, 0);
  for (int c0 = 0; c0 < g.Cin; c0 += kChunk) {
    const int nc = min(kChunk, g.Cin - c0);
    __syncthreads();  // the chunk before is consumed
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      int b, c, mm;
      stage_index(j * kThreads + tid, x_channel_fast, b, c, mm);
      sx[0][b][c][mm] = next.xr[j];
      sx[1][b][c][mm] = next.xi[j];
    }
    float a[kChunk], d[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      a[c] = next.a[c];
      d[c] = next.d[c];
    }
    __syncthreads();
    if (c0 + kChunk < g.Cin) load(next, c0 + kChunk);  // in flight during the FMAs
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c >= nc) break;  // a short last chunk (uniform)
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        if (tb + b < nb) {
          const float p = sx[0][tb + b][c][tm], q = sx[1][tb + b][c][tm];
          ar[b] = fmaf(p, a[c], ar[b]);
          ar[b] = fmaf(-q, d[c], ar[b]);
          ai[b] = fmaf(p, d[c], ai[b]);
          ai[b] = fmaf(q, a[c], ai[b]);
        }
      }
    }
  }

  // The output tile goes through shared memory (over the x chunk) and leaves
  // in the output's own order: channels fastest, or modes (channel-major x).
  float* so = &sx[0][0][0][0];
  constexpr int kPlane = kBatch * kTM * (kTO + 1);
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kBT; ++b) {
    so[((tb + b) * kTM + tm) * (kTO + 1) + to] = ar[b];
    so[kPlane + ((tb + b) * kTM + tm) * (kTO + 1) + to] = ai[b];
  }
  __syncthreads();
  const bool o_channel_fast = g.os[4] == 1;
  for (int e = tid; e < kBatch * kTM * kTO; e += kThreads) {
    int mm, oo;
    if (o_channel_fast) {
      oo = e % kTO; mm = (e / kTO) % kTM;
    } else {
      mm = e % kTM; oo = (e / kTM) % kTO;
    }
    const int b = e / (kTM * kTO);
    if (b < nb && m_base + mm < M && o_base + oo < g.Cout) {
      const long long off = (long long)(b0 + b) * g.os[0] + o_mode[mm] + (o_base + oo) * g.os[4];
      outr[off] = so[(b * kTM + mm) * (kTO + 1) + oo];
      outi[off] = so[kPlane + (b * kTM + mm) * (kTO + 1) + oo];
    }
  }
}

}  // namespace

extern "C" {

// xr, xi: (B, M0, M1, M2, Cin) f32; wr, wi: (M0, M1, M2, Cin, Cout) f32;
// outr, outi: (B, M0, M1, M2, Cout) f32; all addressed through the element
// strides in `geom`, a host array of 21 values: B, M0, M1, M2, Cin, Cout,
// then 5 strides each for x, w and out (see Geom).  mode_fast: modes (not
// output channels) are the weight's fastest axis.  Returns a cudaError_t
// (0 = launched).
int tante_spectral_mode_matmul(const void* xr, const void* xi, const void* wr, const void* wi,
                               void* outr, void* outi, const long long* geom, int mode_fast,
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
  const long long gy = (g.Cout + kTO - 1) / kTO, gz = (g.B + kBatch - 1) / kBatch;
  if (gy > 65535 || gz > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((modes + kTM - 1) / kTM), (unsigned)gy, (unsigned)gz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(xr);
  const float* b = static_cast<const float*>(xi);
  const float* c = static_cast<const float*>(wr);
  const float* d = static_cast<const float*>(wi);
  float* e = static_cast<float*>(outr);
  float* f = static_cast<float*>(outi);
  if (mode_fast)
    spectral_mode_matmul_kernel<true><<<grid, kThreads, 0, st>>>(a, b, c, d, e, f, g);
  else
    spectral_mode_matmul_kernel<false><<<grid, kThreads, 0, st>>>(a, b, c, d, e, f, g);
  return cudaGetLastError();
}

}  // extern "C"
