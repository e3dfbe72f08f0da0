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
// axial layout (two sequence axes).  Nothing is packed, transposed or copied
// on the way in or out.
//
// Bound: bytes.  Each input element is read once and each output element
// written once: 4 * S * P * D * itemsize bytes, against 4 * S * P * L * D
// flops, L / 4 flops a byte in f32 (4 at the AViT shape, L = 16), below the
// card's ~20 f32 flops per byte of bandwidth outside the tensor cores.
//
// Design (simple first; no tensor cores, no TMA): one CTA per sequence, all
// heads (P <= 128).  K and V of the whole sequence are staged in shared
// memory as f32 (one row of padding against bank conflicts), queries in
// chunks of 64 rows.  Per chunk: one thread per (query, key) score, a dot
// product over D read from shared memory; one warp per query row for the
// max-subtract softmax (division by the sum, as the plain version); one
// thread per (query, channel) output, accumulated over the segment's keys in
// order.  Masked (causal) pairs are skipped: the plain version's -1e30 fill
// gives them a weight of exactly 0.
//
// Envelope: P = heads * L <= 128, D in [8, 128], f32 or bf16 (the wrapper
// checks it); at most 198 KB of dynamic shared memory (P = 128, D = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // query rows per chunk
constexpr int kMaxP = 128;
constexpr int kMinD = 8, kMaxD = 128;

struct Geom {
  int S0, S1, H, L, D;
  long long qs[5], ks[5], vs[5], os[5];  // strides: s0, s1, head, position, channel
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride of a staged (rows, D) f32 tile: odd, so that the rows a warp
// reads at one channel fall into different banks.
__host__ __device__ __forceinline__ int padded(int d) { return d | 1; }

__host__ __device__ inline size_t smem_bytes(int p, int l, int d) {
  return sizeof(float) * ((size_t)2 * p * padded(d) + (size_t)kRows * padded(d) +
                          (size_t)kRows * l);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, const Geom g,
                        const int causal, const float scale) {
  extern __shared__ float smem[];
  const int H = g.H, L = g.L, D = g.D, P = H * L, ld = padded(D);
  float* sk = smem;              // (P, ld)
  float* sv = sk + P * ld;       // (P, ld)
  float* sq = sv + P * ld;       // (kRows, ld)
  float* sw = sq + kRows * ld;   // (kRows, L): scores, then weights
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long s0 = blockIdx.x / g.S1, s1 = blockIdx.x % g.S1;
  const T* qb = q + s0 * g.qs[0] + s1 * g.qs[1];
  const T* kb = k + s0 * g.ks[0] + s1 * g.ks[1];
  const T* vb = v + s0 * g.vs[0] + s1 * g.vs[1];
  T* ob = out + s0 * g.os[0] + s1 * g.os[1];

  // Packed row p = h * L + i: head h, position i.
  for (int e = tid; e < P * D; e += kThreads) {
    const int p = e / D, d = e % D, h = p / L, i = p % L;
    sk[p * ld + d] = to_f32(kb[h * g.ks[2] + i * g.ks[3] + d * g.ks[4]]);
    sv[p * ld + d] = to_f32(vb[h * g.vs[2] + i * g.vs[3] + d * g.vs[4]]);
  }

  for (int r0 = 0; r0 < P; r0 += kRows) {
    const int nr = min(kRows, P - r0);
    __syncthreads();  // K / V staged; the chunk before is written out
    for (int e = tid; e < nr * D; e += kThreads) {
      const int r = e / D, d = e % D, p = r0 + r;
      sq[r * ld + d] = to_f32(qb[(p / L) * g.qs[2] + (p % L) * g.qs[3] + d * g.qs[4]]);
    }
    __syncthreads();

    // Scores of the segment's admitted (query, key) pairs.
    for (int e = tid; e < nr * L; e += kThreads) {
      const int r = e / L, j = e % L, i = (r0 + r) % L;
      if (causal && j > i) continue;
      const float* qr = sq + r * ld;
      const float* kr = sk + (r0 + r - i + j) * ld;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      sw[r * L + j] = acc * scale;
    }
    __syncthreads();

    // Max-subtract softmax, one warp per row; weights rounded to T.
    for (int r = warp; r < nr; r += kWarps) {
      const int n = causal ? (r0 + r) % L + 1 : L;
      float* wr = sw + r * L;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, wr[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float x = expf(wr[j] - m);
        wr[j] = x;
        sum += x;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < n; j += 32) wr[j] = to_f32(from_f32<T>(wr[j] / sum));
    }
    __syncthreads();

    // out = w @ v over the segment's admitted keys, in order.
    for (int e = tid; e < nr * D; e += kThreads) {
      const int r = e / D, d = e % D, p = r0 + r, i = p % L;
      const int n = causal ? i + 1 : L;
      const float* wr = sw + r * L;
      const float* vc = sv + (p - i) * ld + d;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(wr[j], vc[j * ld], acc);
      ob[(p / L) * g.os[2] + i * g.os[3] + d * g.os[4]] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const Geom& g, int causal,
           float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(g.H * g.L, g.L, g.D);
  cudaError_t err = cudaFuncSetAttribute(packed_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)g.S0 * g.S1;
  packed_attention_kernel<T><<<(unsigned)ctas, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), g, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (S0, S1, H, L, D) of one dtype (bf16 = 1: bf16, else f32),
// addressed through the element strides in `geom`, a host array of 25
// values: S0, S1, H, L, D, then 5 strides each for q, k, v and out (see
// Geom).  q is scaled by `scale` inside (1 for pre-scaled q).  Returns a
// cudaError_t (0 = launched).
int tante_packed_attention(const void* q, const void* k, const void* v, void* out,
                           const long long* geom, int causal, float scale, int bf16, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geom g;
  int* sizes[5] = {&g.S0, &g.S1, &g.H, &g.L, &g.D};
  for (int i = 0; i < 5; ++i) {
    if (geom[i] <= 0 || geom[i] > 0x7fffffffLL) return cudaErrorInvalidValue;
    *sizes[i] = (int)geom[i];
  }
  if (geom[0] * geom[1] > 0x7fffffffLL || g.H * g.L > kMaxP || g.D < kMinD || g.D > kMaxD)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) {
    g.qs[i] = geom[5 + i];
    g.ks[i] = geom[10 + i];
    g.vs[i] = geom[15 + i];
    g.os[i] = geom[20 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, g, causal, scale, st)
              : launch<float>(q, k, v, out, g, causal, scale, st);
}

}  // extern "C"
