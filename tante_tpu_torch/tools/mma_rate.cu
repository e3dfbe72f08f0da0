// The f32 tile body's inner loop (block_sm90.cuh:gemm_f32_rb, the q|k|v
// pass: 64 rows x 192 columns per 16-deep slab, 8 warps) in isolation, one
// CTA per SM, operands resident in shared memory, no weight ring: how fast
// mma.sync m16n8k8 TF32 issues on this card, and what each part of the
// 3xTF32 loop costs.  Built and run by tools/mma_rate.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLda = 260;  // ld_f(256)

__device__ __forceinline__ uint32_t rna_cvt(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ uint32_t rna_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// SPLIT 0: none (the raw bits as both parts); 1: cvt.rna; 2: integer rounding.
template <int SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (SPLIT == 0) {
    hi = lo = __float_as_uint(x);
  } else if (SPLIT == 1) {
    hi = rna_cvt(x);
    lo = rna_cvt(x - __uint_as_float(hi));
  } else {
    hi = rna_int(x);
    lo = rna_int(x - __uint_as_float(hi));
  }
}

template <bool FRESH>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if (FRESH)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// PASSES 1 or 3 mma per product; FRESH: each slab's products in a fresh
// fragment added to the total; FENCE: a proxy fence and warp sync per slab
// (the ring's release); GUARD: the 16-row block count as a runtime test.
template <int SPLIT, int PASSES, bool FRESH, bool FENCE, bool GUARD>
__global__ void __launch_bounds__(256, 1)
rate_kernel(const float* gA, const float* gB, float* out, long long* cycles, int slabs,
            int blocks) {
  constexpr int NJ = 3, RB = 4;
  extern __shared__ float sm[];
  float* A = sm;
  float* B = sm + 64 * kLda;
  for (int i = threadIdx.x; i < 64 * kLda; i += 256) A[i] = gA[i];
  for (int i = threadIdx.x; i < 16 * 64 * NJ; i += 256) B[i] = gB[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[RB][NJ][4];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rb][j][e] = 0.f;
  const float* arow = A + g * kLda + t;
  const long long t0 = clock64();
  for (int s = 0; s < slabs; ++s) {
    const int kc = s & 15;
    const float4* slab = reinterpret_cast<const float4*>(B) + warp * 32 + lane;
    uint32_t bh[NJ][4], bl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b = slab[j * 256];
      split<SPLIT>(b.x, bh[j][0], bl[j][0]);
      split<SPLIT>(b.y, bh[j][1], bl[j][1]);
      split<SPLIT>(b.z, bh[j][2], bl[j][2]);
      split<SPLIT>(b.w, bh[j][3], bl[j][3]);
    }
    if (FENCE) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
    }
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      if (GUARD && rb >= blocks) continue;
      float part[NJ][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* a = arow + 16 * rb * kLda + kc * 16 + 8 * ks;
        uint32_t ah[4], al[4];
        split<SPLIT>(a[0], ah[0], al[0]);
        split<SPLIT>(a[8 * kLda], ah[1], al[1]);
        split<SPLIT>(a[4], ah[2], al[2]);
        split<SPLIT>(a[8 * kLda + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float* d = FRESH ? part[j] : acc[rb][j];
          if (PASSES == 3) {
            if (FRESH && ks == 0)
              mma<true>(d, al, bh[j][0], bh[j][1]);
            else
              mma<false>(d, al, bh[j][2 * ks], bh[j][2 * ks + 1]);
            mma<false>(d, ah, bl[j][2 * ks], bl[j][2 * ks + 1]);
          }
          if (PASSES == 1 && FRESH && ks == 0)
            mma<true>(d, ah, bh[j][0], bh[j][1]);
          else
            mma<false>(d, ah, bh[j][2 * ks], bh[j][2 * ks + 1]);
        }
      }
      if (FRESH) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rb][j][e] += part[j][e];
      }
    }
  }
  const long long t1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += acc[rb][j][e];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int SPLIT, int PASSES, bool FRESH, bool FENCE, bool GUARD>
int run(const float* A, const float* B, float* out, long long* cycles, int slabs, int ctas,
        float* ms) {
  auto k = rate_kernel<SPLIT, PASSES, FRESH, FENCE, GUARD>;
  const int smem = 150 * 1024;  // one CTA an SM
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<ctas, 256, smem>>>(A, B, out, cycles, slabs, 4);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  k<<<ctas, 256, smem>>>(A, B, out, cycles, slabs, 4);
  cudaEventRecord(e1);
  err = cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {
// One launch of variant v (0-6, see tools/mma_rate.py) on `ctas` CTAs of
// `slabs` slabs, after a warm-up launch: its time to *ms, each CTA's SM
// cycles to cycles.  Returns a cudaError_t.
int tante_mma_rate(const float* A, const float* B, float* out, long long* cycles, float* ms,
                   int slabs, int ctas, int v) {
  switch (v) {
    case 0: return run<0, 1, false, false, false>(A, B, out, cycles, slabs, ctas, ms);
    case 1: return run<0, 3, false, false, false>(A, B, out, cycles, slabs, ctas, ms);
    case 2: return run<1, 3, false, false, false>(A, B, out, cycles, slabs, ctas, ms);
    case 3: return run<2, 3, false, false, false>(A, B, out, cycles, slabs, ctas, ms);
    case 4: return run<2, 3, true, false, false>(A, B, out, cycles, slabs, ctas, ms);
    case 5: return run<2, 3, true, true, false>(A, B, out, cycles, slabs, ctas, ms);
    case 6: return run<2, 3, true, true, true>(A, B, out, cycles, slabs, ctas, ms);
    default: return cudaErrorInvalidValue;
  }
}
}
