// The single-block entry points of the Hopper block body (block_sm90.cuh):
// one CTA per tile of whole sequences, contiguous (fused_block_fwd) or under
// the T axis's strided row map (fused_block_canon_t_fwd), each for bf16 and
// for f32 activations and weights (the *_f32_fwd entries, on the f32 tile
// body block_tile_f32).

#include "block_sm90.cuh"

namespace {

// ---- the single-block kernel ----------------------------------------------------
//
// One CTA per tile.  STRIDED: the block's row maps (the canonical T block);
// else sequences of L consecutive rows.  Its CTA is spelled out here, not
// run through block_cta as the f32 kernel's and both chain kernels' are:
// through block_cta, ptxas spills 672-688 bytes a thread in the contiguous
// instantiations instead of 584-608 (tools/ptxas_compare.py).
template <int D, bool SAFE, bool STRIDED>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_sm90_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape& S = A.sh;
  const Block& B = A.blk;
  const int max_np = max_pass(S);
  const Layout lay = layout(S.R, S.C, S.HID, S.stages, max_np);
  bf16* sA = reinterpret_cast<bf16*>(smem + lay.a);
  bf16* sB = reinterpret_cast<bf16*>(smem + lay.b);
  bf16* sQkv = reinterpret_cast<bf16*>(smem + lay.qkv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Ring ring{smem + lay.ring, bars, bars + S.stages, S.stages, kSlabK * max_np * 2, 0};

  const int seq0 = blockIdx.x * B.seqs;
  const int nseq = min(B.seqs, B.n_seqs - seq0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S.stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: stream every slab of the tile's schedule, in order.  Its
    // warpgroup hands most of its registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int idx = 0;
      produce_tile(reinterpret_cast<const unsigned char*>(B.p[WARR]), S, ring, idx);
    }
    return;
  }

  // Consumers: 232 registers each (2 x 128 x 232 + 128 x 40 <= 65536).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int slot = blockIdx.x;
  if constexpr (STRIDED)
    block_tile<D, SAFE>(B, S, A.x, A.y, strided_tile(B, B.in, seq0, nseq, S.C),
                        strided_tile(B, B.out, seq0, nseq, S.C), nseq * B.L, ring, sA, sB, sQkv,
                        slot, true);
  else
    block_tile<D, SAFE>(B, S, A.x, A.y, contig_tile(B, seq0, S.C), contig_tile(B, seq0, S.C),
                        nseq * B.L, ring, sA, sB, sQkv, slot, true);
}

// The f32 kernel: the same CTA on the f32 tile body.  A kernel of its own,
// not a template parameter of the bf16 one: that would rename the bf16
// kernels, whose code and ptxas summaries stay as they were
// (tools/ptxas_compare.py).
template <int D, bool SAFE, bool STRIDED>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_sm90_f32_kernel(const __grid_constant__ Args A) {
  const Shape& S = A.sh;
  const Block& B = A.blk;
  const int seq0 = blockIdx.x * B.seqs;
  const int nseq = min(B.seqs, B.n_seqs - seq0);
  block_cta<float>(
      S,
      [&](Ring& ring) {
        int idx = 0;
        produce_tile<float>(reinterpret_cast<const unsigned char*>(B.p[WARR]), S, ring, idx);
      },
      [&](Ring& ring, float* sA, float* sB, float* sQkv) {
        const float* x = reinterpret_cast<const float*>(A.x);
        float* y = reinterpret_cast<float*>(A.y);
        if constexpr (STRIDED)
          block_tile_f32<D, SAFE>(B, S, x, y, strided_tile(B, B.in, seq0, nseq, S.C),
                                  strided_tile(B, B.out, seq0, nseq, S.C), nseq * B.L, ring, sA,
                                  sB, sQkv, blockIdx.x, true);
        else
          block_tile_f32<D, SAFE>(B, S, x, y, contig_tile(B, seq0, S.C),
                                  contig_tile(B, seq0, S.C), nseq * B.L, ring, sA, sB, sQkv,
                                  blockIdx.x, true);
      });
}

// T: the activation type (bf16 or float), which picks the kernel.
template <class T, int D, bool SAFE, bool STRIDED>
cudaError_t launch_dt(const Args& A, int grid, size_t smem, cudaStream_t st) {
  void (*k)(const Args);
  if constexpr (std::is_same<T, float>::value)
    k = fused_block_sm90_f32_kernel<D, SAFE, STRIDED>;
  else
    k = fused_block_sm90_kernel<D, SAFE, STRIDED>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, st>>>(A);
  return cudaGetLastError();
}

// One block on n_seqs sequences: checks, then one CTA per tile.
template <class T, bool STRIDED>
int launch_block(const void* x, void* y, const void* const* w, const int* plan,
                 const int* map, int n_seqs, int L, int C, int HID, int heads, int causal,
                 int safe, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args A;
  const long long smem = std::is_same<T, float>::value ? make_shape_f32(A.sh, plan, C, HID)
                                                        : make_shape(A.sh, plan, C, HID);
  const int d = head_dim(C, heads);
  if (!smem || !d || !make_block(A.blk, w, L, causal, n_seqs, plan[1], A.sh.R, C, map, map))
    return cudaErrorInvalidValue;
  err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  if (n_seqs == 0) return cudaSuccess;
  A.x = static_cast<const bf16*>(x);
  A.y = static_cast<bf16*>(y);
  const int grid = (n_seqs + A.blk.seqs - 1) / A.blk.seqs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (STRIDED) {  // the canonical T block: the "fast" softmax only (its gate)
    if (d == 16) return launch_dt<T, 16, false, true>(A, grid, smem, st);
    if (d == 32) return launch_dt<T, 32, false, true>(A, grid, smem, st);
    return launch_dt<T, 64, false, true>(A, grid, smem, st);
  }
  if (d == 16)
    return safe ? launch_dt<T, 16, true, false>(A, grid, smem, st)
                : launch_dt<T, 16, false, false>(A, grid, smem, st);
  if (d == 32)
    return safe ? launch_dt<T, 32, true, false>(A, grid, smem, st)
                : launch_dt<T, 32, false, false>(A, grid, smem, st);
  return safe ? launch_dt<T, 64, true, false>(A, grid, smem, st)
              : launch_dt<T, 64, false, false>(A, grid, smem, st);
}

}  // namespace

extern "C" {


// x, y: (S, L, C) bf16.  w: host array of 9 device pointers: ln1_scale,
// ln1_bias, the q|k|v bias of each head group in turn (q prescaled),
// bo, ln2_scale, ln2_bias, b1, b2, and the re-laid weights (every slab of
// the schedule in order; see ops/fused_block.py:sm90_weights).  plan: R,
// sequences per tile, the four column passes, ring stages.  Returns a
// cudaError_t (0 = launched).
int tante_fused_block_sm90_fwd(const void* x, void* y, const void* const* w, const int* plan,
                               int n_seqs, int L, int C, int HID, int heads, int causal, int safe,
                               int device, void* stream) {
  return launch_block<bf16, false>(x, y, w, plan, nullptr, n_seqs, L, C, HID, heads, causal, safe,
                                   device, stream);
}

// The same block in f32: x, y (S, L, C) f32, the 9 pointers f32 (the
// re-laid weights in the f32 slab layout, ops/fused_block.py:sm90_weights),
// plan an f32 plan (R = 64, C <= 256).
int tante_fused_block_sm90_f32_fwd(const void* x, void* y, const void* const* w, const int* plan,
                                   int n_seqs, int L, int C, int HID, int heads, int causal,
                                   int safe, int device, void* stream) {
  return launch_block<float, false>(x, y, w, plan, nullptr, n_seqs, L, C, HID, heads, causal,
                                    safe, device, stream);
}

// The causal T block on canonical (B, T, H, W, C) bf16, "fast" softmax:
// n_seqs = B*H*W sequences of T steps; w and plan as above (plan of L = T);
// map: the 6 ints (per, n2, sb, s1, s2, sa) of the T axis in canonical order,
// for x and y alike.
int tante_fused_block_canon_t_sm90_fwd(const void* x, void* y, const void* const* w,
                                       const int* plan, const int* map, int n_seqs, int T, int C,
                                       int HID, int heads, int device, void* stream) {
  return launch_block<bf16, true>(x, y, w, plan, map, n_seqs, T, C, HID, heads, 1, 0, device,
                                  stream);
}

// The causal T block on canonical (B, T, H, W, C) f32: as above, f32
// tensors and an f32 plan.
int tante_fused_block_canon_t_sm90_f32_fwd(const void* x, void* y, const void* const* w,
                                           const int* plan, const int* map, int n_seqs, int T,
                                           int C, int HID, int heads, int device, void* stream) {
  return launch_block<float, true>(x, y, w, plan, map, n_seqs, T, C, HID, heads, 1, 0, device,
                                   stream);
}

}  // extern "C"
