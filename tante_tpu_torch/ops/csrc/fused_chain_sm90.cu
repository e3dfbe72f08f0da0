// The chain entry point of the Hopper block body (block_sm90.cuh): a run of
// up to 12 T/H/W blocks in one cooperative, persistent launch, for bf16 and
// (tante_fused_chain_sm90_f32_fwd, on the f32 tile body block_tile_f32) for
// f32 activations and weights.
//
// Bound: each block is bound by operations like a single launch, so a run's
// bound is the sum of its blocks' (bytes: x in, y out, every weight once;
// the activations between blocks stay in the 50 MB L2 at the flagship).
// Grid: one CTA per SM (~227 KB of shared memory each).  The tiles of all
// blocks are one schedule, so a run of n tiles in all takes about n / 132
// tile-times, not the sum over its blocks of ceil(n_block / 132).

#include "block_sm90.cuh"

namespace {

// ---- the chain kernel --------------------------------------------------------------
//
// The schedule: the tiles of all blocks in one sequence (block 0's tiles,
// then block 1's, ...), tile g to CTA g % gridDim.x, each CTA taking its
// tiles in order.  Every row map keeps a batch element's rows inside that
// element, so a tile of block i needs only block i - 1's tiles of its own
// batch elements: done[i - 1][b] counts those finished.  That also covers the
// ping-pong buffers: block i + 1 writes the buffer block i reads, and its
// tile of batch element b waits for all of block i's tiles of b.
//
// The waits are among the consumer warpgroups alone; the producer threads
// wait only on their own ring, so they stream the next tile's slabs while
// the consumers wait.  It cannot deadlock: the launch is cooperative (every
// CTA resident), and a tile waits only on tiles earlier in the schedule; the
// earliest unfinished tile therefore waits on nothing and runs, its CTA
// having finished every tile before it.  A producer waits only on its own
// consumers' releases of slabs that come before in their order.

// Block i's tiles of batch elements [b0, b1]: b0, b1 of a tile's sequences.
__device__ __forceinline__ void tile_batches(const Block& B, int seq0, int nseq, int& b0,
                                             int& b1) {
  b0 = fdiv(seq0, B.in.mul_per, B.in.shift_per);
  b1 = fdiv(seq0 + nseq - 1, B.in.mul_per, B.in.shift_per);
}

// Before a tile of block i > 0: wait until block i - 1 has finished every
// tile that touches the tile's batch elements, then order its stores before
// this tile's (L2-only) loads, as cooperative_groups' grid.sync does.
__device__ __forceinline__ void wait_inputs(const ChainArgs& A, int i, int seq0, int nseq) {
  if (threadIdx.x == 0) {
    const Block& P = A.step[i - 1];
    int b0, b1;
    tile_batches(A.step[i], seq0, nseq, b0, b1);
    for (int b = b0; b <= b1; ++b) {
      const int need = ((b + 1) * P.in.per - 1) / P.seqs - (b * P.in.per) / P.seqs + 1;
      const volatile int* done = A.done + (i - 1) * A.n_batch + b;
      while (*done < need) {
      }
    }
    __threadfence();
  }
  consumers_sync();
}

// After a tile of block i (its last stores behind a consumers' barrier):
// count it for each batch element it touched.
__device__ __forceinline__ void publish(const ChainArgs& A, int i, int seq0, int nseq) {
  if (threadIdx.x == 0 && i + 1 < A.n_steps) {
    int b0, b1;
    tile_batches(A.step[i], seq0, nseq, b0, b1);
    __threadfence();
    for (int b = b0; b <= b1; ++b) atomicAdd(A.done + i * A.n_batch + b, 1);
  }
}

// The next tile of this CTA's share of the schedule: advances (i, first:
// the block and its first schedule index) to schedule index g; false past
// the last block.
__device__ __forceinline__ bool next_tile(const ChainArgs& A, int g, int& i, int& first) {
  while (i < A.n_steps && g >= first + A.step[i].tiles) first += A.step[i++].tiles;
  return i < A.n_steps;
}

#ifdef TANTE_PHASE_TIMING
#define CHAIN_STAMP(k, v)                                                    \
  do {                                                                       \
    if (threadIdx.x == 0 && slot < kPhaseSlots) g_chain_ns[slot][k] = (v);   \
  } while (0)
#else
#define CHAIN_STAMP(k, v) \
  do {                    \
  } while (0)
#endif

// Persistent and cooperative.  Block i reads what block i - 1 wrote (or the
// caller's x) and writes the other buffer (or the caller's y).
template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
fused_chain_sm90_kernel(const __grid_constant__ ChainArgs A) {
  const Shape& S = A.sh;
  block_cta<bf16>(
      S,
      [&](Ring& ring) {
        int idx = 0, i = 0, first = 0;
#ifdef TANTE_PHASE_TIMING
        int seen = -1;
#endif
        for (int g = blockIdx.x; next_tile(A, g, i, first); g += gridDim.x) {
#ifdef TANTE_PHASE_TIMING
          const int slot = i * gridDim.x + blockIdx.x;
          if (i != seen && slot < kPhaseSlots) g_chain_ns[slot][3] = globaltimer();
          seen = i;
#endif
          produce_tile(reinterpret_cast<const unsigned char*>(A.step[i].p[WARR]), S, ring, idx);
        }
      },
      [&](Ring& ring, bf16* sA, bf16* sB, bf16* sQkv) {
        int i = 0, first = 0, seen = -1;
        for (int g = blockIdx.x; next_tile(A, g, i, first); g += gridDim.x) {
          const Block& B = A.step[i];
          const bf16* x = i == 0 ? A.x : A.buf[(i - 1) & 1];
          bf16* y = i == A.n_steps - 1 ? A.y : A.buf[i & 1];
          const int seq0 = (g - first) * B.seqs, nseq = min(B.seqs, B.n_seqs - seq0);
          const int slot = i * gridDim.x + blockIdx.x;
          const bool first_of_block = i != seen;
          seen = i;
#ifdef TANTE_PHASE_TIMING
          const unsigned long long t_wait = globaltimer();
          if (first_of_block) {
            CHAIN_STAMP(0, t_wait);
            CHAIN_STAMP(1, 0ull);
          }
#endif
          if (i > 0) wait_inputs(A, i, seq0, nseq);
#ifdef TANTE_PHASE_TIMING
          CHAIN_STAMP(1, g_chain_ns[slot][1] + (globaltimer() - t_wait));
#endif
          block_tile<D, SAFE>(B, S, x, y, strided_tile(B, B.in, seq0, nseq, S.C),
                              strided_tile(B, B.out, seq0, nseq, S.C), nseq * B.L, ring, sA, sB,
                              sQkv, slot, first_of_block);
          publish(A, i, seq0, nseq);
          CHAIN_STAMP(2, globaltimer());
        }
      });
}

// The f32 chain: the same CTA, schedule, waits and ring on the f32 tile
// body (a kernel of its own, as fused_block_sm90.cu's f32 kernel is).
template <int D, bool SAFE>
__global__ void __launch_bounds__(kThreads, 1)
fused_chain_sm90_f32_kernel(const __grid_constant__ ChainArgs A) {
  const Shape& S = A.sh;
  block_cta<float>(
      S,
      [&](Ring& ring) {
        int idx = 0, i = 0, first = 0;
        for (int g = blockIdx.x; next_tile(A, g, i, first); g += gridDim.x)
          produce_tile<float>(reinterpret_cast<const unsigned char*>(A.step[i].p[WARR]), S,
                              ring, idx);
      },
      [&](Ring& ring, float* sA, float* sB, float* sQkv) {
        int i = 0, first = 0;
        for (int g = blockIdx.x; next_tile(A, g, i, first); g += gridDim.x) {
          const Block& B = A.step[i];
          const float* x = reinterpret_cast<const float*>(i == 0 ? A.x : A.buf[(i - 1) & 1]);
          float* y = reinterpret_cast<float*>(i == A.n_steps - 1 ? A.y : A.buf[i & 1]);
          const int seq0 = (g - first) * B.seqs, nseq = min(B.seqs, B.n_seqs - seq0);
          if (i > 0) wait_inputs(A, i, seq0, nseq);
          block_tile_f32<D, SAFE>(B, S, x, y, strided_tile(B, B.in, seq0, nseq, S.C),
                                  strided_tile(B, B.out, seq0, nseq, S.C), nseq * B.L, ring, sA,
                                  sB, sQkv);
          publish(A, i, seq0, nseq);
        }
      });
}

// A cooperative grid of one CTA per SM at most (as many as are co-resident
// at this shared memory), no more CTAs than the schedule has tiles.  T: the
// activation type (bf16 or float), which picks the kernel.
template <class T, int D, bool SAFE>
cudaError_t launch_chain_dt(const ChainArgs& A, int total_tiles, size_t smem, int device,
                            cudaStream_t st) {
  void (*k)(const ChainArgs);
  if constexpr (std::is_same<T, float>::value)
    k = fused_chain_sm90_f32_kernel<D, SAFE>;
  else
    k = fused_chain_sm90_kernel<D, SAFE>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms < total_tiles ? per_sm * sms : total_tiles;
  err = cudaMemsetAsync(A.done, 0, sizeof(int) * A.n_steps * A.n_batch, st);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<ChainArgs*>(&A)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(k), dim3(grid), dim3(kThreads), args,
                                    smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T>
int launch_chain(const void* x, void* y, void* buf0, void* buf1, const void* const* w,
                 const int* plans, const int* maps, int n_steps, int C, int HID, int heads,
                 int safe, void* done, int n_batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int d = head_dim(C, heads);
  if (n_steps < 1 || n_steps > kMaxChain || !d || !done || n_batch < 1)
    return cudaErrorInvalidValue;
  ChainArgs A;
  const long long smem = std::is_same<T, float>::value ? make_shape_f32(A.sh, plans, C, HID)
                                                        : make_shape(A.sh, plans, C, HID);
  if (!smem) return cudaErrorInvalidValue;
  long long total_tiles = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int* plan = plans + 7 * i;
    const int* m = maps + 15 * i;
    for (int k = 0; k < 7; ++k)
      if (k != 1 && plan[k] != plans[k]) return cudaErrorInvalidValue;
    Block& B = A.step[i];
    if (m[2] < 1 || !make_block(B, w + kNPtr * i, m[0], m[1], m[2], plan[1], A.sh.R, C, m + 3,
                                m + 9))
      return cudaErrorInvalidValue;
    // Every block holds n_batch batch elements of per sequences, in and out.
    if (B.in.per != B.out.per || (long long)B.in.per * n_batch != m[2])
      return cudaErrorInvalidValue;
    total_tiles += B.tiles;
  }
  if (total_tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  err = smem_fits(smem, device);
  if (err != cudaSuccess) return err;
  A.x = static_cast<const bf16*>(x);
  A.y = static_cast<bf16*>(y);
  A.buf[0] = static_cast<bf16*>(buf0);
  A.buf[1] = static_cast<bf16*>(buf1);
  A.done = static_cast<int*>(done);
  A.n_steps = n_steps;
  A.n_batch = n_batch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (int)total_tiles;
  if (d == 16)
    return safe ? launch_chain_dt<T, 16, true>(A, tiles, smem, device, st)
                : launch_chain_dt<T, 16, false>(A, tiles, smem, device, st);
  if (d == 32)
    return safe ? launch_chain_dt<T, 32, true>(A, tiles, smem, device, st)
                : launch_chain_dt<T, 32, false>(A, tiles, smem, device, st);
  return safe ? launch_chain_dt<T, 64, true>(A, tiles, smem, device, st)
              : launch_chain_dt<T, 64, false>(A, tiles, smem, device, st);
}

}  // namespace

extern "C" {

// A run of n_steps blocks on one tensor of B*T*H*W rows of C in one
// cooperative launch.  x: the input in the first block's read order; y: the
// output in the last block's write order; buf0, buf1: scratch of the same
// size (unused for n_steps == 1 / 2).  w: n_steps x 9 device pointers (as
// tante_fused_block_sm90_fwd takes); plans: n_steps x 7 ints (each block's
// sm90 plan; R, the passes and the stages must agree, as they do for every L
// when C and HID agree); maps: n_steps x 15 ints (L, causal, n_seqs, the read
// map, the write map: ops/fused_block.py:chain_plan); done: n_steps x
// n_batch ints of device memory (zeroed here on the stream), n_batch the
// batch elements B.
int tante_fused_chain_sm90_fwd(const void* x, void* y, void* buf0, void* buf1,
                               const void* const* w, const int* plans, const int* maps,
                               int n_steps, int C, int HID, int heads, int safe, void* done,
                               int n_batch, int device, void* stream) {
  return launch_chain<bf16>(x, y, buf0, buf1, w, plans, maps, n_steps, C, HID, heads, safe, done,
                            n_batch, device, stream);
}

// The same run in f32: every tensor f32, the weights in the f32 slab layout,
// f32 plans (R = 64, C <= 256).
int tante_fused_chain_sm90_f32_fwd(const void* x, void* y, void* buf0, void* buf1,
                                   const void* const* w, const int* plans, const int* maps,
                                   int n_steps, int C, int HID, int heads, int safe, void* done,
                                   int n_batch, int device, void* stream) {
  return launch_chain<float>(x, y, buf0, buf1, w, plans, maps, n_steps, C, HID, heads, safe,
                             done, n_batch, device, stream);
}

// Bytes of the chain kernel's argument block (the kernel parameter limit
// is 4096 on every CUDA version; a static_assert holds it there).
int tante_chain_sm90_args_bytes() { return (int)sizeof(ChainArgs); }

#ifdef TANTE_PHASE_TIMING
// Copies the chain stamps of the first n slots: n x 4 (see g_chain_ns).
int tante_sm90_chain_read(unsigned long long* host, int n) {
  if (n > kPhaseSlots) n = kPhaseSlots;
  return cudaMemcpyFromSymbol(host, g_chain_ns, sizeof(unsigned long long) * 4 * n);
}
#endif

}  // extern "C"
