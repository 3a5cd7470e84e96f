// Kernels K5 and K6: Hamming distances and weights of packed bit rows, and
// the BSVD pursuit kernel that fuses them (packed_pursuit.cuh, note at its
// top; entry point bic_packed_pursuit below).  The pursuit no longer runs K5
// or K6; they stay as the ops `distances_to_atoms` and the row weights.
//
// Replaces: binary_image_compression_tpu/ops/pallas_kernels.py::
//           packed_dist_matrix (kernel body `_dist_kernel`) and
//           packed_row_weight (kernel body `_weight_kernel`).
//
// What they compute, on rows of 32-bit words (MSB-first bit rows, the uint32
// bit patterns carried as int32):
//   K5  out[i, k] = sum_w popcount(a[i, w] ^ b[k, w])   a [N, Wd], b [K, Wd]
//   K6  out[i]    = sum_w popcount(a[i, w])             a [N, Wd]
// Every value is an exact integer; there is no rounding to match.
//
// What bounds them on the H100: K5 reads each a row once per K/32 column
// tiles and each b row once per N/32 row tiles, all from L2 at the BSVD
// shapes (a is at most a few hundred KB), and does N * K * Wd xor+popc pairs;
// at [4096, 32] x [256, 32] that is 34 M integer ops, well under a
// millisecond.  K6 reads its rows once and is bound by the load.
//
// What the design does about it: K5 is a 2D grid of 32 x 32 output tiles.
// A block of 32 x 8 threads stages a 32-word chunk of its 32 a rows and its
// 32 b rows in shared memory (rows padded to 33 words so the b reads of a
// warp fall in 32 banks; the a reads are warp-wide broadcasts), then each
// thread accumulates __popc over the chunk for 4 outputs.  Any N, K, Wd >= 1:
// loads past an edge read 0 (whose xor with 0 adds nothing), and the chunk
// loop stops at Wd, so there is no bound on the row width.  K6 is one warp
// per row: __popc over a strided walk of the row, then __reduce_add_sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_pursuit.cuh"

namespace {

constexpr int kTile = 32;   // output rows and columns per block
constexpr int kRowsPer = 4; // outputs per thread (kTile / blockDim.y)
constexpr int kChunk = 32;  // words staged per step
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kTile * kTile / kRowsPer)
packed_dist_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                   int N, int K, int Wd) {
  __shared__ uint32_t sa[kTile][kChunk + 1];
  __shared__ uint32_t sb[kTile][kChunk + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int nthreads = kTile * kTile / kRowsPer;
  const int i0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  int acc[kRowsPer] = {0, 0, 0, 0};
  for (int w0 = 0; w0 < Wd; w0 += kChunk) {
    const int wn = min(kChunk, Wd - w0);
    // stage [32 rows x 32 words] of a and of b; consecutive threads take
    // consecutive words of a row, so each warp's load is one row segment
    for (int e = tid; e < kTile * kChunk; e += nthreads) {
      const int r = e / kChunk, c = e % kChunk;
      const int ia = i0 + r, kb = k0 + r;
      const bool inw = c < wn;
      sa[r][c] = (inw && ia < N) ? a[(size_t)ia * Wd + w0 + c] : 0u;
      sb[r][c] = (inw && kb < K) ? b[(size_t)kb * Wd + w0 + c] : 0u;
    }
    __syncthreads();
    for (int c = 0; c < wn; ++c) {
      const uint32_t bw = sb[tx][c];
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j)
        acc[j] += __popc(sa[ty + j * (kTile / kRowsPer)][c] ^ bw);
    }
    __syncthreads();
  }
  const int k = k0 + tx;
  if (k >= K) return;
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int i = i0 + ty + j * (kTile / kRowsPer);
    if (i < N) out[(size_t)i * K + k] = acc[j];
  }
}

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
packed_weight_kernel(const uint32_t* __restrict__ a,
                     int32_t* __restrict__ out, int N, int Wd) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const uint32_t* r = a + (size_t)row * Wd;
  unsigned s = 0;
  for (int w = lane; w < Wd; w += 32) s += __popc(__ldg(r + w));
  s = __reduce_add_sync(kFull, s);
  if (lane == 0) out[row] = (int32_t)s;
}

}  // namespace

// a: int32 [N, Wd]; b: int32 [K, Wd]; out: int32 [N, K].  Launches on
// `stream`, returns cudaGetLastError().
extern "C" int bic_packed_dist_matrix(const void* a, const void* b, void* out,
                                      int N, int K, int Wd, void* stream) {
  if (N <= 0 || K <= 0) return (int)cudaSuccess;
  if (Wd <= 0 || (K + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile);
  const dim3 block(kTile, kTile / kRowsPer);
  packed_dist_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, N, K, Wd);
  return (int)cudaGetLastError();
}

// a: int32 [N, Wd]; out: int32 [N].  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int bic_packed_row_weight(const void* a, void* out, int N, int Wd,
                                     void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (Wd <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  packed_weight_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>((const uint32_t*)a,
                                                 (int32_t*)out, N, Wd);
  return (int)cudaGetLastError();
}

// The BSVD pursuit, one warp per row: Ep int32 [N, nw] and A int8 [N, K]
// updated in place, Dp int32 [K, nw], passes int32 [N] out, ctr uint64 [2]
// (zeroed here; ctr[1] counts the rows that changed).  stage: 1 stages D in
// shared memory, 0 reads it from device memory, -1 chooses by its size.
// Launches on `stream`, returns a CUDA error code.
extern "C" int bic_packed_pursuit(void* Ep, const void* Dp, void* A,
                                  void* passes, void* ctr, int N, int K,
                                  int nw, int max_flips, int stage,
                                  void* stream) {
  return bic::packed_pursuit<32>(Ep, Dp, A, passes, ctr, N, K, nw, max_flips,
                                 stage, stream);
}
