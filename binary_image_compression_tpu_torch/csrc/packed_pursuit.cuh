// The BSVD pursuit kernel (`packed_pursuit`), the redesign of K5 with K6
// fused in; its C entry point is `bic_packed_pursuit` (packed_dist.cu).
//
// Replaces: binary_image_compression_tpu/ops/pallas_kernels.py::
//           packed_dist_matrix and packed_row_weight, as the JAX pursuit
//           (models/bsvd.py::update_coefficients, distances="packed") runs
//           them: K6 once for every |E_i|, then one K5 launch per sweep for
//           every |E_i ^ D_k|, an argmin, the flips and a host sync.
//
// What it computes.  In the sweep loop, row i's state changes only when row
// i improves, and a row that fails to improve stays inactive, so each row's
// outcome is the result of its own loop.  Per row, in this order:
//   w = popcount(E_i);
//   up to max_flips times: d_k = sum_w popc(E_i[w] ^ D_k[w]) for every k,
//     bestk = the first minimum (the lowest k among equal distances, as
//     jnp.argmin); if d_bestk < w: E_i ^= D_bestk, A[i, bestk] ^= 1,
//     w = d_bestk; otherwise stop.
// E (packed, int32 [N, nw]) and A (int8 [N, K]) are updated in place;
// passes[i] counts row i's distance passes and ctr[1] the rows that
// changed.  Every value is an exact integer.
//
// What bounds it on the H100: the popcounts, passes * K * nw of them (16 per
// clock per SM); the bytes are E in and out, D once and A's toggled bytes.
//
// What the design does about it:
//   * A group of G lanes per row (G = 32, one warp, in the library; the
//     variants script builds 16 and 8).  Lanes take atoms k = lane,
//     lane + G, ... and keep their own first minimum as one key
//     d << 16 | k (d << 32 | k past 16 words or 65,536 atoms), so one
//     reduction (`__reduce_min_sync`) picks the smallest distance and, among
//     equal ones, the lowest k.
//   * D sits in shared memory, word-major with a padded stride (Ds[w *
//     stride + k]), so the lanes reading one word of consecutive atoms hit
//     consecutive banks.  A block stages it once with 4-byte `cp.async`
//     copies, transposing on the way.  A dictionary too large to stage
//     (above kStageMax, or by request) is read through L1/L2 from device
//     memory in the same loop.
//   * A row of up to 16 words stays in registers (every lane holds it; a
//     flip XORs the chosen atom's words in, a broadcast read); a wider row
//     is read and flipped in place in device memory through L1, so there is
//     no bound on its width.
//   * The grid is persistent: ctr[0] is an atomic row counter, so rows that
//     take many passes (1 to 12 on doc512) do not leave SMs idle.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bic {

constexpr int kPursuitThreads = 256;
constexpr int kStageMax = 100 * 1024;  // two staged blocks fit on an SM

// D(w, k): word w of atom k.
template <bool STAGED>
struct PursuitDict;

template <>
struct PursuitDict<true> {
  const uint32_t* s;  // shared memory, word-major
  int stride;
  __device__ __forceinline__ uint32_t operator()(int w, int k) const {
    return s[w * stride + k];
  }
};

template <>
struct PursuitDict<false> {
  const uint32_t* __restrict__ g;  // device memory, atom-major [K, nw]
  int nw;
  __device__ __forceinline__ uint32_t operator()(int w, int k) const {
    return __ldg(g + (size_t)k * nw + w);
  }
};

__device__ __forceinline__ void cp_async_4(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The word-major stride of the staged dictionary: K + 4 words, so that the
// transposing copies of a warp fall in few banks.
inline int pursuit_stride(int K) { return K + 4; }

template <int G, int NWR, bool STAGED>
__global__ void __launch_bounds__(kPursuitThreads)
packed_pursuit_kernel(uint32_t* Ep, const uint32_t* __restrict__ Dp,
                      int8_t* A, int32_t* __restrict__ passes,
                      unsigned long long* ctr, int N, int K, int nw,
                      int max_flips, int stride) {
  extern __shared__ uint32_t Ds[];
  if constexpr (STAGED) {
    const int total = K * nw;
    for (int e = threadIdx.x; e < total; e += blockDim.x)
      cp_async_4(Ds + (e % nw) * stride + e / nw, Dp + e);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  PursuitDict<STAGED> D;
  if constexpr (STAGED) {
    D.s = Ds;
    D.stride = stride;
  } else {
    D.g = Dp;
    D.nw = nw;
  }
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the row's group
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane - gl);
  for (;;) {
    unsigned long long r = 0;
    if (gl == 0) r = atomicAdd(ctr, 1ULL);
    r = __shfl_sync(mask, r, 0, G);
    if (r >= (unsigned long long)N) break;
    const size_t row = (size_t)r;
    uint32_t* er = Ep + row * nw;
    int8_t* ar = A + row * K;
    int w = 0, p = 0, flips = 0;
    if constexpr (NWR > 0) {
      uint32_t e[NWR];
#pragma unroll
      for (int q = 0; q < NWR; ++q) {
        e[q] = q < nw ? er[q] : 0u;
        w += __popc(e[q]);
      }
      while (p < max_flips) {
        ++p;
        uint32_t best = 0xffffffffu;
        for (int k = gl; k < K; k += G) {
          int d = 0;
#pragma unroll
          for (int q = 0; q < NWR; ++q)
            if (q < nw) d += __popc(e[q] ^ D(q, k));
          best = min(best, ((uint32_t)d << 16) | (uint32_t)k);
        }
        best = __reduce_min_sync(mask, best);
        const int bd = (int)(best >> 16), bk = (int)(best & 0xffffu);
        if (bd >= w) break;
#pragma unroll
        for (int q = 0; q < NWR; ++q)
          if (q < nw) e[q] ^= D(q, bk);
        if (gl == 0) ar[bk] ^= 1;
        w = bd;
        ++flips;
      }
      if (flips) {
#pragma unroll
        for (int q = 0; q < NWR; ++q)
          if (q < nw && q % G == gl) er[q] = e[q];
      }
    } else {
      unsigned s = 0;
      for (int q = gl; q < nw; q += G) s += __popc(er[q]);
      w = (int)__reduce_add_sync(mask, s);
      while (p < max_flips) {
        ++p;
        unsigned long long best = ~0ULL;
        for (int k = gl; k < K; k += G) {
          int d = 0;
          for (int q = 0; q < nw; ++q) d += __popc(er[q] ^ D(q, k));
          best = min(best, ((unsigned long long)d << 32) | (unsigned)k);
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          best = min(best, __shfl_xor_sync(mask, best, o));
        const int bd = (int)(best >> 32), bk = (int)(best & 0xffffffffu);
        if (bd >= w) break;
        for (int q = gl; q < nw; q += G) er[q] ^= D(q, bk);
        __syncwarp(mask);
        if (gl == 0) ar[bk] ^= 1;
        w = bd;
        ++flips;
      }
    }
    if (gl == 0) {
      passes[row] = p;
      if (flips) atomicAdd(ctr + 1, 1ULL);
    }
  }
}

template <int G, int NWR, bool STAGED>
int pursuit_launch(void* Ep, const void* Dp, void* A, void* passes, void* ctr,
                   int N, int K, int nw, int max_flips, int smem,
                   cudaStream_t stream) {
  auto kern = packed_pursuit_kernel<G, NWR, STAGED>;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kPursuitThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int rows_per_block = kPursuitThreads / G;
  const long long want = ((long long)N + rows_per_block - 1) / rows_per_block;
  const int blocks = (int)(want < (long long)per_sm * sms
                               ? want
                               : (long long)per_sm * sms);
  if ((err = cudaMemsetAsync(ctr, 0, 2 * sizeof(unsigned long long),
                             stream)) != cudaSuccess)
    return (int)err;
  kern<<<blocks, kPursuitThreads, smem, stream>>>(
      (uint32_t*)Ep, (const uint32_t*)Dp, (int8_t*)A, (int32_t*)passes,
      (unsigned long long*)ctr, N, K, nw, max_flips, pursuit_stride(K));
  return (int)cudaGetLastError();
}

template <int G, bool STAGED>
int pursuit_by_width(void* Ep, const void* Dp, void* A, void* passes,
                     void* ctr, int N, int K, int nw, int max_flips, int smem,
                     cudaStream_t s) {
  // a row of up to 16 words in registers with a 32-bit key (d <= 512,
  // k < 65,536); anything else in place with a 64-bit key
  const bool regs = K <= 65536;
  if (regs && nw <= 2)
    return pursuit_launch<G, 2, STAGED>(Ep, Dp, A, passes, ctr, N, K, nw,
                                        max_flips, smem, s);
  if (regs && nw <= 4)
    return pursuit_launch<G, 4, STAGED>(Ep, Dp, A, passes, ctr, N, K, nw,
                                        max_flips, smem, s);
  if (regs && nw <= 8)
    return pursuit_launch<G, 8, STAGED>(Ep, Dp, A, passes, ctr, N, K, nw,
                                        max_flips, smem, s);
  if (regs && nw <= 16)
    return pursuit_launch<G, 16, STAGED>(Ep, Dp, A, passes, ctr, N, K, nw,
                                         max_flips, smem, s);
  return pursuit_launch<G, 0, STAGED>(Ep, Dp, A, passes, ctr, N, K, nw,
                                      max_flips, smem, s);
}

// stage: 1 stages D in shared memory, 0 reads it from device memory, -1
// stages it when it takes at most kStageMax bytes.  Returns a CUDA error
// code (cudaErrorInvalidValue for a dictionary that cannot be staged).
template <int G>
int packed_pursuit(void* Ep, const void* Dp, void* A, void* passes,
                   void* ctr, int N, int K, int nw, int max_flips, int stage,
                   void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (K <= 0 || nw <= 0) return (int)cudaErrorInvalidValue;
  const long long bytes = 4LL * nw * pursuit_stride(K);
  if (stage < 0) stage = bytes <= kStageMax;
  if (stage && bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return stage ? pursuit_by_width<G, true>(Ep, Dp, A, passes, ctr, N, K, nw,
                                           max_flips, (int)bytes, s)
               : pursuit_by_width<G, false>(Ep, Dp, A, passes, ctr, N, K,
                                            nw, max_flips, 0, s);
}

}  // namespace bic
