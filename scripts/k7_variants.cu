// Variants of kernel K7 (binary_image_compression_tpu_torch/csrc/
// rans_encode.cu), built by scripts/k7_variants.py with -D switches to
// find where a step's clocks go.  With every switch at its default this is
// K7 itself; K7_DIV=1 and K7_EMIT=0 give wrong streams and exist only to
// time what they leave out.
//   K7_CHUNK  steps whose inputs are loaded together (default 8)
//   K7_DIV    0: x / f; 1: x >> 12 (timing only); 2: an exact reciprocal
//             table, q = __umul64hi(x, floor((2^64 - 1) / f) + 1), built in
//             shared memory by each block
//   K7_EMIT   1: the ballot, positions and stores; 0: none (timing only)
//   K7_IDX64  1: 64-bit pixel and buffer indices; 0: 32-bit

#ifndef K7_CHUNK
#define K7_CHUNK 8
#endif
#ifndef K7_DIV
#define K7_DIV 0
#endif
#ifndef K7_EMIT
#define K7_EMIT 1
#endif
#ifndef K7_IDX64
#define K7_IDX64 1
#endif

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#if K7_IDX64
typedef long long idx_t;
#else
typedef int idx_t;
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kScale = 4096;  // freqs sum to 2^12
constexpr int kChunk = K7_CHUNK;   // steps whose inputs are loaded together
constexpr int kMaxWarps = 8;       // 255 lanes at most (a u8 field)
constexpr uint8_t kPad = 2;        // a bit value that marks the no-op pad

struct Chunk {
  uint16_t ctx[kChunk];
  uint8_t bit[kChunk];
};

// The bits and contexts of steps chunk*kChunk .. +kChunk-1 of lane l.
__device__ __forceinline__ void load_chunk(Chunk& c,
                                           const uint8_t* __restrict__ bits,
                                           const uint16_t* __restrict__ ctx,
                                           idx_t chunk, int l,
                                           int n_lanes, idx_t n_real) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const idx_t i = (chunk * kChunk + u) * n_lanes + l;
    const bool real = l < n_lanes && i < n_real;
    c.bit[u] = real ? bits[i] : kPad;
    c.ctx[u] = real ? ctx[i] : 0;
  }
}

template <bool kOneWarp>
__global__ void __launch_bounds__(kMaxWarps * 32)
rans_variant_kernel(const uint8_t* __restrict__ bits,
                   const uint16_t* __restrict__ ctx,
                   const uint16_t* __restrict__ p_used,
                   uint16_t* __restrict__ scratch,
                   uint32_t* __restrict__ states, uint32_t* __restrict__ words,
                   long long* __restrict__ nbits, int rows, int cols,
                   int n_stripes, int stripe_rows, int steps, int n_lanes) {
  __shared__ uint16_t table[kScale];
  __shared__ int emitted[2][kMaxWarps];
  const int blk = blockIdx.x;  // page * n_stripes + stripe
  const int page = blk / n_stripes, s = blk % n_stripes;
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = l; i < (int)kScale; i += blockDim.x)
    table[i] = p_used[(long long)page * kScale + i];
  __syncthreads();

#if K7_DIV == 2
  __shared__ unsigned long long rcp[kScale + 1];
  for (int i = l + 2; i <= (int)kScale; i += blockDim.x)
    rcp[i] = ~0ull / (unsigned)i + 1;
  __syncthreads();
#endif
  const idx_t npix = (idx_t)rows * cols;
  const idx_t first = (idx_t)s * stripe_rows * cols;
  const idx_t n_real = min((idx_t)stripe_rows * cols, npix - first);
  const uint8_t* sb = bits + page * npix + first;
  const uint16_t* sc = ctx + page * npix + first;
  const idx_t cap = (idx_t)steps * n_lanes;  // >= one word a pixel
  uint16_t* buf = scratch + (long long)blk * cap;

  uint32_t x = 1u << 16;
  idx_t cnt = 0;  // words the block has emitted so far
  const idx_t n_chunks = (steps + kChunk - 1) / kChunk;
  Chunk next;
  load_chunk(next, sb, sc, n_chunks - 1, l, n_lanes, n_real);
  for (idx_t k = n_chunks - 1; k >= 0; --k) {
    const Chunk cur = next;
    if (k > 0) load_chunk(next, sb, sc, k - 1, l, n_lanes, n_real);
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      // steps past `steps` (the top chunk's tail) are pads: no-ops
      uint32_t f = kScale, b = 0;
      if (cur.bit[u] != kPad) {
        const uint32_t p1 = table[cur.ctx[u]], f0 = kScale - p1;
        f = cur.bit[u] ? p1 : f0;
        b = cur.bit[u] ? f0 : 0u;
      }
      const bool need = (x >> 20) >= f;  // x >= f << 20, safe at f = 4096
#if K7_EMIT
      const unsigned ball = __ballot_sync(kFull, need);
      idx_t pos = cnt + __popc(ball >> lane);
      int here = __popc(ball);
      if (!kOneWarp) {
        int* slot = emitted[u & 1];
        if (lane == 0) slot[warp] = here;
        __syncthreads();
        here = 0;
        for (int w = 0; w < nwarps; ++w) {
          const int e = slot[w];
          here += e;
          pos += w > warp ? e : 0;
        }
      }
      if (need) buf[cap - pos] = (uint16_t)(x & 0xFFFFu);
      cnt += here;
#endif
      x = need ? x >> 16 : x;
#if K7_DIV == 0
      const uint32_t q = x / f;
#elif K7_DIV == 1
      const uint32_t q = x >> 12;
#else
      const uint32_t q = f == 1 ? x : (uint32_t)__umul64hi(x, rcp[f]);
#endif
      x = (q << 12) + (x - q * f) + b;
    }
  }
  if (l < n_lanes) states[(long long)blk * n_lanes + l] = x;

  // the stream is buf[cap - cnt, cap): MSB-first 32-bit words
  __syncthreads();
  const uint16_t* src = buf + (cap - cnt);
  uint32_t* dst = words + (long long)blk * ((cap + 1) >> 1);
  for (idx_t j = l; j < (cnt + 1) >> 1; j += blockDim.x) {
    const uint32_t hi = src[2 * j];
    const uint32_t lo = 2 * j + 1 < cnt ? src[2 * j + 1] : 0u;
    dst[j] = hi << 16 | lo;
  }
  if (l == 0) nbits[blk] = 16 * cnt;
}

}  // namespace

// bits: uint8 0/1 [B, rows, cols]; ctx: uint16 [B, rows, cols]; p_used:
// uint16 [B, 4096]; scratch: uint16 [B * n_stripes, steps * n_lanes];
// states: uint32 [B * n_stripes, n_lanes]; words: uint32 [B * n_stripes,
// ceil(steps * n_lanes / 2)], zeroed by the caller; nbits: int64
// [B * n_stripes].  Launches on `stream`, returns cudaGetLastError().
extern "C" int bic_rans_variant(const void* bits, const void* ctx,
                               const void* p_used, void* scratch,
                               void* states, void* words, void* nbits, int B,
                               int rows, int cols, int n_stripes,
                               int stripe_rows, int steps, int n_lanes,
                               void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (rows < 1 || cols < 1 || n_lanes < 1 || n_lanes > 255 ||
      stripe_rows < 1 || n_stripes < 1 ||
      (long long)(n_stripes - 1) * stripe_rows >= rows ||
      (long long)n_stripes * stripe_rows < rows ||
      (long long)steps * n_lanes < (long long)stripe_rows * cols)
    return (int)cudaErrorInvalidValue;
  const int threads = (n_lanes + 31) / 32 * 32;
  auto* kernel = threads == 32 ? rans_variant_kernel<true>
                               : rans_variant_kernel<false>;
  kernel<<<B * n_stripes, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const uint16_t*)ctx, (const uint16_t*)p_used,
      (uint16_t*)scratch, (uint32_t*)states, (uint32_t*)words,
      (long long*)nbits, rows, cols, n_stripes, stripe_rows, steps, n_lanes);
  return (int)cudaGetLastError();
}
