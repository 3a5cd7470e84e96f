// The first design of kernel K7 (a thread per lane loading its own inputs a
// chunk of 8 steps ahead, the compiler's divide, a ballot and a position per
// step), kept as it shipped so that scripts/k7_variants.py times the
// design in binary_image_compression_tpu_torch/csrc/rans_encode.cu against
// it in one call.  Its note follows.
//
// Kernel K7: codec 13's interleaved-rANS encode (payload mode 2), one block
// per stripe, writing each stripe's word stream itself.
//
// Replaces: binary_image_compression_tpu/ops/ransdevice.py::rans_encode_scan
//           (a lax.scan, not Pallas) and the stream packing after it
//           (pack_stream_words -> bitstream.pack_varlen over [steps, S, N]
//           words and flags).
//
// What it computes, per stripe of `stripe_rows` rows (the last one may be
// short) of each page: N = n_lanes interleaved 32-bit rANS states, lane l
// coding pixels t*N + l of the stripe for t = steps-1 down to 0, from
// x = 2^16.  A pixel's (f, b) comes from its bit and the table p_used
// (P(bit == 1) * 4096 per context): bit 1 -> (p1, 4096 - p1), bit 0 ->
// (4096 - p1, 0); pixels past the stripe's real pixels are the exact no-op
// (f = 4096, b = 0).  A step: if (x >> 20) >= f, emit x & 0xFFFF and
// x >>= 16; then x = ((x / f) << 12) + x % f + b.  Outputs: each lane's final
// x (the decoder's initial state), the emitted 16-bit words in ascending
// (step, lane) order as MSB-first 32-bit words, and the stream's bit count.
// Every value is an exact integer; there is no rounding to match.
//
// What bounds it on the H100: the chain.  A lane's steps are dependent
// (compare, select, a 32-bit divide, a multiply-add: utils/roofline.py::
// rans_work's chain floor), and a stripe has at most 255 lanes, so a
// 512x512 page (4 stripes x 32 lanes) is 128 threads walking 2,048 steps.
// Its bytes (3 per pixel in, at most 2 out) are nothing to the card.
//
// What the design does about it: nothing leaves the chain but the chain.
// Each lane loads its pixels' bits and contexts a chunk of kChunk steps
// ahead (independent of x), looks f and b up in the 8 KB table in shared
// memory, and emits by one ballot: its word goes to the stripe's scratch
// buffer at cap - (words emitted so far + emitting lanes at or above it),
// so the buffer's tail is the stream in order.  With more than 32 lanes
// the warps' counts meet in shared memory, one barrier per step (two
// slots, alternating).  At the end the block turns the tail into MSB-first
// 32-bit words.  No [steps, S, N] arrays are built.  The divide stays a
// divide (an exact reciprocal table is a later design).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kScale = 4096;  // freqs sum to 2^12
constexpr int kChunk = 8;          // steps whose inputs are loaded together
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
                                           long long chunk, int l,
                                           int n_lanes, long long n_real) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const long long i = (chunk * kChunk + u) * n_lanes + l;
    const bool real = l < n_lanes && i < n_real;
    c.bit[u] = real ? bits[i] : kPad;
    c.ctx[u] = real ? ctx[i] : 0;
  }
}

template <bool kOneWarp>
__global__ void __launch_bounds__(kMaxWarps * 32)
rans_encode_kernel(const uint8_t* __restrict__ bits,
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

  const long long npix = (long long)rows * cols;
  const long long first = (long long)s * stripe_rows * cols;
  const long long n_real = min((long long)stripe_rows * cols, npix - first);
  const uint8_t* sb = bits + page * npix + first;
  const uint16_t* sc = ctx + page * npix + first;
  const long long cap = (long long)steps * n_lanes;  // >= one word a pixel
  uint16_t* buf = scratch + (long long)blk * cap;

  uint32_t x = 1u << 16;
  long long cnt = 0;  // words the block has emitted so far
  const long long n_chunks = (steps + kChunk - 1) / kChunk;
  Chunk next;
  load_chunk(next, sb, sc, n_chunks - 1, l, n_lanes, n_real);
  for (long long k = n_chunks - 1; k >= 0; --k) {
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
      const unsigned ball = __ballot_sync(kFull, need);
      long long pos = cnt + __popc(ball >> lane);
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
      x = need ? x >> 16 : x;
      const uint32_t q = x / f;
      x = (q << 12) + (x - q * f) + b;
    }
  }
  if (l < n_lanes) states[(long long)blk * n_lanes + l] = x;

  // the stream is buf[cap - cnt, cap): MSB-first 32-bit words
  __syncthreads();
  const uint16_t* src = buf + (cap - cnt);
  uint32_t* dst = words + (long long)blk * ((cap + 1) >> 1);
  for (long long j = l; j < (cnt + 1) >> 1; j += blockDim.x) {
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
extern "C" int bic_rans_encode(const void* bits, const void* ctx,
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
  auto* kernel = threads == 32 ? rans_encode_kernel<true>
                               : rans_encode_kernel<false>;
  kernel<<<B * n_stripes, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const uint16_t*)ctx, (const uint16_t*)p_used,
      (uint16_t*)scratch, (uint32_t*)states, (uint32_t*)words,
      (long long*)nbits, rows, cols, n_stripes, stripe_rows, steps, n_lanes);
  return (int)cudaGetLastError();
}
