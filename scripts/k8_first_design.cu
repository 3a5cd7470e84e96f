// The first design of kernel K8 (five kernels a call: chunk ends, their
// max-scan, chunk maps walked by a warp per 64-word chunk with a per-block
// loop a run, a one-warp scan of the blocks a plane, and a thread per chunk
// writing its codes), kept as it shipped so that scripts/k8_variants.py
// times the design in binary_image_compression_tpu_torch/csrc/eg_encode.cu
// against it, kernel by kernel, in one call.  Its note follows.
//
// K8: codec 10's adaptive exp-Golomb run coder, on packed MED residuals.
//
// Replaces binary_image_compression_tpu/ops/egdevice.py::eg_encode_runs_device
// (:106): a fori_loop of per-run 32-state transition maps, an
// associative_scan of their composition and pack_varlen, over a run array
// made by jnp.nonzero.  Plain version: ops/egdevice.py::eg_encode_plain.
//
// The coder (native bic_eg_encode_runs) codes each zero run of the residual
// in raster order as a '1' per full block of its LUT state (state + 1 each)
// then '0' and a g-bit remainder (state - 1).  A run's code depends on the
// state it enters with, which depends on every run before it; but the state
// is one of 32, so a stretch of runs is a map state -> state, and maps
// compose.
//
// What bounds it: the bytes are small (the packed residual read, the payload
// written: ~2.5 us for 8 letter-page planes at 3.35 TB/s); the work is a
// walk over the runs that is serial within a chunk, so the kernel is bound
// by how many chunks walk at once and by the longest chunk's walk.
//
// Design (five kernels on the stream, one call):
//   1. k8_chunk_last: a warp per chunk of 64 words (lane j: words j, j + 32)
//      finds the flat position of the chunk's last set bit (-1 if none).
//   2. k8_prev_scan: a block per plane, an exclusive max-scan of those:
//      prev[c], the last one before chunk c, which fixes the length of the
//      chunk's first run.  No run array and no host sync.
//   3. k8_chunk_maps: a warp per chunk; the ones of the chunk are visited in
//      order (ballot over nonzero words, clz within a word) by every lane,
//      lane s coding each run from entry state s: the chunk's map and its
//      code length from each state.  Warp 0 of the block composes its 8
//      chunks' (map, length) pairs in shared memory: each chunk's prefix
//      from the block's entry state, and the block's pair.
//   4. k8_block_scan: a warp per plane composes the blocks' pairs in order,
//      lane s holding map[s]: a composition is one __shfl_sync(map, state).
//      It gives each block's entry state and bit offset, and the plane's
//      bit count.
//   5. k8_emit: a thread per chunk takes its entry state and bit offset from
//      its block's and its prefix, walks its chunk again from that state and
//      writes the codes MSB-first through a 64-bit accumulator, OR-ing whole
//      words into the zeroed payload (atomicOr: a chunk's first and last
//      words are shared with its neighbours).
// The first run of a plane is coded from the constructor's state (g = 1,
// block 1): a map that is the same from every state.  The last chunk codes
// the trailing zero run.  Codes past the payload buffer are dropped (the
// caller raises; EG stays well under the buffer's 4 bits a pixel).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunkWords = 64;
constexpr int kChunksPerBlock = 8;
constexpr int kEmitThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

// EGLUT[s] (eg.cpp:2): 0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,5,5,6,6,7,7,8..15
__device__ __forceinline__ int eg_g(int s) {
  return s < 16 ? s >> 2 : (s < 24 ? (s >> 1) - 4 : s - 16);
}

struct Code {
  int exit, nb, g, rem;
};

// A run of L zeros coded from LUT state s (native EGState); `first`: the
// plane's first run, from the constructor's g = 1, block = 1.
__device__ __forceinline__ Code eg_run(int L, int s, bool first) {
  Code c;
  c.nb = 0;
  if (first) {
    if (L == 0) {
      c.exit = 0;
      c.g = 1;
      c.rem = 0;
      return c;
    }
    L -= 1;
    c.nb = 1;
    s = 1;
  }
  int g = eg_g(s);
  while (L >= (1 << g)) {
    L -= 1 << g;
    ++c.nb;
    if (s < 31) ++s;
    g = eg_g(s);
  }
  c.g = g;
  c.rem = L;
  c.exit = s > 0 ? s - 1 : 0;
  return c;
}

// flat pixel index of bit 0 (the MSB) of word gi of a plane
__device__ __forceinline__ int word_base(long long gi, int nw, int cols) {
  int r = static_cast<int>(gi / nw);
  return r * cols + static_cast<int>(gi - static_cast<long long>(r) * nw) * 32;
}

__device__ __forceinline__ uint32_t load_word(const uint32_t* plane,
                                              long long gi, long long nwp) {
  return gi < nwp ? plane[gi] : 0u;
}

__global__ void k8_chunk_last(const uint32_t* __restrict__ res,
                              int* __restrict__ last, int nwp, int nw,
                              int cols, int NC) {
  const int p = blockIdx.y, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kChunksPerBlock + (threadIdx.x >> 5);
  if (c >= NC) return;
  const uint32_t* plane = res + static_cast<size_t>(p) * nwp;
  const long long gi0 = static_cast<long long>(c) * kChunkWords;
  const uint32_t w0 = load_word(plane, gi0 + lane, nwp);
  const uint32_t w1 = load_word(plane, gi0 + 32 + lane, nwp);
  const unsigned m0 = __ballot_sync(kFull, w0 != 0);
  const unsigned m1 = __ballot_sync(kFull, w1 != 0);
  int pos = -1;
  if (m0 | m1) {
    const int k = m1 ? 63 - __clz(m1) : 31 - __clz(m0);
    const uint32_t w = __shfl_sync(kFull, k >= 32 ? w1 : w0, k & 31);
    pos = word_base(gi0 + k, nw, cols) + 32 - __ffs(w);
  }
  if (lane == 0) last[static_cast<size_t>(p) * NC + c] = pos;
}

__global__ void k8_prev_scan(const int* __restrict__ last,
                             int* __restrict__ prev, int NC) {
  __shared__ int wmax[32];
  const int p = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* in = last + static_cast<size_t>(p) * NC;
  int* out = prev + static_cast<size_t>(p) * NC;
  int carry = -1;
  for (int base = 0; base < NC; base += blockDim.x) {
    const int c = base + threadIdx.x;
    const int v = c < NC ? in[c] : -1;
    int x = v;  // inclusive max over the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = max(x, y);
    }
    int before = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) before = -1;
    if (lane == 31) wmax[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = lane < static_cast<int>(blockDim.x >> 5) ? wmax[lane] : -1;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t = max(t, y);
      }
      wmax[lane] = t;
    }
    __syncthreads();
    const int wbefore = warp ? wmax[warp - 1] : -1;
    if (c < NC) out[c] = max(carry, max(wbefore, before));
    carry = max(carry, wmax[(blockDim.x >> 5) - 1]);
    __syncthreads();
  }
}

__global__ void k8_chunk_maps(const uint32_t* __restrict__ res,
                              const int* __restrict__ prev,
                              int* __restrict__ pmap, int* __restrict__ plen,
                              int* __restrict__ bmap, int* __restrict__ blen,
                              int nwp, int nw, int cols, int n, int NC,
                              int NB) {
  __shared__ int sm[kChunksPerBlock][32], sl[kChunksPerBlock][32];
  const int p = blockIdx.y, b = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = b * kChunksPerBlock + warp;
  int s = lane, bits = 0;  // lane s: the chunk entered at state s
  if (c < NC) {
    const uint32_t* plane = res + static_cast<size_t>(p) * nwp;
    const long long gi0 = static_cast<long long>(c) * kChunkWords;
    const uint32_t w0 = load_word(plane, gi0 + lane, nwp);
    const uint32_t w1 = load_word(plane, gi0 + 32 + lane, nwp);
    int pv = prev[static_cast<size_t>(p) * NC + c];
    for (int h = 0; h < 2; ++h) {
      const uint32_t mine = h ? w1 : w0;
      unsigned m = __ballot_sync(kFull, mine != 0);
      while (m) {  // warp-uniform: every lane visits the same ones
        const int k = __ffs(m) - 1;
        m &= m - 1;
        uint32_t w = __shfl_sync(kFull, mine, k);
        const int base = word_base(gi0 + 32 * h + k, nw, cols);
        while (w) {
          const int bit = __clz(w);
          w &= ~(0x80000000u >> bit);
          const int pos = base + bit;
          const Code cd = eg_run(pos - pv - 1, s, pv < 0);
          s = cd.exit;
          bits += cd.nb + 1 + cd.g;
          pv = pos;
        }
      }
    }
    if (c == NC - 1 && n - 1 - pv > 0) {  // the trailing zero run
      const Code cd = eg_run(n - 1 - pv, s, pv < 0);
      s = cd.exit;
      bits += cd.nb + 1 + cd.g;
    }
  }
  sm[warp][lane] = s;
  sl[warp][lane] = bits;
  __syncthreads();
  if (warp == 0) {
    int st = lane, ln = 0;  // from the block's entry state `lane`
    for (int i = 0; i < kChunksPerBlock; ++i) {
      const int ci = b * kChunksPerBlock + i;
      if (ci < NC) {
        const size_t o = (static_cast<size_t>(p) * NC + ci) * 32 + lane;
        pmap[o] = st;
        plen[o] = ln;
      }
      ln += sl[i][st];
      st = sm[i][st];
    }
    const size_t o = (static_cast<size_t>(p) * NB + b) * 32 + lane;
    bmap[o] = st;
    blen[o] = ln;
  }
}

__global__ void k8_block_scan(const int* __restrict__ bmap,
                              const int* __restrict__ blen,
                              int* __restrict__ bent,
                              long long* __restrict__ boff,
                              long long* __restrict__ nbits, int NB) {
  const int p = blockIdx.x, lane = threadIdx.x;
  const int* M = bmap + static_cast<size_t>(p) * NB * 32;
  const int* L = blen + static_cast<size_t>(p) * NB * 32;
  int st = 0;  // any: blocks before the first run are the identity
  long long off = 0;
  int m = M[lane], l = L[lane];
  for (int b = 0; b < NB; ++b) {
    int mn = 0, ln = 0;
    if (b + 1 < NB) {  // the next block's pair, loaded ahead
      mn = M[(b + 1) * 32 + lane];
      ln = L[(b + 1) * 32 + lane];
    }
    if (lane == 0) {
      bent[static_cast<size_t>(p) * NB + b] = st;
      boff[static_cast<size_t>(p) * NB + b] = off;
    }
    off += __shfl_sync(kFull, l, st);
    st = __shfl_sync(kFull, m, st);
    m = mn;
    l = ln;
  }
  if (lane == 0) nbits[p] = off;
}

// MSB-first bit writer into a zeroed word buffer; the first and last words
// may be shared with other writers, so words are OR-ed atomically.
struct BitWriter {
  uint32_t* out;
  long long cap, word;
  unsigned long long acc;
  int n;  // bits held in acc (the first word's leading bits count as 0s)

  __device__ BitWriter(uint32_t* o, long long cap_words, long long bitpos)
      : out(o), cap(cap_words), word(bitpos >> 5), acc(0),
        n(static_cast<int>(bitpos & 31)) {}

  __device__ __forceinline__ void emit(uint32_t v) {
    if (v && word < cap) atomicOr(out + word, v);
    ++word;
  }
  // len in 1..32, v < 2^len
  __device__ __forceinline__ void put(uint32_t v, int len) {
    acc = (acc << len) | v;
    n += len;
    if (n >= 32) {
      n -= 32;
      emit(static_cast<uint32_t>(acc >> n));
      acc &= (1ull << n) - 1;
    }
  }
  __device__ __forceinline__ void code(const Code& cd) {
    int k = cd.nb;
    for (; k >= 32; k -= 32) put(kFull, 32);
    if (k) put((1u << k) - 1, k);
    put(static_cast<uint32_t>(cd.rem), cd.g + 1);  // '0' + g-bit remainder
  }
  __device__ __forceinline__ void flush() {
    if (n) emit(static_cast<uint32_t>(acc << (32 - n)));
  }
};

__global__ void k8_emit(const uint32_t* __restrict__ res,
                        const int* __restrict__ prev,
                        const int* __restrict__ pmap,
                        const int* __restrict__ plen,
                        const int* __restrict__ bent,
                        const long long* __restrict__ boff,
                        uint32_t* __restrict__ words, int nwp, int nw,
                        int cols, int n, int NC, int NB, int TW) {
  const int p = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= NC) return;
  const int b = c / kChunksPerBlock;
  const int e = bent[static_cast<size_t>(p) * NB + b];
  const size_t o = (static_cast<size_t>(p) * NC + c) * 32 + e;
  int s = pmap[o];
  BitWriter bw(words + static_cast<size_t>(p) * TW, TW,
               boff[static_cast<size_t>(p) * NB + b] + plen[o]);
  int pv = prev[static_cast<size_t>(p) * NC + c];
  const uint32_t* plane = res + static_cast<size_t>(p) * nwp;
  const long long gi0 = static_cast<long long>(c) * kChunkWords;
  const int kend = static_cast<int>(
      min(static_cast<long long>(kChunkWords), nwp - gi0));
  for (int k = 0; k < kend; ++k) {
    uint32_t w = plane[gi0 + k];
    if (!w) continue;
    const int base = word_base(gi0 + k, nw, cols);
    while (w) {
      const int bit = __clz(w);
      w &= ~(0x80000000u >> bit);
      const int pos = base + bit;
      const Code cd = eg_run(pos - pv - 1, s, pv < 0);
      bw.code(cd);
      s = cd.exit;
      pv = pos;
    }
  }
  if (c == NC - 1 && n - 1 - pv > 0) bw.code(eg_run(n - 1 - pv, s, pv < 0));
  bw.flush();
}

}  // namespace

// res: uint32 [P, rows, nw] packed residuals; words: zeroed uint32 [P, TW];
// nbits: int64 [P].  Scratch: last, prev int32 [P, NC]; pmap, plen int32
// [P, NC, 32]; bmap, blen int32 [P, NB, 32]; bent int32 [P, NB]; boff int64
// [P, NB].  NC = ceil(rows * nw / 64) chunks, NB = ceil(NC / 8) blocks.
extern "C" int bic_eg_encode(const void* res, void* last, void* prev,
                             void* pmap, void* plen, void* bmap, void* blen,
                             void* bent, void* boff, void* words, void* nbits,
                             int P, int rows, int cols, int nw, int NC, int NB,
                             int TW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nwp = rows * nw, n = rows * cols;
  const auto* r = static_cast<const uint32_t*>(res);
  k8_chunk_last<<<dim3((NC + kChunksPerBlock - 1) / kChunksPerBlock, P),
                  32 * kChunksPerBlock, 0, st>>>(
      r, static_cast<int*>(last), nwp, nw, cols, NC);
  k8_prev_scan<<<P, 1024, 0, st>>>(static_cast<const int*>(last),
                                   static_cast<int*>(prev), NC);
  k8_chunk_maps<<<dim3(NB, P), 32 * kChunksPerBlock, 0, st>>>(
      r, static_cast<const int*>(prev), static_cast<int*>(pmap),
      static_cast<int*>(plen), static_cast<int*>(bmap),
      static_cast<int*>(blen), nwp, nw, cols, n, NC, NB);
  k8_block_scan<<<P, 32, 0, st>>>(
      static_cast<const int*>(bmap), static_cast<const int*>(blen),
      static_cast<int*>(bent), static_cast<long long*>(boff),
      static_cast<long long*>(nbits), NB);
  k8_emit<<<dim3((NC + kEmitThreads - 1) / kEmitThreads, P), kEmitThreads, 0,
            st>>>(r, static_cast<const int*>(prev),
                  static_cast<const int*>(pmap),
                  static_cast<const int*>(plen),
                  static_cast<const int*>(bent),
                  static_cast<const long long*>(boff),
                  static_cast<uint32_t*>(words), nwp, nw, cols, n, NC, NB,
                  TW);
  return static_cast<int>(cudaGetLastError());
}
