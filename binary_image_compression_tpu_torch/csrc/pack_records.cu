// K9: codec 8's decided tile records packed into the BIC1 payload.
//
// Replaces no TPU kernel.  The JAX package fetches the record block and
// packs it on the host (native bic_pack_tiles, native/bic_native.cpp:467),
// as the port did; K9 writes the same bits where the block already is.
// Plain version: ops/recpack.py::pack_records_plain.
//
// What it computes, for each page of a decided record block int32 [B, T,
// 2 + nw] (models/compress.py::_record_block: the header word, the rank, the
// chosen residual's words), the bits bic_pack_tiles writes after the
// header, MSB-first, tile by tile in raster order:
//   modes 0/1: '1', m & 1, inv, the rank in idx_len bits; modes 2/3: '0',
//   m & 1;
//   the Golomb code of the weight w with k = k_used: the low k bits, w >> k
//   zeros, a '1';
//   the enumerative rank of the residual in enb[w] bits: the sum, over its
//   zero positions q while rem > 0, of C(M - 1 - q, rem - 1), where rem is
//   w less the ones before q (enum_rank_tab's walk; rem is the number of
//   ones at or after q).
// Pages sit back to back in one buffer, each from a word, each word
// byte-swapped so that the buffer's bytes are the stream.  Each page's bit
// count, or -1 where a weight lies outside [0, M] (nothing of that page is
// written).
//
// What bounds it: bytes.  The block is read once (40 B a tile at W = 16),
// the payload written once (~17 B a tile on a fax page), the binomial table
// (M (M + 1) / 2 entries of 32 B, 1.05 MB at M = 256) read from L2: a fax
// page is ~0.9 MB, ~0.3 us at 3.35 TB/s.  At one page K9 is latency-bound
// instead: a record's place is a prefix sum over the page, and a tile's
// rank a sum of up to 256 table entries of 8 limbs.
//
// What the design does about it (two kernels on the stream, one call):
//   1. k9_offsets: a block of 1,024 threads per page.  A record's length
//      follows from its header word alone (prefix, idx_len, k + (w >> k) +
//      1, enb[w]), so each thread loads the header words of 16 tiles at once
//      (all in flight), sums their lengths, and one block scan gives every
//      tile's bit offset (a fax page is one such chunk) and the page's bit
//      count.  The last block to finish (a counter) scans the pages' word
//      counts into each page's first word.
//   2. k9_emit: a warp per tile, so a fax page is 16,092 warps in flight.
//      Lane l takes positions [l p, l p + p), p = ceil(M / 32) (8 at M =
//      256): its bits by shuffles of the residual's words, a warp scan of
//      their popcounts gives rem at each.  It adds the table's C(a, rem - 1)
//      of its zero positions, loads independent of each other, into 64-bit
//      accumulators of 32-bit limbs, only the ceil(enb[w] / 32) limbs the
//      rank can have (none for weight 0 or M); a butterfly of shuffles sums
//      the lanes and a carry pass gives the rank's limbs in every lane.
//      Then lane j composes the j-th output word the record touches (at most
//      19) from its segments by shifts alone.  A word the record covers
//      whole is stored; the first and last, which neighbours share, are
//      OR-ed in atomically.  The buffer comes zeroed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxM = 256;          // the binomial table's reach
constexpr int kLimbs = 8;           // 32-bit limbs: C(255, 127) < 2^252
constexpr int kScanThreads = 1024;  // k9_offsets: a page's block
constexpr int kItems = 16;          // k9_offsets: tiles a thread, a chunk
constexpr int kEmitWarps = 8;       // k9_emit: tiles a block

struct Head {
  int mode, inv, k, il, w;
};

__device__ __forceinline__ Head split(int h) {
  Head r;
  r.mode = h & 3;
  r.inv = (h >> 2) & 1;
  r.k = (h >> 3) & 31;
  r.il = (h >> 8) & 63;
  r.w = h >> 14;
  return r;
}

// bits before the Golomb code: '1' m inv and the rank, or '0' m
__device__ __forceinline__ int prefix_bits(const Head& r) {
  return r.mode < 2 ? 3 + r.il : 2;
}

// the record's length in bits, -1 for a weight outside [0, M]
__device__ __forceinline__ int record_bits(const Head& r, const int* enb,
                                           int M) {
  if (r.w < 0 || r.w > M) return -1;
  return prefix_bits(r) + r.k + (r.w >> r.k) + 1 + enb[r.w];
}

// v, whose last bit lies at record position end - 1, as it falls into the
// 32-bit window of record positions [pos, pos + 32), MSB first; v has no
// bits above its segment's length
__device__ __forceinline__ unsigned place(unsigned long long v, int end,
                                          int pos) {
  const int d = end - pos - 32;
  if (d >= 64 || d <= -32) return 0u;
  return d >= 0 ? static_cast<unsigned>(v >> d)
                : static_cast<unsigned>(v << -d);
}

// inclusive scan of a 1,024-thread block; `sums` holds 32 entries; returns
// the thread's inclusive sum, and the block's total in `total`
__device__ __forceinline__ long long block_scan(long long x, long long* sums,
                                                long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const long long out = x + (warp ? sums[warp - 1] : 0);
  total = sums[31];
  __syncthreads();  // sums is free again
  return out;
}

__global__ void __launch_bounds__(kScanThreads)
    k9_offsets(const int32_t* __restrict__ block,
               const int32_t* __restrict__ enb_g, long long* __restrict__ off,
               long long* __restrict__ nbits, long long* __restrict__ first,
               unsigned long long* __restrict__ done, int B, int T, int C,
               int M) {
  __shared__ int enb[kMaxM + 1];
  __shared__ long long sums[32];
  __shared__ int last;
  const int tid = threadIdx.x;
  for (int i = tid; i <= M; i += kScanThreads) enb[i] = enb_g[i];
  __syncthreads();
  const int b = blockIdx.x;
  const int32_t* page = block + static_cast<size_t>(b) * T * C;
  long long* po = off + static_cast<size_t>(b) * T;
  long long carry = 0;
  int bad = 0;
  for (long long t0 = 0; t0 < T; t0 += kScanThreads * kItems) {
    const long long t1 = t0 + static_cast<long long>(tid) * kItems;
    int len[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      len[i] = t1 + i < T ? record_bits(split(page[(t1 + i) * C]), enb, M)
                          : 0;
    long long mine = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      bad |= len[i] < 0;
      len[i] = len[i] < 0 ? 0 : len[i];
      mine += len[i];
    }
    long long total;
    long long pos = carry + block_scan(mine, sums, total) - mine;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (t1 + i < T) po[t1 + i] = pos;
      pos += len[i];
    }
    carry += total;
  }
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    nbits[b] = bad ? -1 : carry;
    __threadfence();
    last = atomicAdd(done, 1ull) == static_cast<unsigned long long>(B - 1);
  }
  __syncthreads();
  if (!last) return;
  // the last block: each page's first word, a scan of the pages' words
  __threadfence();
  const volatile long long* vb = nbits;
  long long base = 0;
  for (int p0 = 0; p0 < B; p0 += kScanThreads) {
    const int p = p0 + tid;
    long long n = 0;
    if (p < B) {
      const long long v = vb[p];
      n = v < 0 ? 0 : (v + 31) >> 5;
    }
    long long total;
    const long long incl = block_scan(n, sums, total);
    if (p < B) first[p] = base + incl - n;
    base += total;
  }
}

__global__ void __launch_bounds__(32 * kEmitWarps)
    k9_emit(const int32_t* __restrict__ block,
            const int32_t* __restrict__ enb, const uint4* __restrict__ binom,
            const long long* __restrict__ off,
            const long long* __restrict__ nbits,
            const long long* __restrict__ first, uint32_t* __restrict__ words,
            int T, int C, int nw, int M, int ppl, long long tiles) {
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * kEmitWarps + (threadIdx.x >> 5);
  if (g >= tiles) return;
  const long long b = g / T;
  if (nbits[b] < 0) return;
  const int v = lane < C ? block[g * C + lane] : 0;
  const Head r = split(__shfl_sync(kFull, v, 0));
  const int rank = __shfl_sync(kFull, v, 1);
  const int e = __ldg(enb + r.w);
  const int nl = (e + 31) >> 5;  // the rank's limbs (warp-uniform)
  unsigned limb[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) limb[j] = 0;
  if (nl > 0) {
    // the lane's positions q0 .. q0 + ppl - 1, the first at bit ppl - 1
    const int q0 = lane * ppl;
    unsigned mine = 0;
#pragma unroll
    for (int p = 0; p < kLimbs; ++p) {
      if (p < ppl) {
        const int q = q0 + p;
        const int src = 2 + min(q >> 5, nw - 1);
        const unsigned wv = static_cast<unsigned>(__shfl_sync(kFull, v, src));
        mine = mine << 1 | (q < M ? (wv >> (31 - (q & 31))) & 1u : 0u);
      }
    }
    const int cnt = __popc(mine);
    int incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int rem = r.w - (incl - cnt);
    unsigned long long acc[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) acc[j] = 0;
#pragma unroll
    for (int p = 0; p < kLimbs; ++p) {
      const int q = q0 + p;
      if (p < ppl && q < M) {
        const int a = M - 1 - q;
        if ((mine >> (ppl - 1 - p)) & 1u) {
          --rem;
        } else if (rem > 0 && rem - 1 <= a) {
          const uint4* c = binom + 2 * (static_cast<size_t>(a) * (a + 1) / 2 +
                                        rem - 1);
          const uint4 lo = __ldg(c);
          acc[0] += lo.x;
          acc[1] += lo.y;
          acc[2] += lo.z;
          acc[3] += lo.w;
          if (nl > 4) {
            const uint4 hi = __ldg(c + 1);
            acc[4] += hi.x;
            acc[5] += hi.y;
            acc[6] += hi.z;
            acc[7] += hi.w;
          }
        }
      }
    }
    unsigned long long carry = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      if (j < nl) {
        for (int d = 16; d; d >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], d);
        carry += acc[j];
        limb[j] = static_cast<unsigned>(carry);
        carry >>= 32;
      }
    }
    // the rank's low e bits (a weight unlike the residual's can overflow)
    const int top = e - 32 * (nl - 1);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
      if (j == nl - 1 && top < 32) limb[j] &= (1u << top) - 1u;
  }
  const int pre = prefix_bits(r);
  const int len = pre + r.k + (r.w >> r.k) + 1 + e;
  const long long o = first[b] * 32 + off[g];
  const long long w0 = o >> 5;
  const int span = static_cast<int>(((o + len + 31) >> 5) - w0);
  if (lane >= span) return;
  const int pos = static_cast<int>((w0 + lane) * 32 - o);
  unsigned out;
  if (r.mode < 2) {
    out = place(4u | (r.mode & 1) << 1 | r.inv, 3, pos);
    if (r.il)
      out |= place(static_cast<unsigned long long>(static_cast<long long>(rank)) &
                       ((1ull << r.il) - 1ull),
                   3 + r.il, pos);
  } else {
    out = place(r.mode & 1, 2, pos);
  }
  if (r.k) out |= place(static_cast<unsigned>(r.w) & ((1u << r.k) - 1u),
                        pre + r.k, pos);
  out |= place(1u, len - e, pos);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j)
    if (j < nl) out |= place(limb[j], len - 32 * j, pos);
  out = __byte_perm(out, 0, 0x0123);
  uint32_t* dst = words + w0 + lane;
  if (pos >= 0 && pos + 32 <= len)
    *dst = out;
  else if (out)
    atomicOr(dst, out);
}

}  // namespace

// block: int32 [B, T, 2 + nw], nw = ceil(M / 32); enb: int32 [M + 1];
// binom: uint32 [M (M + 1) / 2, 8], C(a, r) at a (a + 1) / 2 + r in 32-bit
// limbs, least first; off: int64 [B, T] scratch; nbits, first: int64 [B];
// done: a zeroed uint64; words: a zeroed uint32 buffer that holds every
// page (ops/recpack.py::capacity_words).  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int bic_pack_records(const void* block, const void* enb,
                                const void* binom, void* off, void* nbits,
                                void* first, void* done, void* words, int B,
                                int T, int nw, int M, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (M < 1 || M > kMaxM || nw != (M + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(binom) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = 2 + nw;
  const long long tiles = static_cast<long long>(B) * T;
  const long long grid = (tiles + kEmitWarps - 1) / kEmitWarps;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* blk = static_cast<const int32_t*>(block);
  const auto* eb = static_cast<const int32_t*>(enb);
  auto* o = static_cast<long long*>(off);
  auto* nb = static_cast<long long*>(nbits);
  auto* fw = static_cast<long long*>(first);
  k9_offsets<<<B, kScanThreads, 0, st>>>(
      blk, eb, o, nb, fw, static_cast<unsigned long long*>(done), B, T, C, M);
  k9_emit<<<static_cast<int>(grid), 32 * kEmitWarps, 0, st>>>(
      blk, eb, static_cast<const uint4*>(binom), o, nb, fw,
      static_cast<uint32_t*>(words), T, C, nw, M, (M + 31) / 32, tiles);
  return static_cast<int>(cudaGetLastError());
}
