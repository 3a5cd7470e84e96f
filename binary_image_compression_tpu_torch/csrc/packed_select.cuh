// Device helpers shared by the selection kernels K1 (fused_search.cu), K3
// (strict_analyze.cu) and K4 (select_windows.cu), and the Golomb-k
// searches of K3 (golomb_k, a warp vote) and K2 (golomb_k_lane, per lane).
//
// The serial-scan selection is ONE min over a 64-bit packed priority
//     stop ? key << (db+1) | d' << 1 | inv : FLAG | d' << (kb+1) | key << 1 | inv
// (ops/fused_search.py::packed_sel_layout); the winner decodes from its
// scan key with the closed-form rectangle counts of
// binary_image_compression_tpu/ops/pallas_kernels.py::_packed_decode.
//
// The window scoring K1 and K3 share: a thread takes one candidate column
// and a run of L consecutive window rows, holds the tile's fields in
// registers packed as the candidate words are (pack_tile), slides down the
// column (window_dists: L + W - 1 loads for L windows, two 16-bit or four
// 8-bit fields per popcount) and forms one 64-bit priority for the run's
// winner (run_best).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bic {

constexpr unsigned long long kInf = 1ULL << 62;
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  int span, off1, kb, db;
};

template <int W>
struct Geo {
  static constexpr int K = W == 8 ? 4 : W == 16 ? 2 : 1;  // fields per word
  static constexpr int NP = W / K;                         // popcounts/window
  // K3's grid-1 window rows per thread item: W+1 rows in 3, 3, 5 and 5 runs
  static constexpr int L1 = W == 8 ? 3 : W == 16 ? 6 : W == 24 ? 5 : 7;
  static constexpr uint32_t mask = (uint32_t)((1ull << W) - 1ull);
};

// The packed priority of a candidate at distance d with scan key `key`.
__device__ __forceinline__ unsigned long long packed_priority(
    int d, long long key, int M, int T_thresh, int invert, Layout lay) {
  int dp = d;
  unsigned long long inv = 0;
  if (invert) {
    inv = (M - d) < d;
    dp = min(d, M - d);
  }
  const unsigned long long uk = (unsigned long long)key;
  const unsigned long long ud = (unsigned long long)dp;
  const unsigned long long flag = 1ULL << (lay.db + lay.kb + 2);
  return dp <= T_thresh ? (uk << (lay.db + 1)) | (ud << 1) | inv
                        : flag | (ud << (lay.kb + 1)) | (uk << 1) | inv;
}

// Minimum of a 64-bit value over a full warp: high words first, then the
// low words of the lanes holding the high minimum.
__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v) {
  const unsigned hi = (unsigned)(v >> 32);
  const unsigned mhi = __reduce_min_sync(kFull, hi);
  const unsigned lo = hi == mhi ? (unsigned)v : 0xffffffffu;
  const unsigned mlo = __reduce_min_sync(kFull, lo);
  return ((unsigned long long)mhi << 32) | mlo;
}

// Minimum over the block, returned to every thread.  Every thread of the
// block must call it; `scratch` holds one word per warp and may be reused
// as soon as it returns.
template <int kThreads>
__device__ __forceinline__ unsigned long long block_min_u64(
    unsigned long long v, unsigned long long* scratch) {
  v = warp_min_u64(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long m = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) m = scratch[w] < m ? scratch[w] : m;
  __syncthreads();
  return m;
}

// tp[m]: the tile's fields m*K .. m*K+K-1 packed as a candidate word is,
// field a at bits W * (a - m*K).  ld(a) returns the tile's field of row a.
template <int W, class Ld>
__device__ __forceinline__ void pack_tile(Ld ld, uint32_t (&tp)[Geo<W>::NP]) {
  constexpr int K = Geo<W>::K;
#pragma unroll
  for (int m = 0; m < Geo<W>::NP; ++m) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) v |= ld(m * K + j) << (W * j);
    tp[m] = v;
  }
}

// d[l] = Hamming distance between the tile and the window whose top row is
// y0 + l, for l < L, on one column; ld(r) returns the field of row y0 + r.
// Loads L + W - 1 fields and takes L * W / K popcounts.
template <int W, int L, class Ld>
__device__ __forceinline__ void window_dists(Ld ld,
                                             const uint32_t (&tp)[Geo<W>::NP],
                                             int (&d)[L]) {
  constexpr int K = Geo<W>::K;
  uint32_t hist[K];
#pragma unroll
  for (int j = 0; j < K; ++j) hist[j] = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) d[l] = 0;
#pragma unroll
  for (int r = 0; r < L + W - 1; ++r) {
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) hist[j] = hist[j + 1];
    hist[K - 1] = ld(r);
    if (r >= K - 1) {
      // rows s .. s+K-1 in one word; window l uses it as its word m
      const int s = r - (K - 1);
      uint32_t pw = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) pw |= hist[j] << (W * j);
#pragma unroll
      for (int m = 0; m < Geo<W>::NP; ++m) {
        const int l = s - m * K;
        if (l >= 0 && l < L) d[l] += __popc(pw ^ tp[m]);
      }
    }
  }
}

// The least packed priority among one column's windows with top rows
// y0..y0+L-1, those with y <= ylast, where key(y) falls as y grows: a stop
// window (d' <= T) beats every other and the one with the largest y wins;
// else the least d', ties to the largest y.  d' = min(d, M-d) under
// inversion, else d.  Only the winner's 64-bit priority is formed.
template <int L, class Key>
__device__ __forceinline__ unsigned long long run_best(const int (&d)[L],
                                                       int y0, int ylast,
                                                       int M, int T,
                                                       int invert, Key key,
                                                       Layout lay) {
  int vbest = 0x7fffffff, dbest = 0, lbest = -1;
#pragma unroll
  for (int l = L - 1; l >= 0; --l) {
    const int dp = invert ? min(d[l], M - d[l]) : d[l];
    const int v = dp <= T ? -1 : dp;
    if (y0 + l <= ylast && v < vbest) { vbest = v; dbest = d[l]; lbest = l; }
  }
  return lbest < 0 ? kInf
                   : packed_priority(dbest, key(y0 + lbest), M, T, invert, lay);
}

__device__ __forceinline__ long long count_lt(long long ks, long long c,
                                              long long r, long long span) {
  // |{(ry, xt): 0 <= ry < r, 0 <= xt < c, ry*span + xt < ks}|, c < span
  if (c <= 0 || ks <= 0) return 0;
  long long nf = ks >= c ? (ks - c) / span + 1 : 0;
  nf = nf < 0 ? 0 : (nf > r ? r : nf);
  long long rem = ks - nf * span;
  rem = rem < 0 ? 0 : (rem > c ? c : rem);
  return nf * c + (nf < r ? rem : 0);
}

struct Selected {
  long long bestd, y, x, rank, n_cands;
  int inv, found;
};

// Decode a packed minimum for the tile at absolute (i0, j0): the winner's
// absolute (y, x), zeros when there was no candidate.  n_cands counts both
// window grids (the y = i0-W row twice); with R < W both are empty.
__device__ __forceinline__ Selected packed_decode(unsigned long long pu,
                                                  long long i0, long long j0,
                                                  int W, int R, int cols,
                                                  Layout lay) {
  const long long pr = (long long)pu;
  const bool found = pu < kInf;
  const bool is_stop = pu < (1ULL << (lay.db + lay.kb + 2));
  const long long kmask = (1LL << lay.kb) - 1, dmask = (1LL << lay.db) - 1;
  const long long key_sel = is_stop ? pr >> (lay.db + 1) : (pr >> 1) & kmask;
  const long long bestd =
      is_stop ? (pr >> 1) & dmask : (pr >> (lay.kb + 1)) & dmask;
  const long long minj = j0 - R > 0 ? j0 - R : 0;
  const long long maxj2 = j0 - W > 0 ? j0 - W : 0;
  const long long maxj = j0 + R < cols - W ? j0 + R : cols - W;
  const bool g2 = key_sel >= lay.off1;
  const long long q = g2 ? key_sel - lay.off1 : key_sel;
  const long long ry = q / lay.span, xt = q - ry * lay.span;

  const long long r1 = (i0 < W ? i0 : W) + 1;
  const long long c1v = maxj2 - minj + 1;
  const long long c1 = j0 >= W && c1v > 0 ? c1v : 0;
  const long long lo2 = i0 - R > 0 ? i0 - R : 0;
  const long long r2v = i0 - W - lo2 + 1;
  const long long r2 = r2v > 0 ? r2v : 0;
  const long long c2 = maxj - minj + 1;

  Selected s;
  s.found = found;
  s.n_cands = r1 * c1 + r2 * c2;
  s.bestd = found ? bestd : 0;
  s.inv = found ? (int)(pr & 1) : 0;
  s.y = found ? (g2 ? i0 - W - ry : i0 - ry) : 0;
  s.x = found ? (g2 ? maxj - xt : maxj2 - xt) : 0;
  s.rank = found ? count_lt(key_sel, c1, r1, lay.span) +
                       count_lt(g2 ? key_sel - lay.off1 : -1, c2, r2, lay.span)
                 : 0;
  return s;
}

// The next Golomb parameter after (n, acc) were updated: the least k in
// 0..31 with (n << k) mod 2^32 >= acc, else 31 (GolombCoder.cpp:29-33).
// One compare per lane of a full warp.
__device__ __forceinline__ int golomb_k(unsigned n, unsigned acc) {
  const unsigned ok = __ballot_sync(kFull, (n << (threadIdx.x & 31)) >= acc);
  return ok ? __ffs(ok) - 1 : 31;
}

// The same k for one lane's own (n, acc), with no warp vote, so that lanes
// may hold different contexts (K2's rounds).  acc > n >= 1: n << k0, with
// k0 = clz(n) - clz(acc), has acc's top bit, so k is k0 or k0 + 1 by one
// compare while n << k does not wrap (k <= clz(n)); past that, acc >= 2^31
// and a short loop, the only branch, tests the wrapped shifts.
// ops/decide.py::golomb_k_lane mirrors it.
static __device__ __noinline__ int golomb_k_wrapped(unsigned n, unsigned acc,
                                                    int k0) {
  for (int k = k0 + 1; k < 32; ++k)
    if ((n << k) >= acc) return k;
  return 31;
}

__device__ __forceinline__ int golomb_k_lane(unsigned n, unsigned acc) {
  const int cn = __clz(n);                           // 32 for n = 0
  const int k0 = min(max(cn - __clz(acc), 0), 31);   // clamped for acc <= n
  const bool ge = (n << k0) >= acc;
  int k = ge ? k0 : k0 + 1;
  if (!ge && k0 == cn && acc > n) k = golomb_k_wrapped(n, acc, k0);
  return acc <= n ? 0 : cn == 32 ? 31 : k;
}

}  // namespace bic
