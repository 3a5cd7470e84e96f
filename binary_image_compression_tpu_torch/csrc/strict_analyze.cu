// Kernel K3: the strict-mode (residual-substitution) analysis of one page.
//
// Replaces: binary_image_compression_tpu/ops/pallas_strict.py
//           ::strict_analyze (kernel body _make_kernel.kernel, split form).
//
// What it computes: the tiles of the page in raster order, each one
// searching the LIVE W-bit row-field plane E (earlier tiles have already
// replaced their pixels by their residuals), selecting with K1's packed
// priority and the exact R, forming p3 = ((inv ? p ^ wmask : p) ^ p2) and
// the MED residuals in the field domain, deciding the codec-8 mode against
// two Golomb contexts that persist across the whole page (K2's costs), and
// writing the chosen residual back into E (fields x in [j0-W+1, j0+W) of
// rows [i0, i0+W)).  Outputs per tile: (mode, rank, inv, weight, k_used,
// n_cands, idx_len, bestd) and the W residual fields.
//
// What bounds it on the H100: popcount throughput (16 per clock per SM)
// and, for the part that must stay serial, latency.  Tile t+1 may read what
// tile t wrote, so a page is one dependent chain of T steps.  Grid-2 candidates
// (rows <= i0-W) read only rows that are final once the previous tile row
// is done, so they are scored for a whole tile row at once, off the chain;
// grid 1 (rows i0-W..i0, W+1 rows) is the chain's own work.  At doc512,
// W=16, R=128 that is 21.6 M grid-2 and 1.6 M grid-1 windows.
//
// What the design does about it (a plane kernel, then two launches per
// tile row):
//  * The W-bit field plane is built on the card from the page's 0/1 bytes,
//    one thread per field, so the wrapper runs no PyTorch ops for it.
//  * Register reuse.  A thread takes one candidate column x and a run of
//    consecutive window rows y0..y0+L-1.  It holds the tile's fields in
//    registers and slides down the column: each field it loads serves up to
//    W windows.  For W <= 16, K = 32/W fields of consecutive rows share one
//    32-bit word, so one popcount covers K rows of a window (W/K popcounts
//    per window instead of W).
//  * Grid 2 fills the card: grid (nx, slices), block (tj, s) takes the
//    window rows that slice s owns in runs of kRun2 = 8, reduces to one
//    64-bit packed priority and merges it into pr2[tj] with atomicMin (the
//    minimum does not depend on the order, so the result stays exact).
//    The serial pass resets pr2[tj] once it has read it.
//  * The launch geometry (the slicing, about two blocks per SM per tile
//    row, and the ring's size) is ops/strict.py::_plan's; this file only
//    checks that it covers what the kernels read.
//  * The serial pass is one block of 512 threads working from shared
//    memory: the live band, rows [i0-W, i0+W), is held as a ring of
//    C = min(max(R, W) + 3W, gw) columns (column x in slot x mod C), each
//    column RR = 2W + 9 words (_plan's ring_rows: slack below the band for
//    grid 1's last run, at least L1 - 1 rows; odd, so a warp on
//    neighbouring columns hits 32 banks).  Slots are
//    tracked as the tiles advance, never divided out.  While tile j0
//    is decided the ring holds columns [j0-R, j0+2W); the columns
//    [j0+2W, j0+3W) of tile j0+2W come in meanwhile, and each column they
//    evict has its substituted rows written back; the rest is written back
//    when the row ends.  The ring takes C x RR x 4 bytes (28,864 B at
//    doc512, W=16, R=128) beside the enb LUT.  Where it does not fit in
//    227 KB (_plan says so: W=32 with both R and the page width past ~680),
//    the same kernel, instantiated without the ring, reads and writes the
//    band in global memory (L2); nothing else changes.
//  * Warp specialisation and a pipeline across tiles, two barriers per
//    tile.  A grid-1 window of tile j0 at a column x <= j0-2W reads no
//    field that tile j0-W substitutes, so it can be scored while tile j0-W
//    is still being decided.  Phase A: warps 1..15 score grid 1's newest
//    W columns (one window per thread); meanwhile warp 0 finishes this
//    tile's grid-2 winner, whose fields it loaded from global memory (rows
//    < i0 are final) one tile ahead.  Phase B: warp 0 takes the minimum of
//    both grid-1 parts and the grid-2 winner, redoes the finish from the
//    ring only if grid 1 won, decides (K2's costs, Golomb k by one ballot)
//    and substitutes the residual (all loads, then all stores); warps 1..15
//    bring in the columns of tile j0+2W and score tile j0+W's grid 1 over
//    its older columns (each thread a column and L1 window rows, keeping
//    only its best window's 64-bit priority).  The outputs that need the
//    full decode (rank, inv, bestd) are formed for the whole row at its
//    end, off the chain.  The Golomb contexts live in warp 0's registers
//    within a launch and in a 6-word device buffer between launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "packed_select.cuh"

namespace {

constexpr int kG2Threads = 256;
constexpr int kThreads = 512;             // the serial pass
constexpr int kWarps = kThreads / 32;
constexpr int kRun2 = 8;                  // grid-2 window rows per item
constexpr int kBig = 1 << 28;
constexpr int kMcost = 3;  // codec 8: match + pred + inv bits
constexpr int kNcost = 2;  // codec 8: match + pred bits

template <int W>
struct Geo {
  static constexpr int K = W == 8 ? 4 : W == 16 ? 2 : 1;  // fields per word
  static constexpr int NP = W / K;                         // popcounts/window
  // grid-1 window rows per thread item: W+1 rows in 3, 3, 5 and 5 runs
  static constexpr int L1 = W == 8 ? 3 : W == 16 ? 6 : W == 24 ? 5 : 7;
  static constexpr uint32_t mask = (uint32_t)((1ull << W) - 1ull);
};

struct Params {
  int gh, gw, nx, W, R, T_thresh, cols;
  int C;     // ring columns of the serial pass; 0: the band stays global
  int RR;    // words per ring column: the band's 2W rows and the slack
  int slice_rows;  // grid-2 window rows per slice
  bic::Layout lay;
};

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
// else the least d', ties to the largest y.  Only the winner's 64-bit
// priority is formed.
template <int M, int L, class Key>
__device__ __forceinline__ unsigned long long run_best(const int (&d)[L],
                                                       int y0, int ylast,
                                                       int T, Key key,
                                                       bic::Layout lay) {
  int vbest = 0x7fffffff, dbest = 0, lbest = -1;
#pragma unroll
  for (int l = L - 1; l >= 0; --l) {
    const int dp = min(d[l], M - d[l]);
    const int v = dp <= T ? -1 : dp;
    if (y0 + l <= ylast && v < vbest) { vbest = v; dbest = d[l]; lbest = l; }
  }
  return lbest < 0 ? bic::kInf
                   : bic::packed_priority(dbest, key(y0 + lbest), M, T, 1, lay);
}

// Grid 2 of tile row `i0`: block (tj, s) scores the runs of slice s of
// tile tj and merges its minimum into pr2[tj].
template <int W>
__global__ void __launch_bounds__(kG2Threads)
strict_grid2_kernel(const uint32_t* __restrict__ E,
                    unsigned long long* __restrict__ pr2, Params p, int i0) {
  const int R = p.R, gw = p.gw;
  const int tj = blockIdx.x, j0 = tj * W;
  __shared__ uint32_t tf[W];
  __shared__ unsigned long long wmin[kG2Threads / 32];
  if (threadIdx.x < W) tf[threadIdx.x] = __ldg(E + (size_t)(i0 + threadIdx.x) * gw + j0);
  __syncthreads();
  uint32_t tp[Geo<W>::NP];
  pack_tile<W>([&](int a) { return tf[a]; }, tp);

  const int lo2 = max(i0 - R, 0), hi2 = i0 - W;
  const int minj = max(j0 - R, 0), maxj = min(j0 + R, p.cols - W);
  // this slice's window rows ya..yb
  const int ya = lo2 + blockIdx.y * p.slice_rows;
  const int yb = min(ya + p.slice_rows - 1, hi2);
  const int ncol = maxj - minj + 1, nrun = (yb - ya + kRun2) / kRun2;
  const int n = yb >= ya && ncol > 0 ? nrun * ncol : 0;
  unsigned long long best = bic::kInf;
  for (int idx = threadIdx.x; idx < n; idx += kG2Threads) {
    const int q = idx / ncol;
    const int x = minj + idx % ncol;
    const int y0 = ya + q * kRun2;
    const uint32_t* col = E + x;
    int d[kRun2];
    // every row a valid window reads is < i0
    window_dists<W, kRun2>(
        [&](int r) { return __ldg(col + (size_t)min(y0 + r, i0 - 1) * gw); },
        tp, d);
    const unsigned long long pr = run_best<W * W, kRun2>(
        d, y0, yb, p.T_thresh,
        [&](int y) {
          return p.lay.off1 + (long long)(hi2 - y) * p.lay.span + (maxj - x);
        },
        p.lay);
    best = pr < best ? pr : best;
  }
  best = bic::warp_min_u64(best);
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = wmin[0];
    for (int w = 1; w < kG2Threads / 32; ++w) m = wmin[w] < m ? wmin[w] : m;
    if (m < bic::kInf) atomicMin(pr2 + tj, m);
  }
}

// The W-bit row-field plane of a 0/1 byte image [gh, gw]: E[y][x] holds
// img[y][x .. x+W) as bits W-1 .. 0, zeros past the right edge.
template <int W>
__global__ void strict_plane_kernel(const uint8_t* __restrict__ img,
                                    uint32_t* __restrict__ E, int gh,
                                    int gw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)gh * gw) return;
  const int y = (int)(i / gw), x = (int)(i - (long long)y * gw);
  const uint8_t* r = img + (size_t)y * gw;
  uint32_t v = 0;
#pragma unroll
  for (int a = 0; a < W; ++a)
    v = (v << 1) | (x + a < gw && r[x + a] ? 1u : 0u);
  E[i] = v;
}

// Where a packed priority's window lies (K1's decode, without the rank).
struct Pos {
  int y, x, inv;
};

__device__ __forceinline__ Pos decode_pos(unsigned long long pu, int i0,
                                          int j0, int W, int R, int cols,
                                          bic::Layout lay) {
  if (pu >= bic::kInf) return Pos{0, 0, 0};
  const bool is_stop = pu < (1ULL << (lay.db + lay.kb + 2));
  const long long kmask = (1LL << lay.kb) - 1;
  const long long key = is_stop ? (long long)(pu >> (lay.db + 1))
                                : (long long)(pu >> 1) & kmask;
  const bool g2 = key >= lay.off1;
  const long long q = g2 ? key - lay.off1 : key;
  const long long ry = q < 0x7fffffffLL
                           ? (long long)((unsigned)q / (unsigned)lay.span)
                           : q / lay.span;
  const int xt = (int)(q - ry * lay.span);
  const int maxj = min(j0 + R, cols - W), maxj2 = max(j0 - W, 0);
  return Pos{g2 ? i0 - W - (int)ry : i0 - (int)ry,
             g2 ? maxj - xt : maxj2 - xt, (int)(pu & 1)};
}

// n_cands of tile (i0, j0): both window grids (bic::packed_decode's count).
__device__ __forceinline__ int n_cands(int i0, int j0, int W, int R,
                                       int cols) {
  const int minj = max(j0 - R, 0), maxj2 = max(j0 - W, 0);
  const int maxj = min(j0 + R, cols - W);
  const int c1 = j0 >= W && maxj2 - minj + 1 > 0 ? maxj2 - minj + 1 : 0;
  const int r2 = max(i0 - W - max(i0 - R, 0) + 1, 0);
  return (min(i0, W) + 1) * c1 + r2 * (maxj - minj + 1);
}

// The finish of one candidate on warp 0: lane a < W holds row a of the
// tile (pv) and of the candidate (pc); the match residual p3, its MED and
// their weights.
template <int W>
__device__ __forceinline__ void finish(uint32_t pv, uint32_t pc, int inv,
                                       uint32_t& p3, uint32_t& dp3, int& w0,
                                       int& w1) {
  constexpr uint32_t wmask = Geo<W>::mask;
  const int lane = threadIdx.x & 31;
  p3 = ((inv ? pv ^ wmask : pv) ^ pc) & wmask;
  // every lane shuffles (full mask); lane 0 has no row above
  const uint32_t sh3 = __shfl_up_sync(bic::kFull, p3, 1);
  const uint32_t up3 = lane ? sh3 : 0u;
  dp3 = (p3 ^ up3 ^ (p3 >> 1) ^ (up3 >> 1)) & wmask;
  w0 = (int)__reduce_add_sync(bic::kFull, lane < W ? __popc(p3) : 0);
  w1 = (int)__reduce_add_sync(bic::kFull, lane < W ? __popc(dp3) : 0);
}

// The serial chain over the tiles of tile row `ti`: one block.  Warp 0
// runs the chain (selection, finish, decision, substitution); warps 1..15
// score grid 1 and move the ring.  kRing: the band lives in the shared-
// memory ring, column-major (field (y, x) at slot(x) * RR + y - (i0 - W)),
// else in E.  pr2[tj] is read ahead, holds the selected priority once tile
// tj is decided, and is reset when the row ends.
template <int W, bool kRing>
__global__ void __launch_bounds__(kThreads)
strict_serial_kernel(uint32_t* E, unsigned long long* pr2,
                     const int32_t* __restrict__ enb, uint32_t* gctx,
                     int32_t* __restrict__ out, int32_t* __restrict__ resf,
                     Params p, int ti) {
  constexpr int M = W * W, L1 = Geo<W>::L1;
  constexpr uint32_t wmask = Geo<W>::mask;
  constexpr int kScorers = kThreads - 32;
  extern __shared__ uint32_t smem[];
  int32_t* s_enb = (int32_t*)smem;
  uint32_t* ring = smem + (M + 1);  // [C][RR]
  // per scoring warp: its minimum over the new columns (phase A) and, two
  // buffers by tile parity, over the old columns (phase B of the tile before)
  __shared__ unsigned long long wmin_new[kWarps], wmin_old[2][kWarps];
  const int R = p.R, gw = p.gw, C = p.C, RR = p.RR, nx = p.nx;
  const int i0 = ti * W, base = i0 - W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool row = lane < W;

  // the live field (y, x), y in [max(i0-W, 0), i0+W), whose ring slot is
  // `slot` (slots are tracked, not divided out: back(s, d) is the slot of
  // the column d to the left of the one in slot s, 0 <= d < C)
  auto at = [&](int y, int x, int slot) -> uint32_t& {
    if constexpr (kRing) return ring[slot * RR + (y - base)];
    else return E[(size_t)y * gw + x];
  };
  auto back = [&](int s, int d) { return s - d < 0 ? s - d + C : s - d; };
  // bring columns [xa, xa+W) into the ring; the column each evicts (x - C)
  // gets its substituted rows [i0, i0+W) written back first.  In two steps,
  // so that the global loads overlap the scoring: fetch takes this scorer
  // thread's share of the 2W x W fields into registers, commit stores them.
  constexpr int kLd = (2 * W * W + kScorers - 1) / kScorers;
  auto fetch = [&](int xa, uint32_t (&v)[kLd]) {
#pragma unroll
    for (int k = 0; k < kLd; ++k) {
      const int idx = threadIdx.x - 32 + k * kScorers;
      const int r = idx / W, y = base + r;
      v[k] = idx < 2 * W * W && y >= 0 ? E[(size_t)y * gw + xa + idx - r * W] : 0u;
    }
  };
  auto commit = [&](int xa, int sa, const uint32_t (&v)[kLd]) {
#pragma unroll
    for (int k = 0; k < kLd; ++k) {
      const int idx = threadIdx.x - 32 + k * kScorers;
      if (idx < 2 * W * W) {
        const int r = idx / W, c = idx - r * W, x = xa + c;
        uint32_t* slot = ring + (sa + c < C ? sa + c : sa + c - C) * RR + r;
        if (r >= W && x >= C) E[(size_t)(base + r) * gw + x - C] = *slot;
        *slot = v[k];
      }
    }
  };
  // warp 0: the grid-2 winner of tile tj and its fields, loaded a tile ahead
  auto grid2_winner = [&](int tj, unsigned long long g2, uint32_t& pc) {
    const Pos s = decode_pos(g2, i0, tj * W, W, R, p.cols, p.lay);
    pc = row && g2 < bic::kInf ? E[(size_t)(s.y + lane) * gw + s.x] : 0u;
    return s.inv;
  };
  // grid 1 of tile j0 over columns [xa, xb] (scorer threads): each thread
  // takes one column and L window rows; the warp's minimum goes to *wmin
  const int lo1 = max(i0 - W, 0), nrow1 = i0 - lo1 + 1;
  auto score = [&](auto run, int j0, int sj0, int xa, int xb,
                   unsigned long long* wmin) {
    constexpr int L = decltype(run)::value;
    const int ncol = xb - xa + 1, nrun = (nrow1 + L - 1) / L;
    unsigned long long best = bic::kInf;
    if (j0 >= W && ncol > 0) {
      // items (run q, column c) on a power-of-two column stride: no division
      const int sh = 32 - __clz(ncol - 1), n = nrun << sh;
      uint32_t tp[Geo<W>::NP];
      int sa = 0;  // the ring slot of column xa
      if constexpr (kRing) {
        const uint32_t* tcol = ring + sj0 * RR + W;  // rows i0..
        pack_tile<W>([&](int a) { return tcol[a]; }, tp);
        sa = back(sj0, j0 - xa);
      } else {
        pack_tile<W>([&](int a) { return E[(size_t)(i0 + a) * gw + j0]; }, tp);
      }
      for (int idx = threadIdx.x - 32; idx < n; idx += kScorers) {
        const int c = idx & ((1 << sh) - 1), x = xa + c;
        const int y0 = lo1 + (idx >> sh) * L;
        if (c >= ncol) continue;
        int d[L];
        if constexpr (kRing) {
          // the ring has RR - 2W rows of slack below the band, so the last
          // run's windows past i0 read there and need no clamp
          const int slot = sa + c < C ? sa + c : sa + c - C;
          const uint32_t* col = ring + slot * RR + (y0 - base);
          window_dists<W, L>([&](int r) { return col[r]; }, tp, d);
        } else {
          const uint32_t* col = E + x;
          window_dists<W, L>(
              [&](int r) { return col[(size_t)min(y0 + r, i0 + W - 1) * gw]; },
              tp, d);
        }
        const unsigned long long pr = run_best<M, L>(
            d, y0, i0, p.T_thresh,
            [&](int y) { return (long long)(i0 - y) * p.lay.span + (j0 - W - x); },
            p.lay);
        best = pr < best ? pr : best;
      }
    }
    best = bic::warp_min_u64(best);
    if (lane == 0) *wmin = best;
  };

  for (int i = threadIdx.x; i <= M; i += kThreads) s_enb[i] = enb[i];
  if constexpr (kRing) {  // the columns of tiles 0 and 1
    for (int idx = threadIdx.x; idx < 2 * W * min(2 * W, gw); idx += kThreads) {
      const int r = idx % (2 * W), x = idx / (2 * W);
      if (base + r >= 0) ring[x * RR + r] = E[(size_t)(base + r) * gw + x];
    }
  }
  if (threadIdx.x < kWarps) wmin_old[0][threadIdx.x] = bic::kInf;
  // warp 0's chain state: the Golomb contexts, replicated in its lanes, and
  // the grid-2 winners of the next tiles
  uint32_t m_acc = gctx[0], m_n = gctx[1], n_acc = gctx[3], n_n = gctx[4];
  int m_k = (int)gctx[2], n_k = (int)gctx[5];
  unsigned long long g2c = 0, g2n = 0;
  uint32_t pcc = 0, pcn = 0;
  int invc = 0;
  if (warp == 0) {
    g2c = pr2[0];
    invc = grid2_winner(0, g2c, pcc);
    g2n = nx > 1 ? pr2[1] : bic::kInf;
  }
  __syncthreads();

  for (int tj = 0, sj = 0; tj < nx; ++tj) {  // sj: the ring slot of j0
    const int j0 = tj * W;
    const int sjn = sj + W < C ? sj + W : sj + W - C;  // of j0 + W

    // phase A: the scorers take grid 1's columns that tile tj-1's
    // substitution touched, [max(j0-R, j0-2W+1, 0), j0-W], one window per
    // thread; warp 0 finishes the grid-2 winner ahead and loads the next
    // tile's.  (Grid 1's older columns were scored in the last phase B.)
    uint32_t pv = 0, dpv = 0, p3 = 0, dp3 = 0;
    int w0 = 0, w1 = 0, w2 = 0, w3 = 0, invn = 0;
    unsigned long long g2nn = bic::kInf;
    if (warp == 0) {
      pv = row ? at(i0 + lane, j0, sj) & wmask : 0u;
      finish<W>(pv, pcc & wmask, invc, p3, dp3, w0, w1);
      uint32_t tile;
      finish<W>(pv, 0u, 0, tile, dpv, w2, w3);  // the tile itself: pv, MED
      if (tj + 1 < nx) invn = grid2_winner(tj + 1, g2n, pcn);
      if (tj + 2 < nx) g2nn = pr2[tj + 2];
    } else {
      score(std::integral_constant<int, 1>(), j0, sj,
            max(max(j0 - R, 0), j0 - 2 * W + 1), j0 - W, &wmin_new[warp]);
    }
    __syncthreads();

    // phase B: warp 0 selects, decides and substitutes; the scorers bring
    // in the columns of tile tj+2 and score tile tj+1's grid 1 over the
    // columns no later substitution touches, [max(j0+W-R, 0), j0-W]
    if (warp == 0) {
      const int o = tj & 1;
      const unsigned long long b1 = bic::warp_min_u64(
          lane > 0 && lane < kWarps ? min(wmin_new[lane], wmin_old[o][lane])
                                    : bic::kInf);
      const bool from1 = b1 < g2c;
      if (from1) {  // a grid-1 winner: its fields are in the band
        const Pos s1 = decode_pos(b1, i0, j0, W, R, p.cols, p.lay);
        const uint32_t pc =
            row ? at(s1.y + lane, s1.x, back(sj, j0 - s1.x)) & wmask : 0u;
        finish<W>(pv, pc, s1.inv, p3, dp3, w0, w1);
      }
      const int nc = n_cands(i0, j0, W, R, p.cols);
      const int il = nc > 0 ? max(1, 32 - __clz(nc - 1)) : 0;
      // the decision: first minimum of the four costs
      const bool hc = nc > 0;
      const int c0 = hc ? kMcost + il + m_k + (w0 >> m_k) + 1 + s_enb[w0] : kBig;
      const int c1 = hc ? kMcost + il + m_k + (w1 >> m_k) + 1 + s_enb[w1] : kBig;
      const int c2 = kNcost + n_k + (w2 >> n_k) + 1 + s_enb[w2];
      const int c3 = kNcost + n_k + (w3 >> n_k) + 1 + s_enb[w3];
      int mode = 0, cbest = c0, weight = w0;
      uint32_t res = p3;
      if (c1 < cbest) { mode = 1; cbest = c1; weight = w1; res = dp3; }
      if (c2 < cbest) { mode = 2; cbest = c2; weight = w2; res = pv; }
      if (c3 < cbest) { mode = 3; cbest = c3; weight = w3; res = dpv; }
      const bool match = mode < 2;
      const int k_used = match ? m_k : n_k;
      const uint32_t n = (match ? m_n : n_n) + 1u;
      const uint32_t acc = (match ? m_acc : n_acc) + (uint32_t)weight;
      const int k = bic::golomb_k(n, acc);
      if (match) { m_n = n; m_acc = acc; m_k = k; }
      else       { n_n = n; n_acc = acc; n_k = k; }
      // substitution: the tile's pixels become its residual, fields x in
      // [j0-W+1, j0+W) of rows [i0, i0+W); lane l takes row l % W and
      // every (32/W)-th column (for W <= 16, rows share the warp); all
      // loads first, then all stores
      constexpr int kPer = 32 / W, kCols = (2 * W - 1 + kPer - 1) / kPer;
      const int a = lane % W, part = lane / W;
      const uint32_t ra = __shfl_sync(bic::kFull, res, a);
      if (part < kPer) {
        const int xs = j0 - W + 1 + part;  // this lane's first column
        uint32_t v[kCols];
        int sl[kCols];
        int slot = kRing ? back(sj, W - 1 - part) : 0;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int x = xs + i * kPer;
          if constexpr (kRing) {
            sl[i] = slot;
            v[i] = ring[slot * RR + W + a];
            slot += kPer;
            slot = slot >= C ? slot - C : slot;
          } else {
            v[i] = x >= 0 && x < gw ? E[(size_t)(i0 + a) * gw + x] : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int c = i * kPer + part, sh = c - (W - 1), x = xs + i * kPer;
          if (c < 2 * W - 1 && x >= 0 && x < gw) {
            const uint32_t put = sh <= 0 ? ra >> -sh : (ra << sh) & wmask;
            const uint32_t keep = sh <= 0 ? wmask >> -sh : (wmask << sh) & wmask;
            const uint32_t e = (v[i] & ~keep) | put;
            if constexpr (kRing) ring[sl[i] * RR + W + a] = e;
            else E[(size_t)(i0 + a) * gw + x] = e;
          }
        }
      }

      const size_t t = (size_t)ti * nx + tj;
      if (row) resf[t * W + lane] = (int32_t)res;
      if (lane == 0) {  // the rest of the outputs when the row ends
        pr2[tj] = from1 ? b1 : g2c;
        out[t * 8 + 0] = mode;
        out[t * 8 + 3] = weight;
        out[t * 8 + 4] = k_used;
      }
      g2c = g2n;
      pcc = pcn;
      invc = invn;
      g2n = g2nn;
    } else {
      const bool more = kRing && j0 + 2 * W < gw;  // gw % W == 0
      uint32_t v[kLd];
      if (more) fetch(j0 + 2 * W, v);
      if (tj + 1 < nx)
        score(std::integral_constant<int, L1>(), j0 + W, sjn,
              max(j0 + W - R, 0), j0 - W, &wmin_old[(tj + 1) & 1][warp]);
      if (more) commit(j0 + 2 * W, sjn + W < C ? sjn + W : sjn + W - C, v);
    }
    __syncthreads();
    sj = sjn;
  }
  // the outputs that need the full decode (rank, inv, bestd), all tiles of
  // the row at once; pr2 goes back to 2^62 for the next row's grid 2
  for (int tj = threadIdx.x; tj < nx; tj += kThreads) {
    const bic::Selected s =
        bic::packed_decode(pr2[tj], i0, tj * W, W, R, p.cols, p.lay);
    int32_t* o = out + ((size_t)ti * nx + tj) * 8;
    const int nc = (int)s.n_cands;
    o[1] = (int32_t)s.rank;
    o[2] = s.inv;
    o[5] = nc;
    o[6] = nc > 0 ? max(1, 32 - __clz(nc - 1)) : 0;
    o[7] = (int32_t)s.bestd;
    pr2[tj] = bic::kInf;
  }
  if constexpr (kRing) {
    // write back rows [i0, i0+W) of the columns still in the ring
    const int xa = max(gw - C, 0), ncl = gw - xa;
    for (int idx = threadIdx.x; idx < W * ncl; idx += kThreads) {
      const int a = idx / ncl, x = xa + (idx - a * ncl);
      E[(size_t)(i0 + a) * gw + x] = ring[(x % C) * RR + W + a];
    }
  }
  if (threadIdx.x == 0) {
    gctx[0] = m_acc; gctx[1] = m_n; gctx[2] = (uint32_t)m_k;
    gctx[3] = n_acc; gctx[4] = n_n; gctx[5] = (uint32_t)n_k;
  }
}

template <int W>
int launch(const void* img, void* E, void* pr2, const void* enb, void* gctx,
           void* out, void* resf, Params p, int gh, int slices,
           cudaStream_t s) {
  const int ny = gh / W;
  const bool ring = p.C > 0;
  // the plan must give the ring every column a tile row needs at once and
  // the slack below the band that grid 1's last run reads, and its slices
  // must cover every grid-2 row of the tallest tile row
  const int need = std::min(std::max(p.R, W) + 3 * W, p.gw);
  if (ring && (p.C < need || p.C > p.gw || p.RR < 2 * W + Geo<W>::L1 - 1))
    return (int)cudaErrorInvalidValue;
  const int rows2 = std::max(0, std::min(p.R, gh - W) - W + 1);
  if ((long long)slices * p.slice_rows < rows2) return (int)cudaErrorInvalidValue;
  // the enb LUT and the ring; a size past the card's limit fails here
  const size_t smem = (size_t)(W * W + 1) * sizeof(int32_t) +
                      (ring ? (size_t)p.RR * p.C * sizeof(uint32_t) : 0);
  auto serial = ring ? strict_serial_kernel<W, true> : strict_serial_kernel<W, false>;
  cudaError_t err = cudaFuncSetAttribute(
      serial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)gh * p.gw;
  strict_plane_kernel<W><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const uint8_t*)img, (uint32_t*)E, gh, p.gw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int ti = 0; ti < ny; ++ti) {
    const int i0 = ti * W;
    if (slices > 0 && std::min(i0, p.R) - W + 1 > 0) {
      strict_grid2_kernel<W><<<dim3(p.nx, slices), kG2Threads, 0, s>>>(
          (const uint32_t*)E, (unsigned long long*)pr2, p, i0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    serial<<<1, kThreads, smem, s>>>(
        (uint32_t*)E, (unsigned long long*)pr2, (const int32_t*)enb,
        (uint32_t*)gctx, (int32_t*)out, (int32_t*)resf, p, ti);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// img: uint8 0/1 [gh, gw] tile grid; E: uint32 [gh, gw] scratch for the
// field plane, built from img and updated in place; pr2: uint64 [gw / W],
// all 2^62 on entry (left so); enb: int32 [W*W + 1]; gctx: uint32 [6]
// Golomb contexts (acc, n, k for match, then nomatch), read and written;
// out: int32 [T, 8]; resf: int32 [T, W].  ring_cols (0: no ring),
// ring_rows, slices, slice_rows: the plan of ops/strict.py::_plan.
// Launches the plane kernel and up to 2 kernels per tile row on `stream`;
// returns the first launch error.
extern "C" int bic_strict_analyze(const void* img, void* E, void* pr2,
                                  const void* enb, void* gctx, void* out,
                                  void* resf, int gh, int gw, int W, int R,
                                  int T_thresh, int cols, int span, int off1,
                                  int kb, int db, int ring_cols, int ring_rows,
                                  int slices, int slice_rows, void* stream) {
  if (W <= 0 || gh <= 0 || gw <= 0 || gh % W || gw % W || slices < 0 ||
      slice_rows < 0 || ring_cols < 0 || ring_rows < 0)
    return (int)cudaErrorInvalidValue;
  Params p{gh, gw, gw / W, W, R, T_thresh, cols, ring_cols, ring_rows,
           slice_rows, bic::Layout{span, off1, kb, db}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 8: return launch<8>(img, E, pr2, enb, gctx, out, resf, p, gh, slices, s);
    case 16: return launch<16>(img, E, pr2, enb, gctx, out, resf, p, gh, slices, s);
    case 24: return launch<24>(img, E, pr2, enb, gctx, out, resf, p, gh, slices, s);
    case 32: return launch<32>(img, E, pr2, enb, gctx, out, resf, p, gh, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
