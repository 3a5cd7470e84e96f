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
// What bounds it on the H100: the serial chain.  Tile t+1 may read what
// tile t wrote, so one page is one dependent sequence of T steps, each a
// block-wide search, a reduction, a one-warp decision and a substitution,
// separated by barriers; the card's other SMs have nothing to do for this
// page.  The search itself is load and popcount issue from a plane that
// stays in L2 (512x512, W=16: 1 MB).
//
// What the design does about it: the split of pallas_strict.py:229-239.
// Grid-2 candidates (rows <= i0-W) read only rows that are final once the
// previous tile row is done, so per tile row a first kernel scores grid 2
// for all nx tiles in parallel (one block per tile, __ldg loads) - 87 % of
// the distance work at R=128, W=16 - and leaves one packed minimum per
// tile.  A second kernel of ONE block walks the row's tiles: it scores
// only the (W+1)-row grid-1 slab on the live plane (plain loads: the block
// itself writes E, and __syncthreads makes its writes visible), merges the
// grid-2 minimum, and warp 0 does the finish (one lane per tile row, MED
// by __shfl_up_sync, weights by __reduce_add_sync) and the decision
// (Golomb k by one ballot).  The Golomb contexts live in a 6-word device
// buffer carried from one row's launch to the next.  2 x ny launches per
// page (64 at 512x512, W=16); a persistent cooperative launch is a later
// optimisation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 1 << 28;
constexpr int kMcost = 3;  // codec 8: match + pred + inv bits
constexpr int kNcost = 2;  // codec 8: match + pred bits

struct Params {
  int gh, gw, nx, W, R, T_thresh, cols;
  bic::Layout lay;
};

__device__ __forceinline__ uint32_t field_mask(int W) {
  return W >= 32 ? 0xffffffffu : (1u << W) - 1u;
}

// Grid 2 of tile row `i0` for every tile of the row: one block per tile.
__global__ void __launch_bounds__(kThreads)
strict_grid2_kernel(const uint32_t* __restrict__ E,
                    unsigned long long* __restrict__ pr2, Params p, int i0) {
  const int W = p.W, R = p.R;
  const int tj = blockIdx.x, j0 = tj * W;
  __shared__ uint32_t tf[32];
  __shared__ unsigned long long wmin[kThreads / 32];
  if (threadIdx.x < W) tf[threadIdx.x] = E[(size_t)(i0 + threadIdx.x) * p.gw + j0];
  __syncthreads();

  const int lo2 = max(i0 - R, 0);
  const int minj = max(j0 - R, 0), maxj = min(j0 + R, p.cols - W);
  const int nrow = i0 - W - lo2 + 1, ncol = maxj - minj + 1;
  const int n = nrow > 0 && ncol > 0 ? nrow * ncol : 0;
  unsigned long long best = bic::kInf;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / ncol;
    const int y = lo2 + r, x = minj + (idx - r * ncol);
    const uint32_t* col = E + (size_t)y * p.gw + x;
    int d = 0;
    for (int a = 0; a < W; ++a) d += __popc(__ldg(col + (size_t)a * p.gw) ^ tf[a]);
    const long long key =
        p.lay.off1 + (long long)(i0 - W - y) * p.lay.span + (maxj - x);
    const unsigned long long pr =
        bic::packed_priority(d, key, W * W, p.T_thresh, 1, p.lay);
    best = pr < best ? pr : best;
  }
  best = bic::block_min_u64<kThreads>(best, wmin);
  if (threadIdx.x == 0) pr2[tj] = best;
}

// The serial chain over the tiles of tile row `ti`: one block.
__global__ void __launch_bounds__(kThreads)
strict_serial_kernel(uint32_t* E, const unsigned long long* __restrict__ pr2,
                     const int32_t* __restrict__ enb, uint32_t* gctx,
                     int32_t* __restrict__ out, int32_t* __restrict__ resf,
                     Params p, int ti) {
  extern __shared__ int32_t s_enb[];
  __shared__ uint32_t tf[32];
  __shared__ uint32_t s_res[32];
  __shared__ unsigned long long wmin[kThreads / 32];
  const int W = p.W, R = p.R, M = W * W;
  const int i0 = ti * W;
  const uint32_t wmask = field_mask(W);
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  for (int i = threadIdx.x; i <= M; i += kThreads) s_enb[i] = enb[i];
  // Golomb contexts, replicated in the lanes of warp 0
  uint32_t m_acc = gctx[0], m_n = gctx[1], n_acc = gctx[3], n_n = gctx[4];
  int m_k = (int)gctx[2], n_k = (int)gctx[5];
  const int lo1 = max(i0 - W, 0), nrow1 = i0 - lo1 + 1;

  for (int tj = 0; tj < p.nx; ++tj) {
    const int j0 = tj * W;
    const int t = ti * p.nx + tj;
    if (threadIdx.x < W) tf[threadIdx.x] = E[(size_t)(i0 + threadIdx.x) * p.gw + j0];
    __syncthreads();

    // grid 1 on the live plane: rows lo1..i0, columns max(j0-R,0)..j0-W
    const int minj = max(j0 - R, 0), maxj2 = j0 - W;
    const int ncol1 = maxj2 - minj + 1;
    const int n1 = j0 >= W && ncol1 > 0 ? nrow1 * ncol1 : 0;
    unsigned long long best = bic::kInf;
    for (int idx = threadIdx.x; idx < n1; idx += kThreads) {
      const int r = idx / ncol1;
      const int y = lo1 + r, x = minj + (idx - r * ncol1);
      const uint32_t* col = E + (size_t)y * p.gw + x;
      int d = 0;
      for (int a = 0; a < W; ++a) d += __popc(col[(size_t)a * p.gw] ^ tf[a]);
      const long long key = (long long)(i0 - y) * p.lay.span + (maxj2 - x);
      const unsigned long long pr =
          bic::packed_priority(d, key, M, p.T_thresh, 1, p.lay);
      best = pr < best ? pr : best;
    }
    best = bic::block_min_u64<kThreads>(best, wmin);

    if (warp0) {
      const unsigned long long g2 = pr2[tj];
      const bic::Selected s = bic::packed_decode(best < g2 ? best : g2, i0,
                                                 j0, W, R, p.cols, p.lay);
      // the finish: lane a holds row a of the tile and of the candidate
      const bool row = lane < W;
      const uint32_t pv = row ? tf[lane] & wmask : 0u;
      const uint32_t pc = row ? E[(size_t)(s.y + lane) * p.gw + s.x] & wmask : 0u;
      const uint32_t p3 = ((s.inv ? pv ^ wmask : pv) ^ pc) & wmask;
      // every lane shuffles (full mask); lane 0 has no row above
      const uint32_t sh3 = __shfl_up_sync(bic::kFull, p3, 1);
      const uint32_t shv = __shfl_up_sync(bic::kFull, pv, 1);
      const uint32_t up3 = lane ? sh3 : 0u, upv = lane ? shv : 0u;
      const uint32_t dp3 = (p3 ^ up3 ^ (p3 >> 1) ^ (up3 >> 1)) & wmask;
      const uint32_t dpv = (pv ^ upv ^ (pv >> 1) ^ (upv >> 1)) & wmask;
      const int w0 = (int)__reduce_add_sync(bic::kFull, row ? __popc(p3) : 0);
      const int w1 = (int)__reduce_add_sync(bic::kFull, row ? __popc(dp3) : 0);
      const int w2 = (int)__reduce_add_sync(bic::kFull, row ? __popc(pv) : 0);
      const int w3 = (int)__reduce_add_sync(bic::kFull, row ? __popc(dpv) : 0);
      const int nc = (int)s.n_cands;
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
      if (row) {
        s_res[lane] = res;
        resf[(size_t)t * W + lane] = (int32_t)res;
      }
      if (lane == 0) {
        int32_t* o = out + (size_t)t * 8;
        o[0] = mode;
        o[1] = (int32_t)s.rank;
        o[2] = s.inv;
        o[3] = weight;
        o[4] = k_used;
        o[5] = nc;
        o[6] = il;
        o[7] = (int32_t)s.bestd;
      }
    }
    __syncthreads();

    // substitution: the tile's pixels become its residual
    const int xlo = max(j0 - W + 1, 0), xhi = min(j0 + W, p.gw);
    const int nxr = xhi - xlo;
    for (int idx = threadIdx.x; idx < W * nxr; idx += kThreads) {
      const int a = idx / nxr, x = xlo + (idx - a * nxr);
      const int sh = x - j0;
      const uint32_t r = s_res[a];
      const uint32_t put = sh <= 0 ? r >> -sh : (r << sh) & wmask;
      const uint32_t keep = sh <= 0 ? wmask >> -sh : (wmask << sh) & wmask;
      uint32_t* e = E + (size_t)(i0 + a) * p.gw + x;
      *e = (*e & ~keep) | put;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    gctx[0] = m_acc; gctx[1] = m_n; gctx[2] = (uint32_t)m_k;
    gctx[3] = n_acc; gctx[4] = n_n; gctx[5] = (uint32_t)n_k;
  }
}

}  // namespace

// E: uint32 [gh, gw] field plane, updated in place; pr2: uint64 [gw / W]
// scratch; enb: int32 [W*W + 1]; gctx: uint32 [6] Golomb contexts (acc, n,
// k for match, then nomatch), read and written; out: int32 [T, 8]; resf:
// int32 [T, W].  Launches 2 kernels per tile row on `stream`; returns the
// first launch error.
extern "C" int bic_strict_analyze(void* E, void* pr2, const void* enb,
                                  void* gctx, void* out, void* resf, int gh,
                                  int gw, int W, int R, int T_thresh,
                                  int cols, int span, int off1, int kb,
                                  int db, void* stream) {
  if (W != 8 && W != 16 && W != 24 && W != 32) return (int)cudaErrorInvalidValue;
  if (gh <= 0 || gw <= 0 || gh % W || gw % W) return (int)cudaErrorInvalidValue;
  const int nx = gw / W, ny = gh / W;
  Params p{gh, gw, nx, W, R, T_thresh, cols, bic::Layout{span, off1, kb, db}};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)(W * W + 1) * sizeof(int32_t);
  for (int ti = 0; ti < ny; ++ti) {
    strict_grid2_kernel<<<nx, kThreads, 0, s>>>(
        (const uint32_t*)E, (unsigned long long*)pr2, p, ti * W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    strict_serial_kernel<<<1, kThreads, smem, s>>>(
        (uint32_t*)E, (const unsigned long long*)pr2, (const int32_t*)enb,
        (uint32_t*)gctx, (int32_t*)out, (int32_t*)resf, p, ti);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
