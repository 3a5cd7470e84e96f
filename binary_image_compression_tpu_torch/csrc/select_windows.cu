// Kernel K4: serial-scan selection over precomputed distance maps, one
// block per (tile, page).
//
// Replaces: binary_image_compression_tpu/ops/pallas_kernels.py
//           ::select_windows (kernel body make_select_kernel, the
//           masked-grid _selection_scalars).
//
// What it computes, per tile (i0, j0) of page b: over its [h, w] map, cell
// (r, c) being candidate (y, x) = (oy + r, ox + c), every cell inside the
// causal window (grid 1: rows max(i0-W,0)..i0, columns max(j0-R,0)..j0-W
// when j0 >= W; grid 2: rows max(i0-R,0)..i0-W, columns
// max(j0-R,0)..min(j0+R, cols-W)) gets K1's packed (stop, d', key, inv)
// priority; one min is the reference scan's outcome, decoded with the
// closed-form counts into 8 int32 outputs (bestd, dy = y - oy, inv, found,
// rank, n_cands, has_cands, x).  Cells outside the window are never read:
// the banded maps hold arbitrary values there.
//
// What bounds it on the H100: reading the maps from HBM.  At 512x512,
// W=64, R=128 a page has 64 maps of 129 x 321 int32 (10.6 MB); every cell
// is read once, so a page costs about 3 us of HBM bandwidth, and the
// block's arithmetic per cell (masks, key, priority) is a few dozen
// integer operations.
//
// What the design does about it: neighbouring threads take neighbouring
// cells of a map row, so the loads are coalesced; off-window cells skip
// their load; the minimum is the block-wide 64-bit reduction of
// packed_select.cuh.  The maps themselves are the larger cost: producing
// them (ops/search.py, PyTorch) moves W times more data than K4 reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_select.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  int T, h, w, nx, W, R, T_thresh, cols, invert;
  bic::Layout lay;
};

__global__ void __launch_bounds__(kThreads)
select_windows_kernel(const int32_t* __restrict__ d,
                      const int32_t* __restrict__ oyv,
                      const int32_t* __restrict__ oxv,
                      int32_t* __restrict__ out, Params p) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int W = p.W, R = p.R;
  const long long i0 = (long long)(t / p.nx) * W, j0 = (long long)(t % p.nx) * W;
  const long long oy = oyv[t], ox = oxv[t];
  const int32_t* D = d + ((size_t)b * p.T + t) * p.h * p.w;
  __shared__ unsigned long long wmin[kThreads / 32];

  const long long minj = j0 - R > 0 ? j0 - R : 0;
  const long long maxj2 = j0 - W > 0 ? j0 - W : 0;
  const long long maxj = j0 + R < p.cols - W ? j0 + R : p.cols - W;
  const long long lo1 = i0 - W > 0 ? i0 - W : 0;
  const long long lo2 = i0 - R > 0 ? i0 - R : 0;
  const int M = W * W;
  const int ncell = p.h * p.w;

  unsigned long long best = bic::kInf;
  for (int idx = threadIdx.x; idx < ncell; idx += kThreads) {
    const int r = idx / p.w;
    const long long y = oy + r, x = ox + (idx - r * p.w);
    const bool in1 = j0 >= W && y >= lo1 && y <= i0 && x >= minj && x <= maxj2;
    const bool in2 = y >= lo2 && y <= i0 - W && x >= minj && x <= maxj;
    if (!(in1 || in2)) continue;
    long long key = (long long)bic::kInf;
    if (in1) key = (i0 - y) * p.lay.span + (maxj2 - x);
    if (in2) {
      const long long k2 = p.lay.off1 + (i0 - W - y) * p.lay.span + (maxj - x);
      key = k2 < key ? k2 : key;
    }
    const unsigned long long pr = bic::packed_priority(
        __ldg(D + idx), key, M, p.T_thresh, p.invert, p.lay);
    best = pr < best ? pr : best;
  }

  best = bic::block_min_u64<kThreads>(best, wmin);
  if (threadIdx.x != 0) return;
  const bic::Selected s = bic::packed_decode(best, i0, j0, W, R, p.cols, p.lay);
  int32_t* o = out + ((size_t)b * p.T + t) * 8;
  o[0] = (int32_t)s.bestd;
  o[1] = s.found ? (int32_t)(s.y - oy) : 0;
  o[2] = s.inv;
  o[3] = s.found;
  o[4] = (int32_t)s.rank;
  o[5] = (int32_t)s.n_cands;
  o[6] = s.n_cands > 0 ? 1 : 0;
  o[7] = (int32_t)s.x;
}

}  // namespace

// d: int32 [B, T, h, w] maps; oy, ox: int32 [T] map origins; out: int32
// [B, T, 8].  Launches on `stream` and returns cudaGetLastError().
extern "C" int bic_select_windows(const void* d, const void* oy,
                                  const void* ox, void* out, int B, int T,
                                  int h, int w, int nx, int W, int R,
                                  int T_thresh, int cols, int invert,
                                  int span, int off1, int kb, int db,
                                  void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 64 || B > 65535 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{T, h, w, nx, W, R, T_thresh, cols, invert,
           bic::Layout{span, off1, kb, db}};
  dim3 grid((unsigned)T, (unsigned)B);
  select_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)d, (const int32_t*)oy, (const int32_t*)ox,
      (int32_t*)out, p);
  return (int)cudaGetLastError();
}
