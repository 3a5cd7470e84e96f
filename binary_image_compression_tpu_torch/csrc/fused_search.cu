// Kernel K1: windowed Hamming search + serial-scan selection, one block per
// (tile, page).
//
// Replaces: binary_image_compression_tpu/ops/pallas_kernels.py
//           ::fused_search_select (kernel body `kernel`), including the
//           masked-grid `_selection_scalars` path it takes when the 32-bit
//           packed priority does not fit.
//
// What it computes, per tile (i0, j0) of page b: for every candidate (y, x)
// of the causal window (grid 1: rows max(i0-W,0)..i0, columns
// max(j0-R,0)..j0-W when j0 >= W; grid 2: rows max(i0-R,0)..i0-W, columns
// max(j0-R,0)..min(j0+R, cols-W)), d = sum_a popc(E[y+a][x] ^ E[i0+a][j0])
// over the W-bit row-field plane E, then the reference serial scan as ONE
// min over a 64-bit priority
//     stop ? key << (db+1) | d' << 1 | inv : FLAG | d' << (kb+1) | key << 1 | inv
// and a scalar decode of the winner into 8 int32 outputs
// (bestd, dy, inv, found, rank, n_cands, has_cands, dx), with the
// closed-form n_cands and rank of pallas_kernels.py::_packed_decode.
//
// What bounds it on the H100: load and popcount issue, not HBM.  At
// 512x512, W=16, R=128 each tile scores up to 129 x 257 candidates with 16
// row loads each (~0.5 M loads per tile, ~0.5 G per page), all from the
// page's 1 MB plane, which stays resident in the 50 MB L2.  The TPU kernel's
// VMEM band (136 x 512 x 4 B = 278 KB per tile row) does not fit the 227 KB a
// block may use, so the plane is read through L1/L2 instead.
//
// What the design does about it: neighbouring threads take neighbouring
// columns x of one candidate row, so each of the W row loads is one
// coalesced 128-byte line per warp and rows are reused through L1 by the
// candidate rows above and below; off-window candidates skip their loads;
// the tile's own W fields sit in shared memory.  The block minimum is two
// 32-bit __reduce_min_sync per warp (high word, then low word among the
// lanes holding the high minimum) and a shared-memory pass over the warps
// (packed_select.cuh, shared with K3 and K4).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_select.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  int He, We, nx, T, W, R, T_thresh, cols, invert, y_base;
  bic::Layout lay;
};

__global__ void __launch_bounds__(kThreads)
fused_search_select_kernel(const uint32_t* __restrict__ E,
                           int32_t* __restrict__ out, Params p) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int W = p.W, R = p.R;
  const int i0 = (t / p.nx) * W, j0 = (t % p.nx) * W;
  const int oy = min(max(i0 - R, 0), max(p.He - W - R, 0));
  const uint32_t* Eb = E + (size_t)b * p.He * p.We;

  __shared__ uint32_t tf[32];
  __shared__ unsigned long long wmin[kThreads / 32];
  if (threadIdx.x < W) tf[threadIdx.x] = Eb[(size_t)(i0 + threadIdx.x) * p.We + j0];
  __syncthreads();

  // masks and scan keys use absolute rows (y_base), loads frame rows
  const long long i0a = (long long)i0 + p.y_base;
  const long long oya = (long long)oy + p.y_base;
  const long long minj = max(j0 - R, 0), maxj2 = max(j0 - W, 0);
  const long long maxj = min(j0 + R, p.cols - W);
  const long long lo1 = i0a - W > 0 ? i0a - W : 0;
  const long long lo2 = i0a - R > 0 ? i0a - R : 0;
  const int M = W * W;
  const int ncol = 2 * R + 1;
  const int ncand = (R + 1) * ncol;

  unsigned long long best = bic::kInf;
  for (int idx = threadIdx.x; idx < ncand; idx += kThreads) {
    const int r = idx / ncol;
    const long long x = (long long)j0 - R + (idx - r * ncol);
    const long long y = oya + r;
    const bool in1 = j0 >= W && y >= lo1 && y <= i0a && x >= minj && x <= maxj2;
    const bool in2 = y >= lo2 && y <= i0a - W && x >= minj && x <= maxj;
    if (!(in1 || in2)) continue;
    long long key = (long long)bic::kInf;
    if (in1) key = (i0a - y) * p.lay.span + (maxj2 - x);
    if (in2) {
      const long long k2 = p.lay.off1 + (i0a - W - y) * p.lay.span + (maxj - x);
      key = k2 < key ? k2 : key;
    }
    const uint32_t* col = Eb + (size_t)(oy + r) * p.We + x;
    int d = 0;
    for (int a = 0; a < W; ++a) d += __popc(__ldg(col + (size_t)a * p.We) ^ tf[a]);
    const unsigned long long pr =
        bic::packed_priority(d, key, M, p.T_thresh, p.invert, p.lay);
    best = pr < best ? pr : best;
  }

  best = bic::block_min_u64<kThreads>(best, wmin);
  if (threadIdx.x != 0) return;
  const bic::Selected s = bic::packed_decode(best, i0a, j0, W, R, p.cols, p.lay);
  int32_t* o = out + ((size_t)b * p.T + t) * 8;
  o[0] = (int32_t)s.bestd;
  o[1] = s.found ? (int32_t)(s.y - oya) : 0;
  o[2] = s.inv;
  o[3] = s.found;
  o[4] = (int32_t)s.rank;
  o[5] = (int32_t)s.n_cands;
  o[6] = s.n_cands > 0 ? 1 : 0;
  o[7] = (int32_t)s.x;
}

}  // namespace

// E: uint32 [B, He, We] field planes; out: int32 [B, T, 8].  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int bic_fused_search_select(const void* E, void* out, int B,
                                       int He, int We, int nx, int T, int W,
                                       int R, int T_thresh, int cols,
                                       int invert, int y_base, int span,
                                       int off1, int kb, int db,
                                       void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 32 || B > 65535) return (int)cudaErrorInvalidValue;
  Params p{He, We, nx, T, W, R, T_thresh, cols, invert, y_base,
           bic::Layout{span, off1, kb, db}};
  dim3 grid((unsigned)T, (unsigned)B);
  fused_search_select_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)E, (int32_t*)out, p);
  return (int)cudaGetLastError();
}
