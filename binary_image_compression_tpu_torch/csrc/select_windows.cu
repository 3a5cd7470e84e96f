// Kernel K4: the banded windowed Hamming search and serial-scan selection
// for tiles up to W = 64, read straight from the page's 64-bit row-field
// plane, and the plane kernel that builds that plane on the card.
//
// Replaces: binary_image_compression_tpu/ops/pallas_kernels.py
//           ::select_windows (kernel body make_select_kernel, the
//           masked-grid _selection_scalars) together with the distance maps
//           that feed it, binary_image_compression_tpu/ops/search.py
//           ::window_distance_maps_banded (XLA: im2col patches and one
//           banded matmul per tile row).
//
// What it computes, per tile (i0, j0) of page b: for every candidate (y, x)
// of the causal window (grid 1: rows max(i0-W,0)..i0, columns
// max(j0-R,0)..j0-W when j0 >= W; grid 2: rows max(i0-R,0)..i0-W, columns
// max(j0-R,0)..min(j0+R, cols-W)), d = sum_a popc(E[y+a][x] ^ E[i0+a][j0])
// over the W-bit row-field plane E (one uint64 per field), then K1's
// serial scan as ONE min over the 64-bit packed priority, decoded into the
// 8 int32 outputs (bestd, dy = y - oy, inv, found, rank, n_cands,
// has_cands, x) with oy the banded route's origin
// (ops/search.py::banded_origins, equal to K1's band origin over a plane of
// plane_height rows).  No distance map is formed.
//
// What bounds it on the H100: popcount issue, not HBM.  At doc512 (W=64,
// R=128) a page has 832 K windows of 64 rows: 106.5 M 32-bit popcounts
// (utils/roofline.k4_work), 0.0255 ms at 16 per clock per SM; the plane
// is 2 MB and stays in L2.  A page has only 64 tiles of that size, so one
// block per tile would leave half the card idle.
//
// What the design does about it:
//  * An item is one candidate column x and a run of kRun consecutive window
//    rows (K1's order of work); neighbouring threads take neighbouring
//    columns, so a row load is one coalesced line per warp.
//  * The tile's W fields sit in shared memory (at W = 64 they would take
//    128 registers).  A thread walks the tile rows a = 0..W-1: it reads
//    tile row a once (every lane reads the same word, a broadcast) and
//    XORs it with the kRun candidate rows a..a+kRun-1 it holds in a ring of
//    registers, then loads the one candidate row the next step needs.  So
//    kRun windows cost kRun + W - 1 global loads, W shared loads and
//    kRun * W __popcll.
//  * A column's valid window rows form one interval whose scan key falls
//    as y grows (K1's argument, tests/test_torch_k4_banded.py), so a run's
//    winner is found by 32-bit compares (bic::run_best) and only its
//    64-bit priority is formed.
//  * Each tile's items are spread over `slices` blocks, enough that a single
//    page fills the card; the blocks merge their minimum by atomicMin into
//    a [B, T] scratch word, and a second small kernel decodes each tile's
//    minimum.  Blocks are taken bottom tile row first, the heaviest first.
//  * The run length, the block size, the blocks per launch and the order
//    are those that scripts/k4_variants.py timed fastest: runs of 6 beat
//    runs of 4, 8 and 12 at 256 threads on doc512 at W = 64 and 40 and on
//    a letter page; a doc512 page at W = 64 takes 23 blocks per tile.
//  * Instances for W = 64 (the ring's steps fully unrolled) and one with a
//    run-time W for every other W <= 64 (the W > 32 tiles and the W <= 32
//    shapes outside K1's band budget).
//  * The plane kernel builds E from the pages' 0/1 bytes, one thread per
//    field and three warp ballots per 32 fields, with the zero rows below the
//    grid that keep a bottom tile's band inside the plane.
//  * As in K1, the tiles start at frame row row0 and the windows, the top
//    clamp and the keys use absolute rows (frame row + y_base): under tile
//    sharding the frame is R halo rows, then the shard's tile rows (row0 =
//    R, y_base = the shard's first row - R).  The search loads through the
//    plane's pointer moved by -y_base rows, so its loop indexes absolute
//    rows exactly as the whole-page search does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_select.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kRun = 6;            // window rows per item
constexpr int kBlocksTarget = 2112;  // blocks per launch to aim for (132 x 16)

struct Params {
  int He, We, nx, T, W, R, T_thresh, cols, invert, slices, y_base, row0;
  bic::Layout lay;
};

// d[l] = Hamming distance between the tile (fields tf, in shared memory)
// and the window whose top row is y0 + l, for l < L, on one column; ld(r)
// returns the candidate field of row y0 + r.  Candidate row r lives in ring
// slot r % L while steps r-L+1 .. r use it.
template <int L, class Ld>
__device__ __forceinline__ void window_dists64(Ld ld, const u64* tf, int W,
                                               int (&d)[L]) {
  u64 f[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    d[l] = 0;
    f[l] = ld(l);
  }
#pragma unroll
  for (int a0 = 0; a0 < W; a0 += L) {
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const int a = a0 + s;
      if (a < W) {
        const u64 t = tf[a];
#pragma unroll
        for (int l = 0; l < L; ++l) d[l] += __popcll(f[(s + l) % L] ^ t);
        if (a + 1 < W) f[s] = ld(a + L);
      }
    }
  }
}

// kW: the tile width, or 0 for the run-time-W instance.  best: u64 [B, T],
// all ones before the launch.
template <int kW>
__global__ void __launch_bounds__(kThreads)
banded_search_kernel(const u64* __restrict__ E, u64* __restrict__ best_out,
                     Params p) {
  const int W = kW ? kW : p.W, R = p.R;
  // bottom tile row first: the heaviest tiles start first
  const int t = p.T - 1 - (int)(blockIdx.x / p.slices);
  const int slice = (int)(blockIdx.x % p.slices), b = blockIdx.y;
  // frame rows: the tile, and its band origin clipped inside the plane
  const int i0 = p.row0 + (t / p.nx) * W, j0 = (t % p.nx) * W;
  const int oy = min(max(i0 - R, 0), max(p.He - W - R, 0));
  const u64* Eb = E + (size_t)b * p.He * p.We;

  __shared__ u64 tf[64];
  __shared__ u64 wmin[kThreads / 32];
  if (threadIdx.x < W) tf[threadIdx.x] = Eb[(size_t)(i0 + threadIdx.x) * p.We + j0];
  __syncthreads();

  // absolute rows (frame row + y_base) for the windows, the keys and the
  // loads: absolute row y of the plane is row y of Ea
  const int i0a = i0 + p.y_base, oya = oy + p.y_base;
  const u64* Ea = Eb - (long long)p.y_base * p.We;
  const int minj = max(j0 - R, 0), maxj = min(j0 + R, p.cols - W);
  // every column's window rows start at ya; they end at i0a where the
  // column is in grid 1 too, else at i0a - W, and within the band
  const int ya = max(max(i0a - R, 0), oya);
  const int yhi = min(i0a, oya + R);
  const int ncol = maxj - minj + 1;
  const int n = ncol > 0 && yhi >= ya ? (yhi - ya + kRun) / kRun * ncol : 0;

  u64 best = bic::kInf;
  const int first = slice * kThreads + (int)threadIdx.x;
  if (first < n) {
    // item idx = q * ncol + c (run q, column c), stepped by every slice's
    // threads
    const int step = kThreads * p.slices;
    const int dq = step / ncol, dc = step - dq * ncol;
    int q = first / ncol, c = first - q * ncol;
    for (int idx = first; idx < n; idx += step) {
      const int x = minj + c, y0 = ya + q * kRun;
      const bool g1 = j0 >= W && x <= j0 - W;
      const int ylast = min(g1 ? i0a : i0a - W, oya + R);
      if (y0 <= ylast) {
        const u64* col = Ea + x;
        const int ymax = p.He - 1 + p.y_base;  // the plane's last row
        auto ld = [&](int r) {
          return __ldg(col + (long long)min(y0 + r, ymax) * p.We);
        };
        int d[kRun];
        window_dists64<kRun>(ld, tf, W, d);
        const u64 pr = bic::run_best<kRun>(
            d, y0, ylast, W * W, p.T_thresh, p.invert,
            [&](int y) -> long long {
              return g1 && y >= i0a - W
                         ? (long long)(i0a - y) * p.lay.span + (j0 - W - x)
                         : p.lay.off1 + (long long)(i0a - W - y) * p.lay.span +
                               (maxj - x);
            },
            p.lay);
        best = pr < best ? pr : best;
      }
      q += dq;
      c += dc;
      if (c >= ncol) { c -= ncol; ++q; }
    }
  }

  best = bic::block_min_u64<kThreads>(best, wmin);
  if (threadIdx.x == 0 && best < bic::kInf)
    atomicMin(best_out + (size_t)b * p.T + t, best);
}

// One thread per (page, tile): decode the merged minimum.
__global__ void banded_decode_kernel(const u64* __restrict__ best,
                                     int32_t* __restrict__ out, int B,
                                     Params p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * p.T) return;
  const int t = (int)(i % p.T);
  // the band origin in frame rows, then the tile and band in absolute rows
  const long long i0 = p.row0 + (long long)(t / p.nx) * p.W;
  const long long j0 = (long long)(t % p.nx) * p.W;
  const long long oyr = i0 - p.R > 0 ? i0 - p.R : 0;
  const long long oymax = p.He - p.W - p.R > 0 ? p.He - p.W - p.R : 0;
  const long long oya = (oyr < oymax ? oyr : oymax) + p.y_base;
  const bic::Selected s = bic::packed_decode(best[i], i0 + p.y_base, j0, p.W,
                                             p.R, p.cols, p.lay);
  int32_t* o = out + i * 8;
  o[0] = (int32_t)s.bestd;
  o[1] = s.found ? (int32_t)(s.y - oya) : 0;
  o[2] = s.inv;
  o[3] = s.found;
  o[4] = (int32_t)s.rank;
  o[5] = (int32_t)s.n_cands;
  o[6] = s.n_cands > 0 ? 1 : 0;
  o[7] = (int32_t)s.x;
}

// E[b][y][x] = img[b][y][x .. x+W) as bits W-1 .. 0, for y < He and x < gw;
// rows past gh and pixels past the right edge read 0.  A warp takes 32
// neighbouring fields of one row: three ballots give pixels x0 .. x0+95,
// and each lane cuts its 64 bits out of them.  Rows `rows` = B * He,
// strided over gridDim.y.
__global__ void banded_plane_kernel(const uint8_t* __restrict__ img,
                                    u64* __restrict__ E, int gh, int gw,
                                    int He, int W, int rows) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int y = row % He;
    const uint8_t* r = img + ((size_t)(row / He) * gh + y) * gw;
    const bool in = y < gh;
    const u64 lo =
        __ballot_sync(bic::kFull, in && x < gw && r[x]) |
        (u64)__ballot_sync(bic::kFull, in && x + 32 < gw && r[x + 32]) << 32;
    const u64 hi = __ballot_sync(bic::kFull, in && x + 64 < gw && r[x + 64]);
    // pixels x .. x+63 at bits 0 .. 63, then pixel x + a at bit W-1-a
    const u64 v = lane ? (lo >> lane) | (hi << (64 - lane)) : lo;
    if (x < gw) E[(size_t)row * gw + x] = __brevll(v) >> (64 - W);
  }
}

}  // namespace

// img: 0/1 bytes [B, gh, gw]; E: uint64 [B, He, gw], He >= gh.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int bic_banded_plane(const void* img, void* E, int B, int gh,
                                int gw, int He, int W, void* stream) {
  if (B <= 0 || gh <= 0 || gw <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 64 || He < gh || (long long)B * He > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int rows = B * He;
  const dim3 grid((unsigned)((gw + 255) / 256),
                  (unsigned)(rows < 65535 ? rows : 65535));
  banded_plane_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (u64*)E, gh, gw, He, W, rows);
  return (int)cudaGetLastError();
}

// E: uint64 [B, He, We] field planes; best: uint64 [B, T] scratch; out:
// int32 [B, T, 8].  The T / nx tile rows start at frame row row0; y_base
// is the absolute row of frame row 0.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int bic_select_windows(const void* E, void* best, void* out,
                                  int B, int He, int We, int nx, int T, int W,
                                  int R, int T_thresh, int cols, int invert,
                                  int y_base, int row0, int span, int off1,
                                  int kb, int db, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 64 || R < W || B > 65535 || He < W + R || nx <= 0 ||
      row0 < 0 || row0 + (T / nx) * W > He)
    return (int)cudaErrorInvalidValue;
  // slices per tile: enough blocks to fill the card, but no more than the
  // fullest tile's items fill (its window rows are at most R + 1)
  const long long items = (long long)((R + kRun) / kRun) * (2 * R + 1);
  const long long want = (kBlocksTarget + (long long)T * B - 1) / ((long long)T * B);
  const long long cap = (items + kThreads - 1) / kThreads;
  long long slices = want < cap ? want : cap;
  slices = slices < 1 ? 1 : slices;
  if ((long long)T * slices > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Params p{He, We, nx, T, W, R, T_thresh, cols, invert, (int)slices, y_base,
           row0, bic::Layout{span, off1, kb, db}};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(best, 0xff, sizeof(u64) * (size_t)B * T, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(T * slices), (unsigned)B);
  const u64* e = (const u64*)E;
  u64* bo = (u64*)best;
  if (W == 64)
    banded_search_kernel<64><<<grid, kThreads, 0, s>>>(e, bo, p);
  else
    banded_search_kernel<0><<<grid, kThreads, 0, s>>>(e, bo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * T;
  banded_decode_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      bo, (int32_t*)out, B, p);
  return (int)cudaGetLastError();
}
