// Kernel K1: the causal windowed Hamming search and serial-scan selection,
// one block per (tile, page), and the W-bit row-field plane it searches,
// built on the card.
//
// Replaces: binary_image_compression_tpu/ops/pallas_kernels.py
//           ::fused_search_select (kernel body `kernel`, and `_field_plane`,
//           which it runs before its pallas_call), including the
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
// What bounds it on the H100: popcount and load issue, not HBM.  At doc512
// (W=16, R=128) a page has 23.2 M windows of 8 popcounts each: 186 M
// popcounts, 0.044 ms at 16 per clock per SM (utils/roofline).  The page's
// plane is 1 MB (32 MB at batch 32) and stays resident in the 50 MB L2, so
// every row load hits L1 or L2; what costs is the instructions issued per
// window.
//
// What the design does about it (the window scoring of K3's grid-2 pass,
// shared through packed_select.cuh):
//  * An item is one candidate column x and a run of kRun = 12 consecutive
//    window rows; neighbouring threads take neighbouring columns, so a row
//    load is one coalesced line per warp.  Items advance without a
//    division.
//  * The tile's fields sit in registers, packed as the candidate words are,
//    and a thread slides down its column: kRun windows cost kRun + W - 1
//    loads, not kRun * W.  For W <= 16, K = 32 / W fields of consecutive
//    rows share one 32-bit word: W / K popcounts per window (8 at W = 16).
//  * Within a column the valid window rows form one interval (grid 2, then
//    grid 1 from i0-W to i0 where x <= j0-W), and the scan key falls
//    strictly as y grows: every grid-1 key is below off1 and every grid-2
//    key at or above it.  So a run's winner is found by 32-bit compares
//    (run_best) and only its 64-bit priority is formed.
//  * Masks and keys use absolute rows (y_base, negative under tile
//    sharding); loads use frame rows, clamped inside the plane.  The tiles
//    start at frame row row0: under tile sharding (parallel/tileshard.py)
//    the frame is R halo rows from the shards above, then the shard's own
//    tile rows, so row0 = R; a whole page has row0 = 0.
//  * The block minimum is block_min_u64; thread 0 decodes it.  There is no
//    chain, so no atomics: at doc512 a page is 1,024 blocks of 256 threads
//    (a batch of 32 is 32,768), taken bottom tile row first, since the
//    tiles near the top have fewer window rows.  The run length, the block
//    size and the order are those that scripts/k1_variants.py timed
//    fastest for one page; they trade a few per cent at batch 32 against
//    128 threads.
//  * Instances for W = 8, 16 and 32; every other W <= 32 takes one instance
//    with a run-time W, one field per word and the tile's fields read from
//    shared memory.
//  * The plane kernel builds E from the pages' 0/1 bytes, one thread per
//    field and two warp ballots per 32 fields, with the zero rows below the
//    grid that keep a bottom tile's band inside the plane
//    (ops/fused_search.py::plane_height).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 12;  // window rows per item

struct Params {
  int He, We, nx, T, W, R, T_thresh, cols, invert, y_base, row0;
  bic::Layout lay;
};

// window_dists for a run-time W: one field per word, the tile's fields tf
// in shared memory.
template <int L, class Ld>
__device__ __forceinline__ void window_dists_any(Ld ld, const uint32_t* tf,
                                                 int W, int (&d)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) d[l] = 0;
  for (int r = 0; r < L + W - 1; ++r) {
    const uint32_t f = ld(r);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int a = r - l;
      if (a >= 0 && a < W) d[l] += __popc(f ^ tf[a]);
    }
  }
}

// kW: the tile width, or 0 for the run-time-W instance.
template <int kW>
__global__ void __launch_bounds__(kThreads)
fused_search_kernel(const uint32_t* __restrict__ E, int32_t* __restrict__ out,
                    Params p) {
  const int W = kW ? kW : p.W, R = p.R;
  // bottom tile row first: the heaviest tiles start first and the light
  // top rows (fewer window rows above them) fill the tail
  const int t = p.T - 1 - blockIdx.x, b = blockIdx.y;
  // frame rows: the tile, and its band origin clipped inside the plane
  const int i0 = p.row0 + (t / p.nx) * W, j0 = (t % p.nx) * W;
  const int oy = min(max(i0 - R, 0), max(p.He - W - R, 0));
  const uint32_t* Eb = E + (size_t)b * p.He * p.We;

  __shared__ uint32_t tf[32];
  __shared__ unsigned long long wmin[kThreads / 32];
  if (threadIdx.x < W) tf[threadIdx.x] = Eb[(size_t)(i0 + threadIdx.x) * p.We + j0];
  __syncthreads();

  // absolute rows (frame row + y_base) for the masks and keys
  const int i0a = i0 + p.y_base, oya = oy + p.y_base;
  const int minj = max(j0 - R, 0), maxj = min(j0 + R, p.cols - W);
  // every column's window rows start at ya; they end at i0a where the
  // column is in grid 1 too, else at i0a - W, and within the band
  const int ya = max(max(i0a - R, 0), oya);
  const int yhi = min(i0a, oya + R);
  const int ncol = maxj - minj + 1;
  const int n = ncol > 0 && yhi >= ya ? (yhi - ya + kRun) / kRun * ncol : 0;

  uint32_t tp[kW ? bic::Geo<kW ? kW : 1>::NP : 1];
  if constexpr (kW > 0) bic::pack_tile<kW>([&](int a) { return tf[a]; }, tp);

  unsigned long long best = bic::kInf;
  if (n > 0) {
    // item idx = q * ncol + c (run q, column c), stepped by kThreads
    const int dq = kThreads / ncol, dc = kThreads - dq * ncol;
    int q = threadIdx.x / ncol, c = threadIdx.x - q * ncol;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int x = minj + c, y0 = ya + q * kRun;
      const bool g1 = j0 >= W && x <= j0 - W;
      const int ylast = min(g1 ? i0a : i0a - W, oya + R);
      if (y0 <= ylast) {
        const uint32_t* col = Eb + x;
        const int f0 = y0 - p.y_base, fmax = p.He - 1;  // frame rows
        auto ld = [&](int r) {
          return __ldg(col + (size_t)min(f0 + r, fmax) * p.We);
        };
        int d[kRun];
        if constexpr (kW > 0) bic::window_dists<kW, kRun>(ld, tp, d);
        else window_dists_any<kRun>(ld, tf, W, d);
        const unsigned long long pr = bic::run_best<kRun>(
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

// E[b][y][x] = img[b][y][x .. x+W) as bits W-1 .. 0, for y < He and x < gw;
// rows past gh and pixels past the right edge read 0.  A warp takes 32
// neighbouring fields of one row: two ballots give pixels x0 .. x0+63 as
// the bits of one word, and each lane cuts its W bits out of it, so a field
// costs two byte loads.  Rows `rows` = B * He, strided over gridDim.y.
__global__ void field_plane_kernel(const uint8_t* __restrict__ img,
                                   uint32_t* __restrict__ E, int gh, int gw,
                                   int He, int W, int rows) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int y = row % He;
    const uint8_t* r = img + ((size_t)(row / He) * gh + y) * gw;
    const bool in = y < gh;
    const unsigned long long bits =
        __ballot_sync(bic::kFull, in && x < gw && r[x]) |
        (unsigned long long)__ballot_sync(bic::kFull,
                                          in && x + 32 < gw && r[x + 32])
            << 32;
    // pixel x + a at bit a, then at bit W-1-a
    const uint32_t v = __brev((uint32_t)(bits >> lane)) >> (32 - W);
    if (x < gw) E[(size_t)row * gw + x] = v;
  }
}

}  // namespace

// img: 0/1 bytes [B, gh, gw]; E: uint32 [B, He, gw], He >= gh.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int bic_field_plane(const void* img, void* E, int B, int gh,
                               int gw, int He, int W, void* stream) {
  if (B <= 0 || gh <= 0 || gw <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 32 || He < gh || (long long)B * He > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int rows = B * He;
  const dim3 grid((unsigned)((gw + 255) / 256), (unsigned)(rows < 65535 ? rows : 65535));
  field_plane_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (uint32_t*)E, gh, gw, He, W, rows);
  return (int)cudaGetLastError();
}

// E: uint32 [B, He, We] field planes; out: int32 [B, T, 8].  The T / nx
// tile rows start at frame row row0; y_base is the absolute row of frame
// row 0.  Launches on `stream` and returns cudaGetLastError().
extern "C" int bic_fused_search_select(const void* E, void* out, int B,
                                       int He, int We, int nx, int T, int W,
                                       int R, int T_thresh, int cols,
                                       int invert, int y_base, int row0,
                                       int span, int off1, int kb, int db,
                                       void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 32 || R < W || B > 65535 || nx <= 0 || row0 < 0 ||
      row0 + (T / nx) * W > He)
    return (int)cudaErrorInvalidValue;
  Params p{He, We, nx, T, W, R, T_thresh, cols, invert, y_base, row0,
           bic::Layout{span, off1, kb, db}};
  dim3 grid((unsigned)T, (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* e = (const uint32_t*)E;
  int32_t* o = (int32_t*)out;
  switch (W) {
    case 8: fused_search_kernel<8><<<grid, kThreads, 0, s>>>(e, o, p); break;
    case 16: fused_search_kernel<16><<<grid, kThreads, 0, s>>>(e, o, p); break;
    case 32: fused_search_kernel<32><<<grid, kThreads, 0, s>>>(e, o, p); break;
    default: fused_search_kernel<0><<<grid, kThreads, 0, s>>>(e, o, p);
  }
  return (int)cudaGetLastError();
}
