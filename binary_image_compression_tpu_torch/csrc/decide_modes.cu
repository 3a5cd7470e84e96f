// Kernel K2: per-tile mode decision with two adaptive Golomb contexts, one
// warp per page, in speculative rounds over windows of 32 tiles.
//
// Replaces: binary_image_compression_tpu/ops/pallas_decide.py::decide_modes
//           (kernel body `_make_kernel`).
//
// What it computes, per page, serially over its T tiles in raster order: the
// first minimum of four costs {match, nomatch} x {nonpred, pred}
//     match:   mcost + idx_len + k_m + (w >> k_m) + 1 + enb[w]  (if has_cands)
//     nomatch: ncost + k_n + (w >> k_n) + 1 + enb[w]
// then the chosen weight updates that mode's context (GolombCoder.cpp:29-33:
// n += 1, acc += w, both mod 2^32; k = least k in 0..31 with
// (n << k) mod 2^32 >= acc, else 31; k starts at 1).  Output per tile:
// (mode, weight, k_used) as int32 [B, T, 3].
//
// What bounds it on the H100: the chain through the two contexts.  Its bytes
// (40 per tile) are nothing to the card; a page is one warp, and its time
// is the number of dependent steps times their latency.  The serial design
// (scripts/k2_serial.cu: one dependent step per tile, 6 shuffles, 4 shared
// loads, 4 costs and a warp vote for k) takes ~200 clocks a tile, 1,024
// steps per 512x512 page at W = 16.
//
// What the design does about it: a tile's costs depend on the running state
// only through the two current ks, and k changes rarely.  Lane s holds tile
// base + s of a window of 32, with its weights and its costs less the
// Golomb terms prepared a window ahead (enb from shared memory) from inputs
// loaded a window before that.  A round decides every undecided tile
// of the window at once under the current (k_m, k_n): a ballot of "match"
// with a popcount under the lane mask gives each lane its context's n after
// its tile, and one inclusive warp scan of a word holding both contexts'
// weights (16-bit halves while 32 * M < 2^16, else 32-bit halves) its acc.
// Each lane takes its context's new k by golomb_k_lane (no vote), and the
// first lane f whose k differs from its context's k ends the round: every
// tile up to f was decided with the right ks, so it is committed, the state
// after f is taken from lane f, and the next round starts at f + 1.  The
// time is rounds x one round's latency (~480 clocks) plus ~280 clocks per
// window; a 512x512 page at W = 16 takes 37 rounds where it took 1,024
// steps.  The guard: when k changes on every tile, a round commits one
// tile; after kShortRounds rounds in a row that commit fewer than `guard`
// tiles, the rest of the window (up to kBurst tiles) is decided by a lean
// serial step (inputs shuffled from the lanes' prepared registers one tile
// ahead, golomb_k_lane, no vote), and rounds go on.  ops/decide.py::
// decide_rounds_model is the numpy model of this order of work; `rounds`,
// when not null, receives each page's number of rounds, which it predicts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "packed_select.cuh"

namespace {

using bic::kFull;
constexpr int kBig = 1 << 28;
constexpr int kMaxEnb = 64 * 64 + 1;
constexpr int kShortRounds = 2;  // short rounds in a row before a burst
constexpr int kBurst = 32;       // tiles a burst decides serially, at most

// A tile's inputs as loaded, and as a round uses them: mode i costs
// p[i] + k + (w[i] >> k), with p = kBig for an absent mode (c2 is always
// present and below kBig, so an absent mode never wins).
struct Raw {
  int4 w;
  int h, l;
};

struct Tile {
  int w[4], p[4];
};

__device__ __forceinline__ Raw load_raw(const int4* W4, const int32_t* HC,
                                        const int32_t* IL, int t, int T) {
  Raw r{make_int4(0, 0, 0, 0), 0, 0};
  if (t < T) {
    r.w = W4[t];
    r.h = HC[t];
    r.l = IL[t];
  }
  return r;
}

__device__ __forceinline__ Tile prepare(const Raw& r, const int32_t* s_enb,
                                        int use_pred, int mcost, int ncost) {
  Tile x;
  x.w[0] = r.w.x; x.w[1] = r.w.y; x.w[2] = r.w.z; x.w[3] = r.w.w;
  const int m = mcost + r.l + 1;
  x.p[0] = r.h ? m + s_enb[x.w[0]] : kBig;
  x.p[1] = (r.h && use_pred) ? m + s_enb[x.w[1]] : kBig;
  x.p[2] = ncost + 1 + s_enb[x.w[2]];
  x.p[3] = use_pred ? ncost + 1 + s_enb[x.w[3]] : kBig;
  return x;
}

// The first-minimum mode of a tile under (km, kn), and its weight.
__device__ __forceinline__ void choose(const Tile& x, int km, int kn,
                                       int& mode, int& weight) {
  int best = x.p[0] + km + (x.w[0] >> km);
  mode = 0;
  weight = x.w[0];
  const int c1 = x.p[1] + km + (x.w[1] >> km);
  if (c1 < best) { mode = 1; best = c1; weight = x.w[1]; }
  const int c2 = x.p[2] + kn + (x.w[2] >> kn);
  if (c2 < best) { mode = 2; best = c2; weight = x.w[2]; }
  const int c3 = x.p[3] + kn + (x.w[3] >> kn);
  if (c3 < best) { mode = 3; weight = x.w[3]; }
}

// The round's sums per context: match weights in the low half, nomatch in
// the high half of one word; 32 bits while 32 weights of either context fit
// in 16 (M <= 2047, W <= 45), else 64.
template <bool kNarrow>
struct Sums {
  using T = typename std::conditional<kNarrow, unsigned,
                                      unsigned long long>::type;
  static constexpr int kShift = kNarrow ? 16 : 32;
  static __device__ __forceinline__ T pack(bool match, int w) {
    return match ? (T)w : (T)w << kShift;
  }
  static __device__ __forceinline__ unsigned lo(T v) {
    return (unsigned)(v & (((T)1 << kShift) - 1));
  }
  static __device__ __forceinline__ unsigned hi(T v) {
    return (unsigned)(v >> kShift);
  }
};

template <bool kNarrow>
__global__ void __launch_bounds__(32)
decide_modes_kernel(const int32_t* __restrict__ w4,
                    const int32_t* __restrict__ hc,
                    const int32_t* __restrict__ il,
                    const int32_t* __restrict__ enb,
                    int32_t* __restrict__ out, int32_t* __restrict__ rounds,
                    int T, int n_enb, int use_pred, int mcost, int ncost,
                    int guard) {
  using S = Sums<kNarrow>;
  extern __shared__ int32_t s_enb[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int4* W4 = reinterpret_cast<const int4*>(w4) + (size_t)b * T;
  const int32_t* HC = hc + (size_t)b * T;
  const int32_t* IL = il + (size_t)b * T;
  int32_t* O = out + (size_t)b * T * 3;

  // the first two windows' loads go out before the enb copy
  const Raw first = load_raw(W4, HC, IL, lane, T);
  Raw raw = load_raw(W4, HC, IL, 32 + lane, T);
  for (int i = lane; i < n_enb; i += 32) s_enb[i] = enb[i];
  __syncwarp();
  Tile nxt = prepare(first, s_enb, use_pred, mcost, ncost);
  const unsigned le = kFull >> (31 - lane);  // lanes 0..lane

  unsigned m_acc = 0, m_n = 0, n_acc = 0, n_n = 0;
  int m_k = 1, n_k = 1;  // Golomb.h constructor: k starts at 1
  int n_rounds = 0, n_short = 0;
  for (int base = 0; base < T; base += 32) {
    const Tile cur = nxt;
    nxt = prepare(raw, s_enb, use_pred, mcost, ncost);
    raw = load_raw(W4, HC, IL, base + 64 + lane, T);
    const int n_here = min(32, T - base);
    int my_mode = 0, my_weight = 0, my_k = 0;
    int lo = 0;  // the window's first undecided lane
    while (lo < n_here) {
      const bool active = lane >= lo && lane < n_here;
      int mode, weight;
      choose(cur, m_k, n_k, mode, weight);
      const bool match = mode < 2;
      const unsigned bm = __ballot_sync(kFull, active && match);
      const unsigned bn = __ballot_sync(kFull, active && !match);
      typename S::T v = active ? S::pack(match, weight) : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const typename S::T y = __shfl_up_sync(kFull, v, d);
        v += lane >= d ? y : 0;
      }
      const unsigned n_after =
          match ? m_n + __popc(bm & le) : n_n + __popc(bn & le);
      const unsigned acc_after = match ? m_acc + S::lo(v) : n_acc + S::hi(v);
      const int k_ctx = match ? m_k : n_k;
      const int k_new = bic::golomb_k_lane(n_after, acc_after);
      const unsigned fb = __ballot_sync(kFull, active && k_new != k_ctx);
      const int f = fb ? __ffs(fb) - 1 : n_here - 1;
      if (active && lane <= f) {
        my_mode = mode;
        my_weight = weight;
        my_k = k_ctx;
      }
      const typename S::T vf = __shfl_sync(kFull, v, f);
      const int kf = __shfl_sync(kFull, k_new, f);
      const unsigned lef = kFull >> (31 - f);
      m_n += __popc(bm & lef);
      n_n += __popc(bn & lef);
      m_acc += S::lo(vf);
      n_acc += S::hi(vf);
      const bool f_match = (bm >> f) & 1u;
      m_k = fb && f_match ? kf : m_k;
      n_k = fb && !f_match ? kf : n_k;
      ++n_rounds;
      n_short = f + 1 - lo < guard ? n_short + 1 : 0;
      lo = f + 1;
      if (n_short >= kShortRounds && lo < n_here) {
        // the lean serial step for up to kBurst tiles, the state replicated
        // in every lane; tile s + 1's inputs are shuffled in while tile s
        // is decided
        const int stop = min(lo + kBurst, n_here);
        Tile x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x.w[i] = __shfl_sync(kFull, cur.w[i], lo);
          x.p[i] = __shfl_sync(kFull, cur.p[i], lo);
        }
        for (int s = lo; s < stop; ++s) {
          const int src = min(s + 1, 31);
          Tile y;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            y.w[i] = __shfl_sync(kFull, cur.w[i], src);
            y.p[i] = __shfl_sync(kFull, cur.p[i], src);
          }
          int smode, sweight;
          choose(x, m_k, n_k, smode, sweight);
          const bool sm = smode < 2;
          const int k_used = sm ? m_k : n_k;
          if (lane == s) {
            my_mode = smode;
            my_weight = sweight;
            my_k = k_used;
          }
          const unsigned n1 = (sm ? m_n : n_n) + 1u;
          const unsigned a1 = (sm ? m_acc : n_acc) + (unsigned)sweight;
          const int k1 = bic::golomb_k_lane(n1, a1);
          m_n = sm ? n1 : m_n;
          m_acc = sm ? a1 : m_acc;
          m_k = sm ? k1 : m_k;
          n_n = sm ? n_n : n1;
          n_acc = sm ? n_acc : a1;
          n_k = sm ? n_k : k1;
          x = y;
        }
        lo = stop;
        n_short = 0;
      }
    }
    if (lane < n_here) {
      const int t = base + lane;
      O[3 * t] = my_mode;
      O[3 * t + 1] = my_weight;
      O[3 * t + 2] = my_k;
    }
  }
  if (rounds != nullptr && lane == 0) rounds[b] = n_rounds;
}

}  // namespace

// w4: int32 [B, T, 4], 16-byte aligned; hc, il: int32 [B, T]; enb: int32
// [n_enb]; out: int32 [B, T, 3]; rounds: int32 [B] or null.  A round that
// commits fewer than `guard` tiles ends its window serially.  Launches on
// `stream`, returns cudaGetLastError().
extern "C" int bic_decide_modes(const void* w4, const void* hc, const void* il,
                                const void* enb, void* out, void* rounds,
                                int B, int T, int n_enb, int use_pred,
                                int mcost, int ncost, int guard,
                                void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (n_enb <= 0 || n_enb > kMaxEnb) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)w4 & 15) != 0) return (int)cudaErrorMisalignedAddress;
  auto* kernel = n_enb <= 2048 ? decide_modes_kernel<true>
                               : decide_modes_kernel<false>;
  kernel<<<B, 32, n_enb * sizeof(int32_t), (cudaStream_t)stream>>>(
      (const int32_t*)w4, (const int32_t*)hc, (const int32_t*)il,
      (const int32_t*)enb, (int32_t*)out, (int32_t*)rounds, T, n_enb,
      use_pred, mcost, ncost, guard);
  return (int)cudaGetLastError();
}
