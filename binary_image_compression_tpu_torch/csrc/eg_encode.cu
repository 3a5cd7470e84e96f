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
// walk over the runs, serial within a chunk, twice (once from all 32 states
// for the chunk's map, once from its true state to write the codes), so the
// kernel is bound by the instructions a run costs and by how many chunks
// walk at once; the composition above the chunks must stay short.
//
// Design (three kernels on the stream, one call; chunks of 16 words, or 64
// where the stack has many of them for the card's resident warps; tiles of
// 8 chunks):
//   1. k8_chunk_maps: a block per tile (persistent, tiles grid-stride), a
//      warp per chunk, its next chunk's words loaded a chunk ahead: the
//      words' ones by popcount prefix and a max-scan of each word's last one
//      (no pass before it: the run that ends at the chunk's first one f is
//      coded by whoever knows the one before); the lengths of the runs
//      between them into shared memory; then lane s walks them from state
//      s.  A run step is a fixed number of operations: a table of (exit,
//      bits) for every state and run of fewer than kTabRuns zeros (built
//      once per card from the plain version, copied into each block's shared
//      memory), else the closed form (eg_code): the run's blocks from the
//      32-entry prefix of the LUT's blocks, the saturated blocks of 2^15
//      past state 31 by a shift.  No loop a block.  The walk takes four runs
//      a test that all are short, so a step's chain is an add, a shared load
//      and a mask.  Warp 0 composes the tile's chunks (map, bits from each
//      state, first and last one; two aggregates join through the run
//      between them): each chunk's prefix within the tile and the tile's
//      aggregate go to the workspace.
//   2. k8_tile_scan: a block of 32 warps per plane scans the tiles: each
//      warp composes a segment of them (~sqrt(tiles) segments), warp 0 runs
//      the segments from the plane's start, each warp runs its segment
//      again from its entry: every tile's entry (state, bit offset, last one
//      before it).
//   3. k8_emit: a warp per chunk (persistent, chunks grid-stride, the next
//      chunk's words loaded ahead) takes its entry (its tile's, then its
//      prefix), finds its ones again and walks its runs 32 at a time from
//      that state, each lane keeping the state of its run; then lane i codes
//      run i, a warp scan of the code lengths gives the offsets, each lane
//      ORs its code into a ring of kRing words in shared memory, and the
//      warp writes the ring's complete words, plainly and coalesced, but the
//      chunk's first and last words, which neighbours share, by atomicOr.
// The first run of a plane is coded from the constructor's state (g = 1,
// block 1), whatever the state before it.  The plane's last chunk codes the
// trailing zero run and writes the bit count.  Codes past the payload
// buffer are dropped (the caller raises; EG stays well under the buffer's 4
// bits a pixel).  The payload comes zeroed.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;         // warps a block, chunks a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kScanWarps = 32;    // k8_tile_scan's warps (segments a plane)
constexpr int kTabRuns = 64;      // run lengths the step table holds
constexpr int kRing = 64;         // words of a warp's write window
// an aggregate's record in the workspace, in ints: its map (32 bytes), its
// bits from each state, f and l
constexpr int kRec = 42;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Code {
  int exit, nb, g, rem;
};

// C[s]: the zeros in the blocks of states 0 .. s-1 (blocks 1 x4, 2 x4, 4 x4,
// 8 x4, 16 x2, 32 x2, 64 x2, 128 x2, 256, 512, ..., 32768)
__device__ __forceinline__ int blocks_below(int s) {
  if (s < 16) return 4 * ((1 << (s >> 2)) - 1) + ((s & 3) << (s >> 2));
  if (s < 24) {
    const int i = (s - 16) >> 1;
    return 60 + 32 * ((1 << i) - 1) + (((s - 16) & 1) << (4 + i));
  }
  return 540 + 256 * ((1 << (s - 24)) - 1);
}

// A run of L zeros from LUT state s, cs = C[s]: the blocks it takes are
// those of states s .. t-1 with C[t] <= X = L + C[s], found from X alone in
// three segments of equal block counts (4, 2, 1 states a block size, from
// C = 0, 60, 540); past C[31] every block is 2^15 and is counted by a shift.
__device__ __forceinline__ Code eg_code(int L, int s, int cs) {
  const int X = L + cs;
  const int seg = (X >= 60) + (X >= 540);
  const int base = seg == 0 ? 0 : (seg == 1 ? 60 : 540);
  const int lu = 2 + 3 * seg, lg = 2 - seg, g0 = 4 * seg;
  const int s0 = seg == 0 ? 0 : 8 + 8 * seg;
  const int d = X - base;
  const int j = min(31 - __clz((d >> lu) + 1), 7);
  const int e = d - (((1 << j) - 1) << lu);
  const int b = g0 + j;
  const int t = s0 + (j << lg) + (e >> b);
  Code c;
  c.nb = t - s;
  c.g = b;
  c.rem = e & ((1 << b) - 1);
  c.exit = max(min(t, 31) - 1, 0);
  return c;
}

// the plane's first run, from the constructor's g = 1, block 1
__device__ __forceinline__ Code eg_first(int L) {
  if (L == 0) return Code{0, 0, 1, 0};
  Code c = eg_code(L - 1, 1, 1);
  c.nb += 1;
  return c;
}

// a step as the walks carry it: 4 * exit | bits << 8 (the exit is a byte
// offset into a row of the table)
__device__ __forceinline__ int pack(const Code& c) {
  return c.exit << 2 | (c.nb + 1 + c.g) << 8;
}

__device__ __forceinline__ int exit_of(int v) { return (v >> 2) & 31; }

struct Tables {
  int step[kTabRuns * 32];  // [L][s]: pack(run of L zeros from state s)
  int cs[32];
};

// the step table (built once per card by the caller, ops/egdevice.py
// step_table), copied into each block's shared memory, and C[s]
__device__ __forceinline__ void load_tables(Tables& tb, const int* table) {
  for (int i = threadIdx.x; i < kTabRuns * 8; i += blockDim.x)
    reinterpret_cast<int4*>(tb.step)[i] =
        __ldg(reinterpret_cast<const int4*>(table) + i);
  if (threadIdx.x < 32) tb.cs[threadIdx.x] = blocks_below(threadIdx.x);
}

// the step of a run of kTabRuns zeros or more: out of line, off the walks'
// common path
__device__ __noinline__ int long_step(int L, int s, int cs) {
  return pack(eg_code(L, s, cs));
}

// the step of a run of L zeros from state s
__device__ __forceinline__ int run_step(const Tables& tb, int s, int L) {
  if (L < kTabRuns) return tb.step[L * 32 + s];
  return long_step(L, s, tb.cs[s]);
}

// A walk over runs L[i0 .. i1) from state s (the same L for every lane, s
// the lane's own).  Past a head up to a multiple of 4 the runs go four at a
// time: one 64-bit load of their lengths, one uniform test that all are
// short, then four table lookups whose chain is an add, a shared load and a
// mask.  With kCapture (a walk from one state) lane j keeps the entry state
// of run base + j in *ms.  Returns the exit state and adds the bits to
// *bits.
template <bool kCapture>
__device__ __forceinline__ int walk(const Tables& tb, const uint16_t* L,
                                   int i0, int i1, int s, int* bits, int base,
                                   int* ms) {
  const char* tab = reinterpret_cast<const char*>(tb.step);
  const int lane = threadIdx.x & 31;
  int s4 = s << 2, acc = 0, i = i0;
  auto one = [&](int i, int l) {
    if (kCapture && lane == i - base) *ms = s4 >> 2;
    const int v = run_step(tb, s4 >> 2, l);
    s4 = v & 0x7C;
    acc += v >> 8;
  };
  for (; i < i1 && (i & 3); ++i) one(i, L[i]);
  for (; i + 4 <= i1; i += 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(L + i);
    const int ls[4] = {static_cast<int>(q.x & 0xFFFF),
                       static_cast<int>(q.x >> 16),
                       static_cast<int>(q.y & 0xFFFF),
                       static_cast<int>(q.y >> 16)};
    if (((q.x | q.y) & 0xFFC0FFC0u) == 0) {  // all four below kTabRuns
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (kCapture && lane == i + u - base) *ms = s4 >> 2;
        const int v = *reinterpret_cast<const int*>(tab + ls[u] * 128 + s4);
        s4 = v & 0x7C;
        acc += v >> 8;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) one(i + u, ls[u]);
    }
  }
  for (; i < i1; ++i) one(i, L[i]);
  if (bits) *bits += acc;
  return s4 >> 2;
}

struct Entry {
  int st, lp;      // the state, the last one before (-1: the plane's start)
  long long off;   // the bit offset
};

// x then the stretch (map m, bits b held by lane s for state s; first and
// last one f, l; f < 0: no one, the identity)
template <class B>
__device__ __forceinline__ Entry apply(const Tables& tb, Entry x, int m, B b,
                                       int f, int l) {
  if (f < 0) return x;
  const int L = f - x.lp - 1;
  const int v = x.lp < 0 ? pack(eg_first(L)) : run_step(tb, x.st, L);
  const int e = exit_of(v);
  x.off += (v >> 8) + __shfl_sync(kFull, b, e);
  x.st = __shfl_sync(kFull, m, e);
  x.lp = l;
  return x;
}

// an aggregate as a warp holds it: lane s has map[s] and bits[s]
template <class B>
struct Agg {
  int m;
  B b;
  int f, l;  // first and last one; f < 0: no one, the identity
};

// a then c: the run between a's last one and c's first one joins them
template <class B, class C>
__device__ __forceinline__ void append(const Tables& tb, Agg<B>& a,
                                       const Agg<C>& c) {
  if (c.f < 0) return;
  if (a.f < 0) {
    a.m = c.m;
    a.b = c.b;
    a.f = c.f;
  } else {
    const int v = run_step(tb, a.m, c.f - a.l - 1);
    const int e = exit_of(v);
    a.b += (v >> 8) + __shfl_sync(kFull, c.b, e);
    a.m = __shfl_sync(kFull, c.m, e);
  }
  a.l = c.l;
}

__device__ __forceinline__ Agg<int> load_agg(const int* rec, int lane) {
  Agg<int> a;
  a.m = reinterpret_cast<const unsigned char*>(rec)[lane];
  a.b = rec[8 + lane];
  a.f = rec[40];
  a.l = rec[41];
  return a;
}

template <class B>
__device__ __forceinline__ void store_agg(int* rec, const Agg<B>& a,
                                          int lane) {
  reinterpret_cast<unsigned char*>(rec)[lane] = static_cast<unsigned char>(a.m);
  rec[8 + lane] = static_cast<int>(a.b);
  if (lane == 0) {
    rec[40] = a.f;
    rec[41] = a.l;
  }
}

// The words of chunk c of a plane a lane holds (lane + 32 h), zero past the
// chunk and the plane: loaded a chunk ahead of their use.
template <int CW>
struct ChunkWords {
  static constexpr int kWpl = (CW + 31) / 32;  // words a lane holds
  uint32_t w[kWpl];

  __device__ __forceinline__ void load(const uint32_t* plane, int c, int nwp,
                                       int lane) {
#pragma unroll
    for (int h = 0; h < kWpl; ++h) {
      const int k = lane + 32 * h, gi = c * CW + k;
      w[h] = k < CW && gi < nwp ? __ldg(plane + gi) : 0u;
    }
  }
};

// Chunk c's ones (count, first, last) and the lengths of the runs between
// them into L[1 .. count-1] (shared memory), in order.
template <int CW>
__device__ __forceinline__ int3 chunk_ones(const ChunkWords<CW>& cw, int c,
                                           int nw, int cols, uint16_t* L,
                                           int lane) {
  int cnt = 0, f = -1, l = -1;
#pragma unroll
  for (int h = 0; h < ChunkWords<CW>::kWpl; ++h) {
    const uint32_t w = cw.w[h];
    const int gi = c * CW + lane + 32 * h;
    const int r = gi / nw;
    const int base = r * cols + (gi - r * nw) * 32;
    const int pc = __popc(w);
    int incl = pc, mx = w ? base + 32 - __ffs(w) : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      const int z = __shfl_up_sync(kFull, mx, d);
      if (lane >= d) {
        incl += y;
        mx = max(mx, z);
      }
    }
    int pv = __shfl_up_sync(kFull, mx, 1);
    pv = max(lane ? pv : -1, l);
    int idx = cnt + incl - pc;
    uint32_t m = w;
    while (m) {
      const int bit = __clz(m);
      m ^= 0x80000000u >> bit;
      const int pos = base + bit;
      if (idx == 0) f = pos;
      else L[idx] = static_cast<uint16_t>(pos - pv - 1);
      pv = pos;
      ++idx;
    }
    cnt += __shfl_sync(kFull, incl, 31);
    l = max(l, __shfl_sync(kFull, mx, 31));
  }
  __syncwarp();
  return make_int3(cnt, __reduce_max_sync(kFull, f), l);
}

// A block per tile of kWarps chunks (persistent, tiles grid-stride), a
// warp per chunk walking its runs from all 32 states; then warp 0 composes
// the tile's chunks, writing each chunk's prefix within the tile and the
// tile's aggregate.
template <int CW>
__global__ void __launch_bounds__(kThreads, 4)
    k8_chunk_maps(const uint32_t* __restrict__ res,
                  const int* __restrict__ table, int* __restrict__ crec,
                  int* __restrict__ trec, int P, int rows, int cols, int nw,
                  int NC, int NT) {
  __shared__ Tables tb;
  __shared__ __align__(8) uint16_t Ls[kWarps][CW * 32];
  __shared__ int cm[kWarps][32], cb[kWarps][32], cf[kWarps], cl[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_tables(tb, table);
  __syncthreads();
  const int nwp = rows * nw;
  ChunkWords<CW> next;  // the words of this warp's next chunk
  auto fetch = [&](int t) {
    const int p = t / NT, c = (t - p * NT) * kWarps + warp;
    if (t < P * NT && c < NC)
      next.load(res + static_cast<size_t>(p) * nwp, c, nwp, lane);
  };
  fetch(blockIdx.x);
  for (int t = blockIdx.x; t < P * NT; t += gridDim.x) {
    const int p = t / NT, b = t - p * NT, c = b * kWarps + warp;
    const ChunkWords<CW> cur = next;
    fetch(t + gridDim.x);
    int m = lane, bits = 0, f = -1, l = -1;
    if (c < NC) {
      const int3 o = chunk_ones<CW>(cur, c, nw, cols, Ls[warp], lane);
      if (o.x) {
        f = o.y;
        l = o.z;
        m = walk<false>(tb, Ls[warp], 1, o.x, lane, &bits, 0, nullptr);
      }
    }
    cm[warp][lane] = m;
    cb[warp][lane] = bits;
    if (lane == 0) {
      cf[warp] = f;
      cl[warp] = l;
    }
    __syncthreads();
    if (warp == 0) {
      int* r0 = crec + (static_cast<size_t>(p) * NC + b * kWarps) * kRec;
      Agg<int> pre{lane, 0, -1, -1};
      for (int i = 0; i < kWarps && b * kWarps + i < NC; ++i) {
        store_agg(r0 + i * kRec, pre, lane);
        append(tb, pre, Agg<int>{cm[i][lane], cb[i][lane], cf[i], cl[i]});
      }
      store_agg(trec + static_cast<size_t>(t) * kRec, pre, lane);
    }
    __syncthreads();
  }
}

// One block a plane: segment w of the tiles composed by warp w, the
// segments run from the plane's start by warp 0, each segment run again by
// its warp: every tile's entry.  Warps past the segments have empty ones.
__global__ void __launch_bounds__(32 * kScanWarps, 1)
    k8_tile_scan(const int* __restrict__ table, const int* __restrict__ trec,
                 Entry* __restrict__ tent, int NT) {
  __shared__ Tables tb;
  __shared__ int sm[kScanWarps][32];
  __shared__ long long sb[kScanWarps][32];
  __shared__ int sf[kScanWarps], sl[kScanWarps];
  __shared__ Entry sent[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x;
  // ~sqrt(NT) segments (at most 32): the chain is a segment, the segments,
  // a segment
  int nseg = 1;
  while (nseg < kScanWarps && nseg * nseg < NT) ++nseg;
  const int seg = (NT + nseg - 1) / nseg;
  const int lo = min(NT, warp * seg), hi = min(NT, lo + seg);
  const int* recs = trec + static_cast<size_t>(p) * NT * kRec;
  load_tables(tb, table);
  __syncthreads();
  Agg<long long> a{lane, 0, -1, -1};
  for (int g = lo; g < hi; g += 8) {  // 8 tiles' loads at once
    Agg<int> t8[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (g + u < hi) t8[u] = load_agg(recs + (g + u) * kRec, lane);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (g + u < hi) append(tb, a, t8[u]);
  }
  sm[warp][lane] = a.m;
  sb[warp][lane] = a.b;
  if (lane == 0) {
    sf[warp] = a.f;
    sl[warp] = a.l;
  }
  __syncthreads();
  if (warp == 0) {
    Entry x{0, -1, 0};
    for (int w = 0; w < nseg; ++w) {
      if (lane == 0) sent[w] = x;
      x = apply(tb, x, sm[w][lane], sb[w][lane], sf[w], sl[w]);
    }
  }
  __syncthreads();
  Entry x = sent[warp];
  for (int g = lo; g < hi; g += 8) {
    Agg<int> t8[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (g + u < hi) t8[u] = load_agg(recs + (g + u) * kRec, lane);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (g + u < hi) {
        if (lane == 0) tent[static_cast<size_t>(p) * NT + g + u] = x;
        x = apply(tb, x, t8[u].m, t8[u].b, t8[u].f, t8[u].l);
      }
    }
  }
}

// One chunk's runs for the writer, in order: run 0 ends at the chunk's
// first one (L0) or, in an empty last chunk, is the trailing run; runs 1 ..
// cnt-1 are those between its ones (L[i]); run cnt is the trailing run (Lt)
// when the chunk ends the plane and its last pixel is 0.
struct ChunkRuns {
  const uint16_t* L;
  int cnt, R, L0, Lt;
  bool first0;  // run 0 is the plane's first

  __device__ __forceinline__ int len(int i) const {
    return i == 0 ? L0 : (i < cnt ? static_cast<int>(L[i]) : Lt);
  }
};

// Warp per chunk: runs 32 at a time; the walk leaves each run's entry
// state with its lane (run 0 and the trailing run stepped apart: their
// lengths may be any), then lane i codes run i
// from its state, a warp scan of the code lengths gives each its bit
// offset, and each lane ORs its code into the ring; complete words go out
// plainly, the chunk's first and last words by atomicOr.  Returns the end
// bit.
struct WarpWriter {
  static __device__ long long emit(const Tables& tb, const ChunkRuns& cr,
                                   int s, long long a0, uint32_t* ring,
                                   uint32_t* out, int TW, int lane) {
    const int w0 = static_cast<int>(a0 >> 5);
    int o = static_cast<int>(a0 & 31), rb = 0;  // bits, words from word w0
    for (int i0 = 0; i0 < cr.R; i0 += 32) {
      const int i = i0 + lane, i1 = min(cr.R, i0 + 32);
      const bool live = i < cr.R;
      const bool first = i == 0 && cr.first0;
      const int L = live ? cr.len(i) : 0;
      int j = i0, ms = s;  // lane j: the entry state of run i0 + j
      if (i0 == 0) {  // run 0, whose length may be any
        s = exit_of(cr.first0 ? pack(eg_first(cr.L0))
                              : run_step(tb, s, cr.L0));
        j = 1;
      }
      const int inner = min(i1, cr.cnt);  // the runs between ones
      if (j < inner) s = walk<true>(tb, cr.L, j, inner, s, nullptr, i0, &ms);
      if (cr.cnt && inner < i1) {  // the trailing run after the ones
        if (lane == inner - i0) ms = s;
        s = exit_of(run_step(tb, s, cr.Lt));
      }
      Code cd = {0, 0, 0, 0};
      if (live) cd = first ? eg_first(L) : eg_code(L, ms, tb.cs[ms]);
      const int len = live ? cd.nb + 1 + cd.g : 0;
      int incl = len;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      const int mo = o + incl - len;       // the code's first bit
      const int last = mo + cd.nb + cd.g;  // and its last
      o += __shfl_sync(kFull, incl, 31);
      for (;;) {
        const int top = rb + kRing;  // the window: words [rb, top)
        if (live) {
          const int k1 = min(last >> 5, top - 1);
          for (int k = max(mo >> 5, rb); k <= k1; ++k) {
            const int kb = k << 5;
            const int a = max(mo, kb) - kb;
            const int e = min(mo + cd.nb, kb + 32) - kb;
            uint32_t v = a < e ? (kFull >> a) & ~(e >= 32 ? 0u : kFull >> e)
                               : 0u;
            const int d = kb + 31 - last;  // the remainder's shift
            if (cd.g && d > -32 && d < 32)
              v |= d >= 0 ? static_cast<uint32_t>(cd.rem) << d
                          : static_cast<uint32_t>(cd.rem) >> -d;
            if (v) atomicOr(ring + (k & (kRing - 1)), v);
          }
        }
        __syncwarp();
        const int end = min(top, o >> 5);  // complete words
        for (int k = rb + lane; k < end; k += 32) {
          const int slot = k & (kRing - 1);
          const uint32_t v = ring[slot];
          ring[slot] = 0;
          if (w0 + k < TW) {
            if (k == 0) {
              if (v) atomicOr(out + w0, v);
            } else {
              out[w0 + k] = v;
            }
          }
        }
        __syncwarp();
        rb = end;
        if (end < top) break;
      }
    }
    if (o & 31) {  // the last word, shared with the next chunk
      const int k = o >> 5, slot = k & (kRing - 1);
      const uint32_t v = ring[slot];
      __syncwarp();
      if (lane == 0) {
        ring[slot] = 0;
        if (v && w0 + k < TW) atomicOr(out + w0 + k, v);
      }
      __syncwarp();
    }
    return (static_cast<long long>(w0) << 5) + o;
  }
};

// A warp per chunk (persistent, chunks grid-stride): its entry, its runs,
// its codes.
template <int CW, class Writer>
__global__ void __launch_bounds__(kThreads, 4)
    k8_emit(const uint32_t* __restrict__ res, const int* __restrict__ table,
            const int* __restrict__ crec,
            const Entry* __restrict__ tent, uint32_t* __restrict__ words,
            long long* __restrict__ nbits, int P, int rows, int cols, int nw,
            int NC, int NT, int TW) {
  __shared__ Tables tb;
  __shared__ __align__(8) uint16_t Ls[kWarps][CW * 32 + 4];
  __shared__ uint32_t ring[kWarps][kRing];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_tables(tb, table);
  for (int i = threadIdx.x; i < kWarps * kRing; i += kThreads)
    (&ring[0][0])[i] = 0;
  __syncthreads();
  const int nwp = rows * nw, n = rows * cols;
  const int stride = gridDim.x * kWarps;
  ChunkWords<CW> next;  // the words of this warp's next chunk
  auto fetch = [&](int t) {
    const int p = t / NC;
    if (t < P * NC)
      next.load(res + static_cast<size_t>(p) * nwp, t - p * NC, nwp, lane);
  };
  fetch(blockIdx.x * kWarps + warp);
  for (int t = blockIdx.x * kWarps + warp; t < P * NC; t += stride) {
    const int p = t / NC, c = t - p * NC;
    const ChunkWords<CW> cur = next;
    fetch(t + stride);
    const Agg<int> pre = load_agg(crec + static_cast<size_t>(t) * kRec, lane);
    const Entry x = apply(tb, tent[static_cast<size_t>(p) * NT + c / kWarps],
                          pre.m, pre.b, pre.f, pre.l);
    const int3 o = chunk_ones<CW>(cur, c, nw, cols, Ls[warp], lane);
    ChunkRuns cr;
    cr.L = Ls[warp];
    cr.cnt = o.x;
    cr.Lt = n - 1 - (o.x ? o.z : x.lp);
    const bool trail = c == NC - 1 && cr.Lt > 0;
    cr.L0 = o.x ? o.y - x.lp - 1 : cr.Lt;
    cr.R = o.x + (trail ? 1 : 0);
    cr.first0 = x.lp < 0;
    long long end = x.off;
    if (cr.R)
      end = Writer::emit(tb, cr, x.st, x.off, ring[warp],
                         words + static_cast<size_t>(p) * TW, TW, lane);
    if (c == NC - 1 && lane == 0) nbits[p] = end;
  }
}

// the resident blocks of a kernel on the current card
template <class K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

__host__ __forceinline__ long long round32(long long v) {
  return (v + 31) & ~31LL;
}

template <int CW, class Writer>
int k8_launch(const void* res, const void* table, void* ws, void* words,
              void* nbits, int P, int rows, int cols, int nw, int TW,
              long long ws_ints, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static const int grid1 = resident_blocks(k8_chunk_maps<CW>);
  static const int grid3 = resident_blocks(k8_emit<CW, Writer>);
  const long long nc = (static_cast<long long>(rows) * nw + CW - 1) / CW;
  const long long nt = (nc + kWarps - 1) / kWarps;
  // workspace: tile records, tile entries, chunk records (sized by the
  // caller for 16-word chunks, the most)
  const long long o_tent = round32(P * nt * kRec);
  const long long o_crec = o_tent + round32(P * nt * 4);
  if (ws_ints < o_crec + P * nc * kRec || P * nc >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int NC = static_cast<int>(nc), NT = static_cast<int>(nt);
  int* w = static_cast<int*>(ws);
  const long long tiles = static_cast<long long>(P) * NT;
  const auto* r = static_cast<const uint32_t*>(res);
  const auto* tab = static_cast<const int*>(table);
  k8_chunk_maps<CW><<<static_cast<int>(tiles < grid1 ? tiles : grid1),
                      kThreads, 0, st>>>(r, tab, w + o_crec, w, P, rows, cols,
                                         nw, NC, NT);
  k8_tile_scan<<<P, 32 * kScanWarps, 0, st>>>(
      tab, w, reinterpret_cast<Entry*>(w + o_tent), NT);
  k8_emit<CW, Writer><<<static_cast<int>(tiles < grid3 ? tiles : grid3),
                        kThreads, 0, st>>>(
      r, tab, w + o_crec, reinterpret_cast<const Entry*>(w + o_tent),
      static_cast<uint32_t*>(words), static_cast<long long*>(nbits), P, rows,
      cols, nw, NC, NT, TW);
  return static_cast<int>(cudaGetLastError());
}

// The chunk size: 64 words where the stack gives every resident warp two
// chunks of 64 words or more (a long serial walk then costs nothing in
// filling the card, and there are 4x fewer chunks, tiles and entries to
// handle), else 16 (short walks, the card filled).  K8_CHUNK_WORDS fixes it
// (scripts/k8_variants.py).
template <class Writer>
int k8_encode(const void* res, const void* table, void* ws, void* words,
              void* nbits, int P, int rows, int cols, int nw, int TW,
              long long ws_ints, void* stream) {
#ifdef K8_CHUNK_WORDS
  const bool wide = K8_CHUNK_WORDS == 64;
  if (K8_CHUNK_WORDS == 32)
    return k8_launch<32, Writer>(res, table, ws, words, nbits, P, rows, cols,
                                 nw, TW, ws_ints, stream);
#else
  static const int warps = resident_blocks(k8_chunk_maps<64>) * kWarps;
  const bool wide =
      static_cast<long long>(P) * ((static_cast<long long>(rows) * nw + 63) /
                                   64) >= 2LL * warps;
#endif
  if (wide)
    return k8_launch<64, Writer>(res, table, ws, words, nbits, P, rows, cols,
                                 nw, TW, ws_ints, stream);
  return k8_launch<16, Writer>(res, table, ws, words, nbits, P, rows, cols,
                               nw, TW, ws_ints, stream);
}

}  // namespace

// res: uint32 [P, rows, nw] packed residuals; table: int32 [64 * 32], the
// step of every run below 64 from every state (4 * exit | bits << 8);
// words: zeroed uint32 [P, TW]; nbits: int64 [P]; ws: int32 [ws_ints]
// workspace (tile records and entries, chunk records; ops/egdevice.py
// sizes it for 16-word chunks, enough for larger ones).
extern "C" int bic_eg_encode(const void* res, const void* table, void* ws,
                             void* words, void* nbits, int P, int rows,
                             int cols, int nw, int TW, long long ws_ints,
                             void* stream) {
  return k8_encode<WarpWriter>(res, table, ws, words, nbits, P, rows, cols,
                               nw, TW, ws_ints, stream);
}
