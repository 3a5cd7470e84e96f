// Kernel K7: codec 13's interleaved-rANS encode (payload mode 2), one block
// per stripe, writing each stripe's word stream itself.
//
// Replaces: binary_image_compression_tpu/ops/ransdevice.py::rans_encode_scan
//           (a lax.scan, not Pallas) and the stream packing after it
//           (pack_stream_words -> bitstream.pack_varlen over [steps, S, N]
//           words and flags).
//
// What it computes, per stripe of `stripe_rows` rows (the last one may be
// short) of each page: N = n_lanes interleaved 32-bit rANS states, lane l
// coding pixels t*N + l of the stripe for t = steps-1 down to 0, from
// x = 2^16.  A pixel's (f, b) comes from its bit and the table p_used
// (P(bit == 1) * 4096 per context): bit 1 -> (p1, 4096 - p1), bit 0 ->
// (4096 - p1, 0); pixels past the stripe's real pixels are the exact no-op
// (f = 4096, b = 0).  A step: if (x >> 20) >= f, emit x & 0xFFFF and
// x >>= 16; then x = ((x / f) << 12) + x % f + b.  Outputs: each lane's final
// x (the decoder's initial state), the emitted 16-bit words in ascending
// (step, lane) order as MSB-first 32-bit words, and the stream's bit count.
// Every value is an exact integer; there is no rounding to match.
//
// What bounds it on the H100: the chain.  A lane's steps are dependent
// (utils/roofline.py::rans_work's chain floor), and a stripe has at most 255
// lanes, so a 512x512 page (4 stripes x 32 lanes) is 128 threads walking
// 2,048 steps.  Its bytes (3 per pixel in, at most 2 out) are nothing to the
// card.
//
// What the design does about it: a lane's dependent line is the state
// update alone.  None of a step's inputs depends on x, so everything else
// leaves the chain.
// - Producer warps stage the inputs.  The block's warps beyond the chain
//   warps (up to 12 warps in all: 11 producers beside one chain warp) load
//   a stage's bits and contexts, which are contiguous pixels, in pixel
//   order (coalesced, a batch of 32 loads a thread in flight before a warp
//   barrier), look up p1 in the 8 KB table and the divisor's constants in
//   a 32 KB table (both in shared memory), and write one 16-byte record
//   per pixel, in the same order, into a ring of stages in shared memory:
//   {d*m low, d*m high, m, (f - 1) << 20 | s}, with d = a + bit*f.  Chain
//   lane l reads record u * N + l of a stage; lanes past N read one pad
//   record.  A pad is {0, 0, 0, 4095 << 20} (a select, not a branch): c =
//   4096 - f = 0 makes the step x' = x and the emit threshold 2^32 - 1.
//   A stage is kSS steps (32, 16 or 8 as the lanes grow); full/empty
//   mbarriers hand each stage over, the empty one counting every chain
//   thread, so a producer never overwrites a stage a slower chain warp
//   still reads.  Producer warp p fills stages p, p + n_prod, ...;
//   n_prod <= stages keeps each wait within one phase of its barrier.
//   The ring holds 11 stages of 32 steps at 32 lanes (352 steps ahead).
//   A stage's records cost a producer ~10x the chain's time for its steps,
//   hence many producers (PERF.md section 6).
// - The divide is an exact multiply-high.  Before the divide x < f * 2^20.
//   Per f, div_magic (ops/ransdevice.py) picks m < 2^32, s and a in {0, 1}
//   with floor((y + a) * m / 2^(32+s)) == floor(y / f) for every
//   y < f * (2^20 + 1), proved by the method's error bound.  With y = x +
//   bit * f the quotient carries b (b = bit * c), so a step is
//       need = x > ((f - 1) << 20 | 0xFFFFF)   (x >= f << 20)
//       x    = need ? x >> 16 : x
//       q    = (x * m + d * m) >> (32 + s)   (one 32x32+64 multiply-add)
//       x    = q * c + x        (c = 4096 - f; == (x/f << 12) + x % f + b)
//   five dependent instructions.
// - The emission is off the chain.  A lane that emits stores its word at
//   its own (step, lane) slot of the scratch (a predicated store, written
//   in PTX so that it stays one instruction and not a branch; the slot's
//   address is a pointer that steps down a row each step) and sets the
//   step's bit in a flag word (32 steps a word).  No ballot, no barrier, no
//   counter inside the chain.
// - After the chain the whole block puts the words in stream order: per
//   group of 32 steps, the flag words' popcounts give the group's count and
//   an exclusive scan over the groups its offset; a warp per group
//   transposes its 32 x 32 flag bits (five shuffles) so that thread u holds
//   the lanes emitting at step u, and writes each word to its place as the
//   high or low half of an MSB-first 32-bit word.
//   ``ransdevice.stream_order_plain`` is this pass as torch ops.
// Offsets inside a stripe are 32-bit where its slots fit (Idx = int), else
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

// Switches for scripts/k7_variants.cu, which times the design without a
// part; K7_NO_DIVIDE and K7_NO_EMIT give wrong streams.
#ifndef K7_MAX_STAGES
#define K7_MAX_STAGES 16  // ring stages at most
#endif
#ifndef K7_NO_DIVIDE
#define K7_NO_DIVIDE 0
#endif
#ifndef K7_NO_EMIT
#define K7_NO_EMIT 0
#endif
#ifndef K7_PRODUCERS
#define K7_PRODUCERS 0  // producer warps; 0: as many as the block and ring take
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kScale = 4096;      // freqs sum to 2^12
constexpr int kGroup = 32;             // steps per flag word
constexpr int kMaxChainWarps = 8;      // 255 lanes at most (a u8 field)
constexpr int kMaxThreads = (kMaxChainWarps + 4) * 32;
constexpr size_t kRingBytes = 180 * 1024;
constexpr size_t kBarBytes = 2 * K7_MAX_STAGES * sizeof(uint64_t);
constexpr size_t kTableBytes = kScale * sizeof(uint2) + kScale * 2;
constexpr int kBatch = 32;             // producer loads in flight a thread

// a pad's record: f = 4096 (c = 0, threshold 2^32 - 1), so x' = x
__device__ __forceinline__ uint4 pad_rec() {
  return make_uint4(0u, 0u, 0u, 0xFFFu << 20);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// *p = v where pred: one predicated store, never a branch around it.  No
// "memory" clobber: nothing reads the scratch before the block's barrier,
// and the ring loads around it must stay free to move.
__device__ __forceinline__ void store_if(uint16_t* p, uint32_t v, bool pred) {
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "@q st.global.b16 [%0], %1;\n\t}" ::"l"(p),
      "h"((unsigned short)v), "r"((int)pred));
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 32 x 32 bit transpose across a warp: lane j holds row j (bit u), and
// afterwards lane u holds column u (bit j).  Each level swaps the
// off-diagonal k x k blocks.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int k = 16 >> i;
    const uint32_t m = masks[i];
    const uint32_t o = __shfl_xor_sync(kFull, x, k);
    x = (lane & k) ? (x & ~m) | ((o >> k) & m) : (x & m) | ((o & m) << k);
  }
  return x;
}

template <typename Idx, int kSS>
__global__ void __launch_bounds__(kMaxThreads, 1)
rans_encode_kernel(const uint8_t* __restrict__ bits,
                   const uint16_t* __restrict__ ctx,
                   const uint16_t* __restrict__ p_used,
                   const uint2* __restrict__ magic,
                   uint16_t* __restrict__ scratch,
                   uint32_t* __restrict__ flags,
                   uint32_t* __restrict__ states, uint32_t* __restrict__ words,
                   long long* __restrict__ nbits, int rows, int cols,
                   int n_stripes, int stripe_rows, int steps, int n_lanes,
                   int n_chain, int n_stages) {
  constexpr int kHalves = kGroup / kSS;  // stages per flag group
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = n_chain * 32;           // lanes rounded up to whole warps
  const int stage_recs = kSS * n_lanes;  // a stage's records, pixel order
  uint4* ring = reinterpret_cast<uint4*>(smem);
  uint4* pad = ring + (size_t)n_stages * stage_recs;  // the pad lanes' record
  uint4* junk = pad + 1;  // where a batch's records past the stage go
  uint2* mtab = reinterpret_cast<uint2*>(junk + 1);
  uint64_t* full = reinterpret_cast<uint64_t*>(mtab + kScale);
  uint64_t* empty = full + K7_MAX_STAGES;
  uint16_t* ptab = reinterpret_cast<uint16_t*>(empty + K7_MAX_STAGES);

  const int blk = blockIdx.x;  // page * n_stripes + stripe
  const int page = blk / n_stripes, s = blk % n_stripes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long npix = (long long)rows * cols;
  const long long first = (long long)s * stripe_rows * cols;
  const Idx n_real = (Idx)min((long long)stripe_rows * cols, npix - first);
  const int groups = (steps + kGroup - 1) / kGroup;
  const int n_st = groups * kHalves;  // stages, in chain order
  uint16_t* sw = scratch + (long long)blk * steps * n_lanes;
  uint32_t* sf = flags + (long long)blk * groups * np;

  if (tid == 0) {
    for (int j = 0; j < n_stages; ++j) {
      mbar_init(&full[j], 32);
      mbar_init(&empty[j], np);
    }
  }
  if (tid == 0) *pad = pad_rec();
  __syncthreads();

  if (warp < n_chain) {
    // ---- the chain: lane l = tid walks every step backwards ----
    const int l = tid;
    // a stage holds record (u, l) at u * N + l; lanes past N read the pad
    const bool real_lane = l < n_lanes;
    const int lstride = real_lane ? n_lanes : 0;
    uint32_t x = 1u << 16;
    int slot = 0;
    uint32_t phase = 0;
    for (int gk = 0; gk < groups; ++gk) {
      const int g = groups - 1 - gk;
      uint32_t F = 0;
      uint16_t* wp = sw + ((Idx)g * kGroup + kGroup - 1) * n_lanes + l;
#pragma unroll
      for (int h = kHalves - 1; h >= 0; --h) {
        mbar_wait(&full[slot], phase);
        const uint4* rs =
            real_lane ? ring + (size_t)slot * stage_recs + l : pad;
#pragma unroll
        for (int u = kSS - 1; u >= 0; --u) {
          const uint4 r = rs[u * lstride];
          const uint32_t thr = r.w | 0xFFFFFu;  // f * 2^20 - 1
          const uint32_t c = 4095u - (r.w >> 20);
          const bool need = x > thr;
#if !K7_NO_EMIT
          store_if(wp, x, need);
          F |= need ? 1u << (h * kSS + u) : 0u;
#endif
          wp -= n_lanes;
          const uint32_t xs = need ? x >> 16 : x;
#if K7_NO_DIVIDE
          const uint32_t q = xs >> 12;
#else
          const unsigned long long p =
              (unsigned long long)xs * r.z +
              ((unsigned long long)r.y << 32 | r.x);
          const uint32_t q = __funnelshift_r((uint32_t)(p >> 32), 0u, r.w);
#endif
          x = q * c + xs;
        }
        mbar_arrive(&empty[slot]);
        if (++slot == n_stages) {
          slot = 0;
          phase ^= 1u;
        }
      }
      sf[(Idx)g * np + l] = F;
    }
    if (l < n_lanes) states[(long long)blk * n_lanes + l] = x;
  } else {
    // ---- producers: records of stages pw, pw + n_prod, ... ----
    const int n_prod = nwarps - n_chain;
    const int pw = warp - n_chain;
    for (int i = tid - np; i < (int)kScale; i += n_prod * 32) {
      ptab[i] = p_used[(long long)page * kScale + i];
      mtab[i] = magic[i];
    }
    asm volatile("bar.sync 1, %0;" ::"r"(n_prod * 32) : "memory");
    const uint8_t* pb = bits + page * npix + first;
    const uint16_t* pc = ctx + page * npix + first;
    const int count = kSS * n_lanes;  // pixels of a stage
    for (int k = pw; k < n_st; k += n_prod) {
      const int slot = k % n_stages, use = k / n_stages;
      if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
      const int g = groups - 1 - k / kHalves;
      const int t0 = g * kGroup + (kHalves - 1 - k % kHalves) * kSS;
      uint4* rs = ring + (size_t)slot * stage_recs;
      // the stage's pixels are contiguous and its records in the same
      // order: thread `lane` takes pixels j = lane + 32 r (coalesced loads
      // at immediate offsets), a batch of kBatch loads at a time
      const Idx a = (Idx)t0 * n_lanes;
      for (int r0 = 0; r0 < count; r0 += 32 * kBatch) {
        uint32_t bv[kBatch], cv[kBatch];
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          const int j = r0 + r * 32 + lane;
          const Idx i = a + j;
          const bool real = j < count && i < n_real;
          bv[r] = real ? (uint32_t)pb[i] : 2u;
          cv[r] = real ? (uint32_t)pc[i] : 0u;
        }
        // every load of the batch in flight before the first use: none may
        // sink past the warp barrier, so a batch waits one round trip
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          const int j = r0 + r * 32 + lane;
          const uint32_t p1 = ptab[cv[r]], bit = bv[r] & 1u;
          const uint32_t f = bit ? p1 : kScale - p1;
          const uint2 mg = mtab[(f - 1) & (kScale - 1)];
          const unsigned long long dm =
              (unsigned long long)((mg.y >> 5) + bit * f) * mg.x;
          const uint4 rec = make_uint4((uint32_t)dm, (uint32_t)(dm >> 32),
                                       mg.x, (f - 1) << 20 | (mg.y & 31u));
          *(j < count ? rs + j : junk) = bv[r] == 2u ? pad_rec() : rec;
        }
      }
      mbar_arrive(&full[slot]);
    }
  }
  __syncthreads();

  // ---- stream order: group totals, their scan, then a warp per group ----
  const long long wcap = ((long long)steps * n_lanes + 1) >> 1;
  uint16_t* dst = reinterpret_cast<uint16_t*>(words + (long long)blk * wcap);
  int* tot = reinterpret_cast<int*>(smem);  // the ring is free now
  const int chunk = (int)(((size_t)n_stages * stage_recs + 2) * 4) - 64;
  int* wsum = tot + chunk;  // per-warp sums, then the chunk's total
  long long carry = 0;
  for (int g0 = 0; g0 < groups; g0 += chunk) {
    const int n = min(chunk, groups - g0);
    for (int gi = warp; gi < n; gi += nwarps) {
      const uint32_t* fg = sf + (Idx)(g0 + gi) * np;
      int cnt = 0;
      for (int cw = 0; cw < n_chain; ++cw) cnt += __popc(fg[cw * 32 + lane]);
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) tot[gi] = cnt;
    }
    __syncthreads();
    // exclusive scan of tot[0, n): a segment per thread, then the threads
    const int per = (n + blockDim.x - 1) / blockDim.x;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += tot[i];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int v = wsum[w];
        wsum[w] = run;
        run += v;
      }
      wsum[nwarps] = run;
    }
    __syncthreads();
    int base = wsum[warp] + incl - sum;
    for (int i = lo; i < hi; ++i) {
      const int v = tot[i];
      tot[i] = base;
      base += v;
    }
    const int chunk_total = wsum[nwarps];
    __syncthreads();
    for (int gi = warp; gi < n; gi += nwarps) {
      const Idx g = g0 + gi;
      const uint32_t* fg = sf + g * np;
      int e = 0;
      for (int cw = 0; cw < n_chain; ++cw)
        e += __popc(transpose32(fg[cw * 32 + lane], lane));
      int ei = e;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, ei, d);
        if (lane >= d) ei += v;
      }
      Idx p = (Idx)(carry + tot[gi] + ei - e);
      const uint16_t* src = sw + (g * kGroup + lane) * n_lanes;
      for (int cw = 0; cw < n_chain; ++cw) {
        uint32_t M = transpose32(fg[cw * 32 + lane], lane);
        while (M) {
          const int j = __ffs(M) - 1;
          M &= M - 1;
          dst[p ^ 1] = src[cw * 32 + j];
          ++p;
        }
      }
    }
    carry += chunk_total;
    __syncthreads();
  }
  if (tid == 0) nbits[blk] = 16 * carry;
}

template <typename Idx, int kSS>
int launch(const void* bits, const void* ctx, const void* p_used,
           const void* magic, void* scratch, void* flags, void* states,
           void* words, void* nbits, int B, int rows, int cols,
           int n_stripes, int stripe_rows, int steps, int n_lanes,
           cudaStream_t stream) {
  auto* kernel = rans_encode_kernel<Idx, kSS>;
  static bool attr_set = false;  // per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kRingBytes + kTableBytes + kBarBytes));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_chain = (n_lanes + 31) / 32;
  const size_t stage_bytes = (size_t)kSS * n_lanes * sizeof(uint4);
  const size_t fit = (kRingBytes - 2 * sizeof(uint4)) / stage_bytes;
  const int n_stages = (int)(fit < K7_MAX_STAGES ? fit : K7_MAX_STAGES);
  // producers fill the block's 12 warps (11 beside one chain warp: a
  // stage's records take a producer ~10x the chain's time for it, PERF.md
  // section 6), but never outnumber the stages, so that a producer is at
  // most one phase of its slot's empty barrier ahead and the parity wait
  // is unambiguous
  const int n_prod =
      min(K7_PRODUCERS ? K7_PRODUCERS : kMaxThreads / 32 - n_chain,
          min(n_stages, kMaxThreads / 32 - n_chain));
  const size_t smem =
      n_stages * stage_bytes + 2 * sizeof(uint4) + kTableBytes + kBarBytes;
  kernel<<<B * n_stripes, (n_chain + n_prod) * 32, smem, stream>>>(
      (const uint8_t*)bits, (const uint16_t*)ctx, (const uint16_t*)p_used,
      (const uint2*)magic, (uint16_t*)scratch, (uint32_t*)flags,
      (uint32_t*)states, (uint32_t*)words, (long long*)nbits, rows, cols,
      n_stripes, stripe_rows, steps, n_lanes, n_chain, n_stages);
  return (int)cudaGetLastError();
}

}  // namespace

// bits: uint8 0/1 [B, rows, cols]; ctx: uint16 [B, rows, cols]; p_used:
// uint16 [B, 4096]; magic: uint32 [4096, 2], div_magic's {m, s | a << 5}
// for f = 1..4096; scratch: uint16 [B * n_stripes, steps * n_lanes];
// flags: uint32 [B * n_stripes, ceil(steps / 32) * 32 * ceil(n_lanes /
// 32)]; states: uint32 [B * n_stripes, n_lanes]; words: uint32
// [B * n_stripes, ceil(steps * n_lanes / 2)], zeroed by the caller; nbits:
// int64 [B * n_stripes].  Launches on `stream`, returns cudaGetLastError().
extern "C" int bic_rans_encode(const void* bits, const void* ctx,
                               const void* p_used, const void* magic,
                               void* scratch, void* flags, void* states,
                               void* words, void* nbits, int B, int rows,
                               int cols, int n_stripes, int stripe_rows,
                               int steps, int n_lanes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (rows < 1 || cols < 1 || n_lanes < 1 || n_lanes > 255 ||
      stripe_rows < 1 || n_stripes < 1 || steps < 1 ||
      (long long)(n_stripes - 1) * stripe_rows >= rows ||
      (long long)n_stripes * stripe_rows < rows ||
      (long long)steps * n_lanes < (long long)stripe_rows * cols)
    return (int)cudaErrorInvalidValue;
  const int np = (n_lanes + 31) / 32 * 32;
  // every slot index of a stripe, the top group's pad steps included
  const bool narrow =
      ((long long)steps + kGroup) * np < (1LL << 31);
  cudaStream_t st = (cudaStream_t)stream;
  // stages of 16 KB (32 KB past 64 lanes): at least 5 in the ring
  if (np <= 64)
    return narrow ? launch<int, 32>(bits, ctx, p_used, magic, scratch, flags,
                                    states, words, nbits, B, rows, cols,
                                    n_stripes, stripe_rows, steps, n_lanes,
                                    st)
                  : launch<long long, 32>(bits, ctx, p_used, magic, scratch,
                                          flags, states, words, nbits, B,
                                          rows, cols, n_stripes, stripe_rows,
                                          steps, n_lanes, st);
  if (np <= 128)
    return narrow ? launch<int, 16>(bits, ctx, p_used, magic, scratch, flags,
                                    states, words, nbits, B, rows, cols,
                                    n_stripes, stripe_rows, steps, n_lanes,
                                    st)
                  : launch<long long, 16>(bits, ctx, p_used, magic, scratch,
                                          flags, states, words, nbits, B,
                                          rows, cols, n_stripes, stripe_rows,
                                          steps, n_lanes, st);
  return narrow ? launch<int, 8>(bits, ctx, p_used, magic, scratch, flags,
                                 states, words, nbits, B, rows, cols,
                                 n_stripes, stripe_rows, steps, n_lanes, st)
                : launch<long long, 8>(bits, ctx, p_used, magic, scratch,
                                       flags, states, words, nbits, B, rows,
                                       cols, n_stripes, stripe_rows, steps,
                                       n_lanes, st);
}
