// A variant of kernel K8 for scripts/k8_variants.py: the kernel of
// binary_image_compression_tpu_torch/csrc/eg_encode.cu with its writer
// replaced by one thread per chunk (lane 0 walks the chunk's runs from its
// entry and writes each code through a 64-bit accumulator, OR-ing every
// word into the payload atomically, as K8's first design did), so that the
// A/B of the two writers runs the same maps and look-back.  Build with
// -DK8_CHUNK_WORDS=16, 32 or 64.
#include "../binary_image_compression_tpu_torch/csrc/eg_encode.cu"

namespace {

// MSB-first bit writer into a zeroed word buffer, every word OR-ed
struct BitWriter {
  uint32_t* out;
  long long cap, word, bits;
  unsigned long long acc;
  int n;  // bits held in acc (the first word's leading bits count as 0s)

  __device__ BitWriter(uint32_t* o, long long cap_words, long long bitpos)
      : out(o), cap(cap_words), word(bitpos >> 5), bits(bitpos), acc(0),
        n(static_cast<int>(bitpos & 31)) {}

  __device__ __forceinline__ void emit(uint32_t v) {
    if (v && word < cap) atomicOr(out + word, v);
    ++word;
  }
  // len in 1..32, v < 2^len
  __device__ __forceinline__ void put(uint32_t v, int len) {
    acc = (acc << len) | v;
    n += len;
    bits += len;
    if (n >= 32) {
      n -= 32;
      emit(static_cast<uint32_t>(acc >> n));
      acc &= (1ull << n) - 1;
    }
  }
  __device__ __forceinline__ void code(const Code& cd) {
    int k = cd.nb;
    for (; k >= 32; k -= 32) put(kFull, 32);
    if (k) put((1u << k) - 1, k);
    put(static_cast<uint32_t>(cd.rem), cd.g + 1);  // '0' + g-bit remainder
  }
  __device__ __forceinline__ void flush() {
    if (n) emit(static_cast<uint32_t>(acc << (32 - n)));
  }
};

struct ThreadWriter {
  static __device__ long long emit(const Tables& tb, const ChunkRuns& cr,
                                   int s, long long a0, uint32_t*,
                                   uint32_t* out, int TW, int lane) {
    long long end = 0;
    if (lane == 0) {
      BitWriter bw(out, TW, a0);
      for (int i = 0; i < cr.R; ++i) {
        const int L = cr.len(i);
        const Code cd = i == 0 && cr.first0 ? eg_first(L)
                                            : eg_code(L, s, tb.cs[s]);
        bw.code(cd);
        s = cd.exit;
      }
      bw.flush();
      end = bw.bits;
    }
    return __shfl_sync(kFull, end, 0);
  }
};

}  // namespace

extern "C" int bic_eg_encode_thread(const void* res, const void* table,
                                    void* ws, void* words, void* nbits, int P,
                                    int rows, int cols, int nw, int TW,
                                    long long ws_ints, void* stream) {
  return k8_encode<ThreadWriter>(res, table, ws, words, nbits, P, rows, cols,
                                 nw, TW, ws_ints, stream);
}
