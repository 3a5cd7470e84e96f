// Variants of the BSVD pursuit kernel (csrc/packed_pursuit.cuh) for
// scripts/pursuit_times.py --variants: G = 16 and G = 8 lanes a row (two
// and four rows a warp), where the library's kernel takes a warp a row
// (G = 32).  Same arguments as bic_packed_pursuit.  Built beside the
// kernels with -I csrc.

#include "packed_pursuit.cuh"

extern "C" int bic_packed_pursuit_g16(void* Ep, const void* Dp, void* A,
                                      void* passes, void* ctr, int N, int K,
                                      int nw, int max_flips, int stage,
                                      void* stream) {
  return bic::packed_pursuit<16>(Ep, Dp, A, passes, ctr, N, K, nw, max_flips,
                                 stage, stream);
}

extern "C" int bic_packed_pursuit_g8(void* Ep, const void* Dp, void* A,
                                     void* passes, void* ctr, int N, int K,
                                     int nw, int max_flips, int stage,
                                     void* stream) {
  return bic::packed_pursuit<8>(Ep, Dp, A, passes, ctr, N, K, nw, max_flips,
                                stage, stream);
}
