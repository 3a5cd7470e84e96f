// The serial K2 design (one dependent step per tile, the k search by a warp
// ballot), kept to be timed beside csrc/decide_modes.cu on the same inputs
// (chip_smoke.py's kernel_times).  Built on its own with
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC -I binary_image_compression_tpu_torch/csrc
//          -o k2_serial.so scripts/k2_serial.cu
// Entry point bic_decide_modes_serial: bic_decide_modes's arguments without
// the round counter and the guard (w4, hc, il, enb, out, B, T, n_enb,
// use_pred, mcost, ncost, stream).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_select.cuh"

namespace {

using bic::kFull;
constexpr int kBig = 1 << 28;
constexpr int kMaxEnb = 64 * 64 + 1;

__global__ void __launch_bounds__(32)
decide_modes_serial_kernel(const int32_t* __restrict__ w4,
                           const int32_t* __restrict__ hc,
                           const int32_t* __restrict__ il,
                           const int32_t* __restrict__ enb,
                           int32_t* __restrict__ out, int T, int n_enb,
                           int use_pred, int mcost, int ncost) {
  extern __shared__ int32_t s_enb[];
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < n_enb; i += 32) s_enb[i] = enb[i];
  __syncwarp();
  const int32_t* W4 = w4 + (size_t)b * T * 4;
  const int32_t* HC = hc + (size_t)b * T;
  const int32_t* IL = il + (size_t)b * T;
  int32_t* O = out + (size_t)b * T * 3;

  unsigned m_acc = 0, m_n = 0, n_acc = 0, n_n = 0;
  int m_k = 1, n_k = 1;  // Golomb.h constructor: k starts at 1
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0, ah = 0, ai = 0;
    if (t < T) {
      a0 = W4[4 * t]; a1 = W4[4 * t + 1]; a2 = W4[4 * t + 2]; a3 = W4[4 * t + 3];
      ah = HC[t]; ai = IL[t];
    }
    const int n_here = min(32, T - t0);
    int my_mode = 0, my_weight = 0, my_k = 0;
    for (int s = 0; s < n_here; ++s) {
      const int w0 = __shfl_sync(kFull, a0, s), w1 = __shfl_sync(kFull, a1, s);
      const int w2 = __shfl_sync(kFull, a2, s), w3 = __shfl_sync(kFull, a3, s);
      const int h = __shfl_sync(kFull, ah, s), l = __shfl_sync(kFull, ai, s);
      const int c0 = h ? mcost + l + m_k + (w0 >> m_k) + 1 + s_enb[w0] : kBig;
      const int c1 = (h && use_pred)
                         ? mcost + l + m_k + (w1 >> m_k) + 1 + s_enb[w1] : kBig;
      const int c2 = ncost + n_k + (w2 >> n_k) + 1 + s_enb[w2];
      const int c3 = use_pred ? ncost + n_k + (w3 >> n_k) + 1 + s_enb[w3] : kBig;
      int mode = 0, best = c0, weight = w0;
      if (c1 < best) { mode = 1; best = c1; weight = w1; }
      if (c2 < best) { mode = 2; best = c2; weight = w2; }
      if (c3 < best) { mode = 3; best = c3; weight = w3; }
      const bool match = mode < 2;
      if (lane == s) {
        my_mode = mode;
        my_weight = weight;
        my_k = match ? m_k : n_k;
      }
      const unsigned n = (match ? m_n : n_n) + 1u;
      const unsigned acc = (match ? m_acc : n_acc) + (unsigned)weight;
      const int k = bic::golomb_k(n, acc);
      if (match) { m_n = n; m_acc = acc; m_k = k; }
      else       { n_n = n; n_acc = acc; n_k = k; }
    }
    if (t < T) {
      O[3 * t] = my_mode;
      O[3 * t + 1] = my_weight;
      O[3 * t + 2] = my_k;
    }
  }
}

}  // namespace

// w4: int32 [B, T, 4]; hc, il: int32 [B, T]; enb: int32 [n_enb];
// out: int32 [B, T, 3].  Launches on `stream`, returns cudaGetLastError().
extern "C" int bic_decide_modes_serial(const void* w4, const void* hc,
                                       const void* il, const void* enb,
                                       void* out, int B, int T, int n_enb,
                                       int use_pred, int mcost, int ncost,
                                       void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (n_enb <= 0 || n_enb > kMaxEnb) return (int)cudaErrorInvalidValue;
  decide_modes_serial_kernel<<<B, 32, n_enb * sizeof(int32_t),
                               (cudaStream_t)stream>>>(
      (const int32_t*)w4, (const int32_t*)hc, (const int32_t*)il,
      (const int32_t*)enb, (int32_t*)out, T, n_enb, use_pred, mcost, ncost);
  return (int)cudaGetLastError();
}
