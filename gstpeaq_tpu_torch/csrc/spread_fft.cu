// Level-dependent frequency spreading of the FFT ear model, for Hopper
// (sm_90a).  BS.1387 / src/fftearmodel.c:636-676.
//
// Replaces the Pallas TPU kernel gstpeaq_tpu/ops/pallas_spread_fft.py,
// spread_fft (K3).  Per frame row p[0..Z) (bands last, Z <= 128):
//   aUCE_i = a_uc_i * p_i^(0.2 dz)
//   g_iu   = (1 - aUCE_i^(Z - i)) / (1 - aUCE_i)
//   Ene_i  = (p_i / (g_il_i + g_iu - 1))^0.4
//   r_i    = aUCE_i^0.4
// each power in the TPU kernel's log form (pallas_spread_fft.py:37-47):
//   ln aUCE_i = ln a_uc_i + 0.2 dz ln p_i, and x^y = exp(y ln x)
//   E2_j   = sum_{i<j} Ene_i r_i^(j - i)                    (upper part)
//          + sum_{i>=j} aLe^(i - j) Ene_i                   (lower part)
//   out_j  = E2_j^2.5 / norm_j
//
// What bounds it on the H100: bytes, closely followed by operations.  A row
// needs Z(Z - 1) flops of the upper part (a multiply and an add per source
// and destination pair) and O(Z) more, of which 2 Z for the Toeplitz lower
// part, against 2 Z values that cross device memory; at Z = 109 the
// operations take ~0.8 of the bytes' time in either type.  So no exp per
// (source, destination) pair and no [Z, Z] table read per row.  Design:
//   * one warp per row, kRowsPerBlock rows a block, 4 consecutive bands a
//     lane; no shared memory and no block barrier;
//   * the per-band quantities (aUCE, g_iu, Ene, r) are the only
//     transcendentals: 3 logs and 4 exps per band, fewer instructions than
//     3 pows;
//   * the upper part is the TPU kernel's shift-multiply walk (pallas_
//     spread_fft.py:54-66): the walk w and the rolled base rb move up one
//     band a step, a register move inside a lane and one __shfl_up_sync
//     each across lanes, then w *= rb and E2 += w: one multiply and one add
//     per (band, step) in place of an exp per pair.  Only w enters lane 0
//     as 0: a band below the walk's front holds w = 0, so the copy of a
//     finite rb that lane 0 shifts in is multiplied by 0;
//   * the lower part is Toeplitz, lower[i, j] = aLe^(i - j), so it is the
//     backward recurrence L_j = Ene_j + aLe L_{j+1}: 4 serial steps in a
//     lane, a backward warp scan with factors (aLe^4)^(2^e) from the host
//     in float64, and 4 steps again from the lane's entry;
//   * plain multiplies and adds of the working type: no tensor cores, no
//     TF32.
// Templated on float and double; no fast-math intrinsic is used.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_scan.cuh"

namespace {

using peaq::kWarp;
using peaq::shfl_down;
using peaq::shfl_up;
using peaq::warp_scan_down;

constexpr int kBands = 4;                       // bands a lane
constexpr int kMaxBands = kBands * kWarp;       // 128
constexpr int kRowsPerBlock = 4;                // one warp a row

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// aLe and the backward scan's step factors (aLe^kBands)^(2^e).
template <typename T>
struct LowerFactors {
  T a;
  T step[5];
};

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
spread_fft_kernel(const T* __restrict__ p, const T* __restrict__ a_uc,
                  const T* __restrict__ g_il, const T* __restrict__ norm,
                  T dz02, T* __restrict__ out, long long rows, int z,
                  LowerFactors<T> lo) {
  const int lane = threadIdx.x % kWarp;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                        threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform over the warp
  const T* prow = p + row * z;
  // this lane's bands j = kBands lane + b; bands past Z hold zeros
  T ene[kBands], rb[kBands];
#pragma unroll
  for (int b = 0; b < kBands; ++b) {
    const int j = kBands * lane + b;
    ene[b] = rb[b] = T(0);
    if (j < z) {
      const T pp = prow[j];
      const T ln_p = log_t(pp);
      const T ln_auce = log_t(a_uc[j]) + dz02 * ln_p;
      const T a_uce = exp_t(ln_auce);
      const T g_iu = (T(1) - exp_t(T(z - j) * ln_auce)) / (T(1) - a_uce);
      ene[b] = exp_t(T(0.4) * (ln_p - log_t(g_il[j] + g_iu - T(1))));
      rb[b] = exp_t(T(0.4) * ln_auce);
    }
  }
  // the lower part: the lane's suffix from a zero entry, its entry (the
  // suffix at band kBands (lane + 1)) from the backward scan, then each band
  T s = ene[kBands - 1];
#pragma unroll
  for (int b = kBands - 2; b >= 0; --b) s = ene[b] + lo.a * s;
  T in = shfl_down(warp_scan_down(s, lo.step, lane), 1);
  if (lane == kWarp - 1) in = T(0);
  T e2[kBands];
#pragma unroll
  for (int b = kBands - 1; b >= 0; --b) in = e2[b] = ene[b] + lo.a * in;
  // the upper part: Z - 1 steps of the shift-multiply walk
  T w[kBands];
#pragma unroll
  for (int b = 0; b < kBands; ++b) w[b] = ene[b];
#pragma unroll 4
  for (int step = 1; step < z; ++step) {
    T w_in = shfl_up(w[kBands - 1], 1);
    const T r_in = shfl_up(rb[kBands - 1], 1);
    if (lane == 0) w_in = T(0);
#pragma unroll
    for (int b = kBands - 1; b > 0; --b) {
      w[b] = w[b - 1];
      rb[b] = rb[b - 1];
    }
    w[0] = w_in;
    rb[0] = r_in;
#pragma unroll
    for (int b = 0; b < kBands; ++b) {
      w[b] = w[b] * rb[b];
      e2[b] = e2[b] + w[b];
    }
  }
#pragma unroll
  for (int b = 0; b < kBands; ++b) {
    const int j = kBands * lane + b;
    if (j < z) out[row * z + j] = e2[b] * e2[b] * sqrt_t(e2[b]) / norm[j];
  }
}

template <typename T>
int launch_spread(const void* p, const void* a_uc, const void* g_il,
                  const void* norm, double dz02, const double* lower,
                  void* out, long long rows, int z, void* stream) {
  if (z < 1 || z > kMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    LowerFactors<T> lo;
    lo.a = static_cast<T>(lower[0]);
    for (int e = 0; e < 5; ++e) lo.step[e] = static_cast<T>(lower[e + 1]);
    const auto blocks = static_cast<unsigned>(
        (rows + kRowsPerBlock - 1) / kRowsPerBlock);
    spread_fft_kernel<T><<<blocks, kWarp * kRowsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const T*>(a_uc),
        static_cast<const T*>(g_il), static_cast<const T*>(norm),
        static_cast<T>(dz02), static_cast<T*>(out), rows, z, lo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// lower: the host's float64 factors, ops/cuda_spread_fft.py::
// lower_factors(aLe): aLe, then (aLe^4)^(2^e) for e = 0..4.
int peaq_spread_fft_f32(const void* p, const void* a_uc, const void* g_il,
                        const void* norm, double dz02, const double* lower,
                        void* out, long long rows, int z, void* stream) {
  return launch_spread<float>(p, a_uc, g_il, norm, dz02, lower, out, rows, z,
                              stream);
}

int peaq_spread_fft_f64(const void* p, const void* a_uc, const void* g_il,
                        const void* norm, double dz02, const double* lower,
                        void* out, long long rows, int z, void* stream) {
  return launch_spread<double>(p, a_uc, g_il, norm, dz02, lower, out, rows, z,
                               stream);
}

}  // extern "C"
