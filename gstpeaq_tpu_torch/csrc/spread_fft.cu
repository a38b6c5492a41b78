// Level-dependent frequency spreading of the FFT ear model, for Hopper
// (sm_90a).  BS.1387 / src/fftearmodel.c:636-676.
//
// Replaces the Pallas TPU kernel gstpeaq_tpu/ops/pallas_spread_fft.py,
// spread_fft (K3).  Per frame row p[0..Z) (bands last, Z <= 128):
//   aUCE_i = a_uc_i * p_i^(0.2 dz)
//   g_iu   = (1 - aUCE_i^(Z - i)) / (1 - aUCE_i)
//   Ene_i  = (p_i / (g_il_i + g_iu - 1))^0.4
//   E2_j   = sum_{i<j} Ene_i * exp((j - i) * 0.4 ln aUCE_i)   (upper part)
//          + sum_{i>=j} lower[i, j] * Ene_i                   (lower part)
//   out_j  = E2_j^2.5 / norm_j
//
// What bounds it on the H100: latency.  A 10 s stereo pair has ~1.9k rows
// of 109 bands; the work is ~Z^2/2 exps and Z^2/2 FMAs per row (~11 M exps
// in all) and only 2 * 8 bytes per band cross device memory, so the row's
// dependent chain (prelude, one barrier, one Z-long loop) sets the time.
// Design:
//   * one block per row, one thread per band; thread i computes its
//     source band's Ene_i and 0.4 ln aUCE_i once into shared memory;
//   * after one __syncthreads, thread j forms its destination band's sum:
//     the upper part from shared memory (broadcast reads), the lower part
//     as plain FMAs against `lower` read from global memory, coalesced
//     across j (the [Z, Z] table, <= 128 KB in double, stays in L2);
//   * the lower [Z, Z] product runs in the kernel in the working type: no
//     cuBLAS, no tensor cores, no TF32, the same full precision the TPU
//     kernel asks for with Precision.HIGHEST.
// Templated on float and double; no fast-math intrinsic is used.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxBands = 128;

__device__ __forceinline__ float pow_t(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_t(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

template <typename T>
__global__ void spread_fft_kernel(const T* __restrict__ p,
                                  const T* __restrict__ a_uc,
                                  const T* __restrict__ g_il,
                                  const T* __restrict__ lower,
                                  const T* __restrict__ norm, T dz02,
                                  T* __restrict__ out, int z) {
  __shared__ T ene[kMaxBands];
  __shared__ T log_rb[kMaxBands];
  const long long row = blockIdx.x;
  const int j = threadIdx.x;
  const T* prow = p + row * z;
  if (j < z) {
    const T pp = prow[j];
    const T a_uce = a_uc[j] * pow_t(pp, dz02);
    const T g_iu = (T(1) - pow_t(a_uce, T(z - j))) / (T(1) - a_uce);
    ene[j] = pow_t(pp / (g_il[j] + g_iu - T(1)), T(0.4));
    log_rb[j] = T(0.4) * log_t(a_uce);
  }
  __syncthreads();
  if (j >= z) return;
  T low = T(0);
  for (int i = j; i < z; ++i) low += lower[i * z + j] * ene[i];
  T up = T(0);
  for (int i = 0; i < j; ++i) up += ene[i] * exp_t(T(j - i) * log_rb[i]);
  const T e2 = low + up;
  out[row * z + j] = e2 * e2 * sqrt_t(e2) / norm[j];
}

template <typename T>
int launch_spread(const void* p, const void* a_uc, const void* g_il,
                  const void* lower, const void* norm, double dz02, void* out,
                  long long rows, int z, void* stream) {
  if (z < 1 || z > kMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    spread_fft_kernel<T><<<static_cast<unsigned>(rows), kMaxBands, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const T*>(a_uc),
        static_cast<const T*>(g_il), static_cast<const T*>(lower),
        static_cast<const T*>(norm), static_cast<T>(dz02),
        static_cast<T*>(out), z);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
int peaq_spread_fft_f32(const void* p, const void* a_uc, const void* g_il,
                        const void* lower, const void* norm, double dz02,
                        void* out, long long rows, int z, void* stream) {
  return launch_spread<float>(p, a_uc, g_il, lower, norm, dz02, out, rows, z,
                              stream);
}

int peaq_spread_fft_f64(const void* p, const void* a_uc, const void* g_il,
                        const void* lower, const void* norm, double dz02,
                        void* out, long long rows, int z, void* stream) {
  return launch_spread<double>(p, a_uc, g_il, lower, norm, dz02, out, rows, z,
                               stream);
}

}  // extern "C"
