// Banded first-order recurrences of the FFT ear model, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gstpeaq_tpu/ops/pallas_iir.py:
//   K1  recurrence_banded     y_t = a_z * y_{t-1} + b_t along the frame axis,
//                             y_{-1} = y0 (or 0)
//   K2  fused_mod_smoothers   loud = uns^0.3, deriv = scale * |loud_t -
//                             loud_{t-1}|, three (1 - a)-scaled recurrences
//                             over exc, deriv and loud, and
//                             mod = filt_deriv / (1 + filt_loud / 0.3)
//
// Layout: [rows, F] with rows = prod(lead) * Z, one contiguous row of frames
// per (lead, band); the band of a row is row % Z.
//
// What bounds it on the H100: bytes.  K1 reads b once and writes y once; K2
// reads exc and uns once and writes three outputs.  The arithmetic (a few
// FMAs and shuffles per element, one pow per element in K2) is far below
// the card's rate.  The rows are short (F ~ 468 frames for 10 s of audio),
// so the design keeps every access coalesced and the dependency chain short
// instead of spreading one row over blocks:
//   * one warp per row; the warp walks its row in 32-frame chunks, one
//     frame per lane, so each chunk is one coalesced load and store;
//   * inside a chunk a Hillis-Steele shuffle scan (5 steps, warp_scan.cuh)
//     forms the chunk-local sums sum_s a^(l-s) b_s with the step factors
//     a^(2^e), built by repeated squaring in the working type;
//   * the state entering the chunk (the carry, y0 for the first chunk) is
//     added as a^(l+1) * carry, and lane 31's y becomes the next carry.
// K2 builds its three drives in registers, carries loud_{t-1} across chunk
// boundaries through lane 31, and runs the three scans on the same powers.
// Nothing is staged in shared memory and nothing is allocated.
//
// Both kernels are templated on float and double; no fast-math intrinsic is
// used (pow, division and the shuffles are IEEE).

#include <cuda_runtime.h>
#include <math.h>

#include "warp_scan.cuh"

namespace {

using peaq::kFull;
using peaq::kWarp;
using peaq::lane_powers;
using peaq::LanePowers;
using peaq::warp_scan;

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float pow_t(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_t(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

template <typename T>
__global__ void recurrence_banded_kernel(const T* __restrict__ a,
                                         const T* __restrict__ b,
                                         const T* __restrict__ y0,
                                         T* __restrict__ y, long long rows,
                                         int z, long long f) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform over the warp
  const LanePowers<T> p = lane_powers(a[row % z], lane);
  const T* src = b + row * f;
  T* dst = y + row * f;
  T carry = y0 != nullptr ? y0[row] : T(0);
  for (long long t0 = 0; t0 < f; t0 += kWarp) {
    const long long t = t0 + lane;
    const T x = warp_scan(t < f ? src[t] : T(0), p, lane);
    const T yt = x + p.carry * carry;
    if (t < f) dst[t] = yt;
    carry = __shfl_sync(kFull, yt, kWarp - 1);
  }
}

template <typename T>
__global__ void fused_mod_smoothers_kernel(
    const T* __restrict__ a, const T* __restrict__ exc,
    const T* __restrict__ uns, T* __restrict__ exc_filt, T* __restrict__ mod,
    T* __restrict__ loud_filt, long long rows, int z, long long f, T scale) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform over the warp
  const T az = a[row % z];
  const T oma = T(1) - az;
  const LanePowers<T> p = lane_powers(az, lane);
  const long long base = row * f;
  T c_exc = T(0), c_deriv = T(0), c_loud = T(0), last_loud = T(0);
  for (long long t0 = 0; t0 < f; t0 += kWarp) {
    const long long t = t0 + lane;
    const bool valid = t < f;
    const T e = valid ? exc[base + t] : T(0);
    const T loud = valid ? pow_t(uns[base + t], T(0.3)) : T(0);
    T prev = __shfl_up_sync(kFull, loud, 1);
    if (lane == 0) prev = last_loud;
    const T deriv = scale * abs_t(loud - prev);
    const T ye = warp_scan(oma * e, p, lane) + p.carry * c_exc;
    const T yd = warp_scan(oma * deriv, p, lane) + p.carry * c_deriv;
    const T yl = warp_scan(oma * loud, p, lane) + p.carry * c_loud;
    if (valid) {
      exc_filt[base + t] = ye;
      mod[base + t] = yd / (T(1) + yl / T(0.3));
      loud_filt[base + t] = yl;
    }
    c_exc = __shfl_sync(kFull, ye, kWarp - 1);
    c_deriv = __shfl_sync(kFull, yd, kWarp - 1);
    c_loud = __shfl_sync(kFull, yl, kWarp - 1);
    last_loud = __shfl_sync(kFull, loud, kWarp - 1);
  }
}

unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T>
int launch_recurrence(const void* a, const void* b, const void* y0, void* y,
                      long long rows, int z, long long f, void* stream) {
  if (rows > 0 && f > 0) {
    recurrence_banded_kernel<T>
        <<<blocks_for(rows), kWarp * kWarpsPerBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<const T*>(y0), static_cast<T*>(y), rows, z, f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused_mod(const void* a, const void* exc, const void* uns,
                     void* exc_filt, void* mod, void* loud_filt,
                     long long rows, int z, long long f, double scale,
                     void* stream) {
  if (rows > 0 && f > 0) {
    fused_mod_smoothers_kernel<T>
        <<<blocks_for(rows), kWarp * kWarpsPerBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(a), static_cast<const T*>(exc),
            static_cast<const T*>(uns), static_cast<T*>(exc_filt),
            static_cast<T*>(mod), static_cast<T*>(loud_filt), rows, z, f,
            static_cast<T>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
int peaq_recurrence_banded_f32(const void* a, const void* b, const void* y0,
                               void* y, long long rows, int z, long long f,
                               void* stream) {
  return launch_recurrence<float>(a, b, y0, y, rows, z, f, stream);
}

int peaq_recurrence_banded_f64(const void* a, const void* b, const void* y0,
                               void* y, long long rows, int z, long long f,
                               void* stream) {
  return launch_recurrence<double>(a, b, y0, y, rows, z, f, stream);
}

int peaq_fused_mod_smoothers_f32(const void* a, const void* exc,
                                 const void* uns, void* exc_filt, void* mod,
                                 void* loud_filt, long long rows, int z,
                                 long long f, double scale, void* stream) {
  return launch_fused_mod<float>(a, exc, uns, exc_filt, mod, loud_filt, rows,
                                 z, f, scale, stream);
}

int peaq_fused_mod_smoothers_f64(const void* a, const void* exc,
                                 const void* uns, void* exc_filt, void* mod,
                                 void* loud_filt, long long rows, int z,
                                 long long f, double scale, void* stream) {
  return launch_fused_mod<double>(a, exc, uns, exc_filt, mod, loud_filt, rows,
                                  z, f, scale, stream);
}

const char* peaq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
