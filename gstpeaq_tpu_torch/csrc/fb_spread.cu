// The filter-bank ear model's slope filter and frequency spreading, for
// Hopper (sm_90a).  BS.1387 / src/fbearmodel.c:326-360.
//
// Layout: [..., Z, I] with Z = 40 bands and I subsampled instants (one every
// 32 samples), one contiguous row of instants per (lead, band): the JAX
// package's transposed FB layout.
//
// D1  slope_state  replaces gstpeaq_tpu/ops/pallas_fb.py::
//     slope_prefixes_from_conv (K5).  Per (lead, band) row:
//       level  = 10 log10(re^2 + im^2)
//       s      = max(4, c1_band - 0.2 level),   c1_band = 24 + 230 / fc
//       cu_t   = a cu_{t-1} + (1 - a) DIST^s,   cu_{-1} = y0 (or 0)
//     K5 produced the Horner prefixes of a 4-phase split of this recurrence,
//     which exists only because the TPU kernel tiles the instant axis by
//     phases; on the flat layout the recurrence yields cu directly.  A
//     silent instant (re = im = 0) gives level = -inf, s = +inf and
//     DIST^s = 0, never NaN.
//     What bounds it: bytes (read re and im, write cu) and one log10 and
//     one pow per element.  Design: K1's (recurrence.cu) with the drive
//     fused in: one warp per row walks it in 32-instant chunks, one
//     coalesced load per chunk, the drive in registers, the shuffle scan of
//     warp_scan.cuh, and the carry from lane 31.
//
// D2  spread_fb    replaces pallas_fb.py::spread_apply (K4) and
//     spread_from_conv (K6).  Per (lead, instant):
//       A_j  = fb_j + sum_{i<j} fb_i cu_i^(j-i)         (upper slope)
//       E0_c = |sum_{j>=c} lower[j, c] A_j|^2             (lower slope)
//     K6 read the raw conv outputs and wrote E0 phase-major for the TPU's
//     back-masking GEMMs; on the flat layout it computes exactly K4's E0.
//     What bounds it: arithmetic and registers.  Per instant it reads 3 x 40
//     values and writes 40, against 2 x 780 shift-multiply steps and
//     2 x 820 FMAs of the lower product.  Design: one thread per (lead,
//     instant), so neighbouring threads read neighbouring instants and every
//     load is coalesced; Z = 40 is a compile-time constant and the loops are
//     unrolled, so the 80 accumulators A_j stay in registers.  The upper
//     slope walks w = fb_i cu_i^(j-i) by repeated multiplication (the shift-
//     multiply chain of K4 and the C reference's loop); source bands run
//     from the top down, so each A_i is still the plain fb_i when it is
//     read as a source.  The lower product runs against the [40, 40]
//     matrix staged in shared memory (every thread reads the same entry:
//     a broadcast), in plain FMAs of the working type: no tensor cores, no
//     TF32, the full precision K4 asks for with Precision.HIGHEST.
//
// Templated on float and double; no fast-math intrinsic is used.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_scan.cuh"

namespace {

using peaq::kFull;
using peaq::kWarp;
using peaq::lane_powers;
using peaq::LanePowers;
using peaq::warp_scan;

constexpr int kZ = 40;                  // FB band count (BS.1387 Table 8)
constexpr double kDist = 0.921851456499719;  // src/fbearmodel.c:50
constexpr int kWarpsPerBlock = 4;
constexpr int kSpreadThreads = 128;

__device__ __forceinline__ float pow_t(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_t(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float log10_t(float x) { return log10f(x); }
__device__ __forceinline__ double log10_t(double x) { return log10(x); }

template <typename T>
__global__ void slope_state_kernel(const T* __restrict__ fb_re,
                                   const T* __restrict__ fb_im,
                                   const T* __restrict__ c1_band, T a,
                                   T oma, const T* __restrict__ y0,
                                   T* __restrict__ cu, long long rows, int z,
                                   long long n) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform over the warp
  const T c1 = c1_band[row % z];
  const T dist = static_cast<T>(kDist);
  const LanePowers<T> p = lane_powers(a, lane);
  const long long base = row * n;
  T carry = y0 != nullptr ? y0[row] : T(0);
  for (long long t0 = 0; t0 < n; t0 += kWarp) {
    const long long t = t0 + lane;
    T drive = T(0);
    if (t < n) {
      const T re = fb_re[base + t];
      const T im = fb_im[base + t];
      const T level = T(10) * log10_t(re * re + im * im);
      const T s0 = c1 - T(0.2) * level;
      const T s = s0 > T(4) ? s0 : T(4);
      drive = oma * pow_t(dist, s);
    }
    const T y = warp_scan(drive, p, lane) + p.carry * carry;
    if (t < n) cu[base + t] = y;
    carry = __shfl_sync(kFull, y, kWarp - 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSpreadThreads)
spread_fb_kernel(const T* __restrict__ fb_re, const T* __restrict__ fb_im,
                 const T* __restrict__ cu, const T* __restrict__ lower,
                 T* __restrict__ e0, long long n) {
  __shared__ T low[kZ * kZ];
  for (int i = threadIdx.x; i < kZ * kZ; i += blockDim.x) low[i] = lower[i];
  __syncthreads();
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long base = static_cast<long long>(blockIdx.y) * kZ * n + t;
  T ar[kZ];
  T ai[kZ];
#pragma unroll
  for (int j = 0; j < kZ; ++j) {
    ar[j] = fb_re[base + j * n];
    ai[j] = fb_im[base + j * n];
  }
#pragma unroll
  for (int i = kZ - 2; i >= 0; --i) {
    const T c = cu[base + i * n];
    T wr = ar[i];
    T wi = ai[i];
#pragma unroll
    for (int j = i + 1; j < kZ; ++j) {
      wr = wr * c;
      wi = wi * c;
      ar[j] = ar[j] + wr;
      ai[j] = ai[j] + wi;
    }
  }
#pragma unroll
  for (int c = 0; c < kZ; ++c) {
    T fr = T(0);
    T fi = T(0);
#pragma unroll
    for (int j = c; j < kZ; ++j) {
      fr += low[j * kZ + c] * ar[j];
      fi += low[j * kZ + c] * ai[j];
    }
    e0[base + c * n] = fr * fr + fi * fi;
  }
}

template <typename T>
int launch_slope(const void* fb_re, const void* fb_im, const void* c1_band,
                 double a, const void* y0, void* cu, long long rows, int z,
                 long long n, void* stream) {
  if (rows > 0 && n > 0) {
    const unsigned blocks =
        static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    slope_state_kernel<T><<<blocks, kWarp * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(fb_re), static_cast<const T*>(fb_im),
        static_cast<const T*>(c1_band), static_cast<T>(a),
        static_cast<T>(1.0 - a), static_cast<const T*>(y0),
        static_cast<T*>(cu), rows, z, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spread(const void* fb_re, const void* fb_im, const void* cu,
                  const void* lower, void* e0, long long leads, long long n,
                  void* stream) {
  if (leads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (leads > 0 && n > 0) {
    const dim3 grid(
        static_cast<unsigned>((n + kSpreadThreads - 1) / kSpreadThreads),
        static_cast<unsigned>(leads));
    spread_fb_kernel<T><<<grid, kSpreadThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(fb_re), static_cast<const T*>(fb_im),
        static_cast<const T*>(cu), static_cast<const T*>(lower),
        static_cast<T*>(e0), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// rows = prod(lead) * z rows of n instants; leads = prod(lead).
int peaq_slope_state_f32(const void* fb_re, const void* fb_im,
                         const void* c1_band, double a, const void* y0,
                         void* cu, long long rows, int z, long long n,
                         void* stream) {
  return launch_slope<float>(fb_re, fb_im, c1_band, a, y0, cu, rows, z, n,
                             stream);
}

int peaq_slope_state_f64(const void* fb_re, const void* fb_im,
                         const void* c1_band, double a, const void* y0,
                         void* cu, long long rows, int z, long long n,
                         void* stream) {
  return launch_slope<double>(fb_re, fb_im, c1_band, a, y0, cu, rows, z, n,
                              stream);
}

int peaq_spread_fb_f32(const void* fb_re, const void* fb_im, const void* cu,
                       const void* lower, void* e0, long long leads,
                       long long n, void* stream) {
  return launch_spread<float>(fb_re, fb_im, cu, lower, e0, leads, n, stream);
}

int peaq_spread_fb_f64(const void* fb_re, const void* fb_im, const void* cu,
                       const void* lower, void* e0, long long leads,
                       long long n, void* stream) {
  return launch_spread<double>(fb_re, fb_im, cu, lower, e0, leads, n, stream);
}

}  // extern "C"
