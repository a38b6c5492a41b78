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
//     What bounds it: bytes (read re and im, write cu: 28.8 MB in float,
//     57.6 MB in double at [2, 2, 40, 15000], 8.6 / 17.2 us at 3.35 TB/s)
//     once the work is spread over the card, and the log10 and the power
//     per instant in double.  A row is a serial recurrence and there are
//     only 160 rows, so one warp per row would leave most of the card idle.
//     Design: tile_scan.cuh's, as D3 uses it.  Each row is cut into tiles
//     of kTile = 2048 instants, one block of 256 threads each (1,280 blocks
//     at the main shape), and each call makes two launches:
//       ends  the zero-entry end of the recurrence over each tile but the
//             row's last (whose end no tile reads), into agg
//       cu    each tile's entry state (the carried y0 and its row's earlier
//             tile ends, folded by one warp in one fixed order), then cu
//     Both compute the drive while staging the tile coalesced through
//     shared memory; the second launch computes it again rather than store
//     it, since bytes bound the kernel.  DIST^s is exp(s ln DIST) with
//     ln DIST a float64 constant: one exp in place of a pow.  Every power
//     a^n comes from the host in float64 (ops/cuda_fb.py::slope_factors).
//     No atomics: two launches give the same bits.
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

#include "tile_scan.cuh"

namespace {

using peaq::fill;
using peaq::kRun;
using peaq::kSlots;
using peaq::kThreads;
using peaq::kTile;
using peaq::kWarp;
using peaq::kWarps;
using peaq::plan_fits;
using peaq::Powers;
using peaq::run_end;
using peaq::run_entry;
using peaq::slot;
using peaq::tile_end;
using peaq::tile_entry;

constexpr int kZ = 40;                  // FB band count (BS.1387 Table 8)
// ln DIST, DIST = 0.921851456499719 (src/fbearmodel.c:50)
constexpr double kLnDist = -0.08137117849224008;
constexpr int kSpreadThreads = 128;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log10_t(float x) { return log10f(x); }
__device__ __forceinline__ double log10_t(double x) { return log10(x); }

template <typename T>
struct SlopeCoef {
  Powers<T> p;  // the smoother's decay a and its powers
  T oma;        // 1 - a
};

// The slope filter's drive (1 - a) DIST^s at one instant; a silent instant
// (re = im = 0) gives level = -inf, s = +inf and 0.
template <typename T>
__device__ __forceinline__ T slope_drive(T re, T im, T c1, T oma) {
  const T level = T(10) * log10_t(re * re + im * im);
  const T s0 = c1 - T(0.2) * level;
  const T s = s0 > T(4) ? s0 : T(4);
  return oma * exp_t(s * static_cast<T>(kLnDist));
}

// Tile `tile` of row `row`: its zero-entry end into agg (kCu false), or cu
// from its entry state (kCu true).
template <typename T, bool kCu>
__device__ __forceinline__ void slope_tile(
    const T* __restrict__ fb_re, const T* __restrict__ fb_im,
    const T* __restrict__ c1_band, const T* __restrict__ y0,
    T* __restrict__ cu, T* __restrict__ agg, int z, long long n,
    long long row, long long tile, long long tiles, long long seg,
    const SlopeCoef<T>& co) {
  __shared__ T sh[kSlots<T>];
  __shared__ T ends[kWarps];
  __shared__ T entry;
  const int k = threadIdx.x;
  const long long t0 = tile * kTile;
  const int m = n - t0 < kTile ? static_cast<int>(n - t0) : kTile;
  const long long base = row * n + t0;
  const T c1 = c1_band[row % z];
  for (int i = k; i < kTile; i += kThreads) {
    sh[slot<T>(i)] = i < m ? slope_drive(fb_re[base + i], fb_im[base + i],
                                         c1, co.oma)
                           : T(0);
  }
  __syncthreads();
  T v[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) v[j] = sh[slot<T>(k * kRun + j)];
  T* agg_row = agg + row * tiles;
  if constexpr (!kCu) {
    const T a = tile_end(run_end(co.p.a, v), co.p, ends);
    if (k == 0) agg_row[tile] = a;
  } else {
    if (k < kWarp) {
      const T c = tile_entry<T>(agg_row, tile, seg,
                                y0 != nullptr ? y0[row] : T(0), co.p);
      if (k == kWarp - 1) entry = c;
    }
    // every read of the tile's drive lies before run_entry's barriers
    T y = run_entry(run_end(co.p.a, v), &entry, co.p, ends);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      sh[slot<T>(k * kRun + j)] = y = co.p.a * y + v[j];
    }
    __syncthreads();
    for (int i = k; i < m; i += kThreads) cu[base + i] = sh[slot<T>(i)];
  }
}

// One block per tile but each row's last: tiles - 1 blocks a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
slope_state_ends_kernel(const T* __restrict__ fb_re,
                        const T* __restrict__ fb_im,
                        const T* __restrict__ c1_band, T* __restrict__ agg,
                        int z, long long n, long long tiles, long long seg,
                        SlopeCoef<T> co) {
  const long long row = blockIdx.x / (tiles - 1);
  const long long tile = blockIdx.x % (tiles - 1);
  slope_tile<T, false>(fb_re, fb_im, c1_band, nullptr, nullptr, agg, z, n,
                       row, tile, tiles, seg, co);
}

// One block per tile: tiles blocks a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
slope_state_cu_kernel(const T* __restrict__ fb_re,
                      const T* __restrict__ fb_im,
                      const T* __restrict__ c1_band,
                      const T* __restrict__ y0, T* __restrict__ cu,
                      T* __restrict__ agg, int z, long long n,
                      long long tiles, long long seg, SlopeCoef<T> co) {
  slope_tile<T, true>(fb_re, fb_im, c1_band, y0, cu, agg, z, n,
                      blockIdx.x / tiles, blockIdx.x % tiles, tiles, seg, co);
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
                 const void* y0, void* cu, void* agg, long long rows, int z,
                 long long n, long long tiles, long long seg,
                 const double* coef, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (z < 1 || !plan_fits(rows, n, tiles, seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlopeCoef<T> co;
  co.oma = static_cast<T>(*fill(co.p, coef));
  const auto s = static_cast<cudaStream_t>(stream);
  const T* re = static_cast<const T*>(fb_re);
  const T* im = static_cast<const T*>(fb_im);
  const T* c1 = static_cast<const T*>(c1_band);
  if (tiles > 1) {
    slope_state_ends_kernel<T>
        <<<static_cast<unsigned>(rows * (tiles - 1)), kThreads, 0, s>>>(
            re, im, c1, static_cast<T*>(agg), z, n, tiles, seg, co);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  slope_state_cu_kernel<T><<<static_cast<unsigned>(rows * tiles), kThreads, 0,
                             s>>>(
      re, im, c1, static_cast<const T*>(y0), static_cast<T*>(cu),
      static_cast<T*>(agg), z, n, tiles, seg, co);
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

// Each entry launches on `stream` and returns the first cudaGetLastError()
// that is not 0 (0 = ok).  rows = prod(lead) * z rows of n instants; leads
// = prod(lead).  slope_state makes two launches (one when a row is one
// tile): agg (scratch) is [rows, tiles]; y0 (nullable = a zero state) is
// [rows]; tiles and seg from ops/tile_scan.py::launch_plan; coef: the
// host's float64 factors, ops/cuda_fb.py::slope_factors(a, seg).
int peaq_slope_state_f32(const void* fb_re, const void* fb_im,
                         const void* c1_band, const void* y0, void* cu,
                         void* agg, long long rows, int z, long long n,
                         long long tiles, long long seg, const double* coef,
                         void* stream) {
  return launch_slope<float>(fb_re, fb_im, c1_band, y0, cu, agg, rows, z, n,
                             tiles, seg, coef, stream);
}

int peaq_slope_state_f64(const void* fb_re, const void* fb_im,
                         const void* c1_band, const void* y0, void* cu,
                         void* agg, long long rows, int z, long long n,
                         long long tiles, long long seg, const double* coef,
                         void* stream) {
  return launch_slope<double>(fb_re, fb_im, c1_band, y0, cu, agg, rows, z, n,
                              tiles, seg, coef, stream);
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
