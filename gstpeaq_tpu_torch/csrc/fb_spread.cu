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
//       E0_c = |sum_{j>=c} CL^(j-c) A_j|^2                (lower slope)
//     K6 read the raw conv outputs and wrote E0 phase-major for the TPU's
//     back-masking GEMMs; on the flat layout it computes exactly K4's E0.
//     What bounds it: bytes, by the count.  Per instant it reads 2 x 40 + 39
//     values (no source walks from the top band's cu) and writes 40 (11.4 /
//     22.8 us at [2, 2, 40, 15000] at 3.35 TB/s), against 2 x 780 steps of the upper walk, a multiply and an add
//     each (and 2 x 40 of the lower recurrence): ~6 / ~12 us of issue on
//     132 SMs in float / double.  What holds it near half of that bound
//     on an H100 is neither alone: the copies, the walk and the stores of
//     a tile add up rather than overlap, since at that shape the tiles are
//     about one wave of blocks, which copy, walk and store together
//     (PERF.md section 6).
//     Design:
//       * persistent blocks (as many as fit the card) walk tiles of
//         kTileInstants<T> consecutive instants of the flat leads x
//         instants axis, any number of leads; cp.async copies a tile's
//         re, im and cu rows (runs of consecutive instants, 16 bytes a copy
//         where n and the pointers allow it, else 8, else one value) into
//         shared memory, one tile a block at a time: what a block walks,
//         it waits for, but at 30 KB a tile ~7 blocks share an SM and cover
//         each other's copies (a ring of 2 or more tiles a block left room
//         for 3 or fewer blocks an SM and was slower, PERF.md section 6);
//       * the lower table is Toeplitz, so the lower slope is the backward
//         recurrence B_39 = A_39, B_c = A_c + CL B_{c+1}, E0_c = |B_c|^2,
//         written as soon as B_c exists: 40 steps a component in place of
//         a [40, 40] product, and CL is one scalar of the working type (as
//         K3 takes aLe);
//       * the upper and lower maps are real-linear with real weights, so
//         the real and imaginary parts never mix before |.|^2: each has a
//         thread of its own, 40 accumulators A_j in registers, and the
//         two join by one __shfl_xor_sync (one thread an instant, with 80
//         accumulators, was slower, PERF.md section 6).  A warp
//         takes 16 consecutive instants, its low half-warp the real parts
//         and its high half the imaginary (whose rows sit 16 elements on,
//         so the halves read other banks), and both read the same cu;
//       * the upper slope walks w = fb_i cu_i^(j-i) by repeated
//         multiplication (the shift-multiply chain of K4 and the C
//         reference's loop), kWalkGroup sources in lockstep, so that a
//         step holds that many independent multiply-add chains; groups
//         run from the top down, so each A_i is still the plain fb_i when
//         it is read as a source, and A_j sums its terms from the nearest
//         source down, in the order of the plain per-source walk;
//       * plain multiplies and adds of the working type: no tensor cores,
//         no TF32.  Each value of E0 is computed once, the same way
//         whatever the grid: two launches give the same bits.
//     gstpeaq_tpu_torch/tools/spread_fb_ab.py times this form against
//     variants of its constants (other tiles, groups and grids) and
//     against another checkout's D2.
//
// Templated on float and double; no fast-math intrinsic is used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// D2: instants a tile; the rows a tile stages (re and im of each band, cu
// of all but the top one, which no walk reads) and the offset of the rows
// past re's; one thread a part (re, im) of each instant
template <typename T>
constexpr int kTileInstants = sizeof(T) == 4 ? 64 : 32;
constexpr int kTileRows = 3 * kZ - 1;
constexpr int kRowShift = 16;
constexpr int kWalkGroup = 16;          // sources the upper walk moves at once
template <typename T>
constexpr int kSpreadThreads = 2 * kTileInstants<T>;
template <typename T>
constexpr int kSpreadBytes =
    (kTileRows * kTileInstants<T> + kRowShift) * static_cast<int>(sizeof(T));

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

// Element (row, instant) of a staged tile: rows 0..39 re, 40..79 im,
// 80..118 cu, the rows past re's kRowShift elements on.
template <typename T>
__device__ __forceinline__ int tile_slot(int row, int instant) {
  return row * kTileInstants<T> + (row >= kZ ? kRowShift : 0) + instant;
}

// The flat instant g's offset in a [leads, kZ, n] array, band 0.
__device__ __forceinline__ long long instant_base(long long g, long long n) {
  const long long lead = g / n;
  return lead * kZ * n + (g - lead * n);
}

// Queue one copy of kVec consecutive instants of a row from `src` to `dst`
// (both aligned to its size).
template <typename T, int kVec>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  const auto to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

// Queue the copies of tile `tile` into `buf` as one cp.async group: each
// thread copies kVec consecutive instants of every kStride-th row, so a
// warp reads runs of consecutive instants of a few rows.  Instants past
// `total` copy the tile's last whole kVec again.
template <typename T, int kVec>
__device__ __forceinline__ void stage_tile(
    const T* __restrict__ fb_re, const T* __restrict__ fb_im,
    const T* __restrict__ cu, T* buf, long long tile, long long n,
    long long total) {
  constexpr int kI = kTileInstants<T>;
  constexpr int kChunks = kI / kVec;                   // copies a row
  constexpr int kStride = kSpreadThreads<T> / kChunks;  // rows at once
  const int instant = threadIdx.x % kChunks * kVec;
  const int row0 = threadIdx.x / kChunks;
  long long g = tile * kI + instant;
  if (g >= total) g = total - kVec;
  const long long base = instant_base(g, n) + row0 * n;
  const long long step = kStride * n;
  T* dst = buf + instant;  // + tile_slot's row offsets below
  const T* re = fb_re + base;
  const T* im = fb_im + base;
  const T* c = cu + base;
#pragma unroll 4
  for (int row = row0; row < kZ; row += kStride, re += step) {
    copy_async<T, kVec>(dst + row * kI, re);
  }
  dst += kZ * kI + kRowShift;
#pragma unroll 4
  for (int row = row0; row < kZ; row += kStride, im += step) {
    copy_async<T, kVec>(dst + row * kI, im);
  }
  dst += kZ * kI;
#pragma unroll 4
  for (int row = row0; row < kZ - 1; row += kStride, c += step) {
    copy_async<T, kVec>(dst + row * kI, c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// E0 of one staged tile; see the header.
template <typename T>
__device__ __forceinline__ void spread_tile(const T* buf, T cl,
                                            T* __restrict__ e0, long long tile,
                                            long long n, long long total) {
  constexpr int kI = kTileInstants<T>;
  constexpr int kSpan = kWarp / 2;           // instants a warp
  const int lane = threadIdx.x % kWarp;
  const int part = lane / kSpan;             // 0: re, 1: im
  const int instant = threadIdx.x / kWarp * kSpan + lane % kSpan;
  T a[kZ];
#pragma unroll
  for (int j = 0; j < kZ; ++j) {
    a[j] = buf[tile_slot<T>(part * kZ + j, instant)];
  }
  // the upper walk, kWalkGroup sources [lo, top] at a time from the top
  // down, each group in lockstep: at step s every source i of the group
  // moves on to band i + s (w_i *= cu_i, A_{i+s} += w_i), so a step holds
  // up to kWalkGroup independent chains.  A_j takes its terms from source
  // j - 1 down to 0, and each w_i starts from A_i before any lower source
  // has added to it
#pragma unroll
  for (int top = kZ - 2; top >= 0; top -= kWalkGroup) {
    const int lo = top >= kWalkGroup - 1 ? top - (kWalkGroup - 1) : 0;
    T c[kWalkGroup];
    T w[kWalkGroup];
#pragma unroll
    for (int k = 0; k < kWalkGroup; ++k) {
      if (lo + k <= top) {
        c[k] = buf[tile_slot<T>(2 * kZ + lo + k, instant)];
        w[k] = a[lo + k];
      }
    }
#pragma unroll
    for (int step = 1; step < kZ - lo; ++step) {
#pragma unroll
      for (int k = 0; k < kWalkGroup; ++k) {
        if (lo + k <= top && lo + k + step < kZ) {
          w[k] = w[k] * c[k];
          a[lo + k + step] = a[lo + k + step] + w[k];
        }
      }
    }
  }
  const long long g = tile * kI + instant;
  const bool live = g < total;
  const long long base = instant_base(live ? g : total - 1, n);
  T b = a[kZ - 1];
#pragma unroll
  for (int c = kZ - 1; c >= 0; --c) {
    if (c < kZ - 1) b = a[c] + cl * b;
    T e = b * b;
    e += __shfl_xor_sync(peaq::kFull, e, kSpan);
    // the halves take turns at the stores
    if (live && part == (c & 1)) e0[base + c * n] = e;
  }
}

// Persistent blocks over `tiles` tiles of the flat leads x instants axis
// (`total` instants): each block stages a tile into shared memory, copying
// kVec instants at a time, then computes it; see the header.
template <typename T, int kVec>
__global__ void __launch_bounds__(kSpreadThreads<T>)
spread_fb_kernel(const T* __restrict__ fb_re, const T* __restrict__ fb_im,
                 const T* __restrict__ cu, T cl, T* __restrict__ e0,
                 long long n, long long total, long long tiles) {
  extern __shared__ __align__(16) unsigned char spread_smem[];
  T* buf = reinterpret_cast<T*>(spread_smem);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    stage_tile<T, kVec>(fb_re, fb_im, cu, buf, tile, n, total);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    spread_tile<T>(buf, cl, e0, tile, n, total);
    __syncthreads();  // before the next tile overwrites the buffer
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

// D2's grid for copies of kVec instants: as many blocks as fit the card at
// once (at least one a SM), set up once per device: the shared memory a
// block asks for, then the occupancy.  0 on an error, with the error in
// *err.
template <typename T, int kVec>
long long spread_blocks(int* err) {
  constexpr int kMaxDevices = 64;
  static long long cached[kMaxDevices] = {};
  int device = 0, sms = 0, per_sm = 0;
  *err = static_cast<int>(cudaGetDevice(&device));
  if (*err != 0) return 0;
  if (device < kMaxDevices && cached[device] > 0) return cached[device];
  const auto kernel = spread_fb_kernel<T, kVec>;
  *err = static_cast<int>(cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device));
  if (*err == 0) {
    *err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSpreadBytes<T>));
  }
  if (*err == 0) {
    *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kSpreadThreads<T>, kSpreadBytes<T>));
  }
  if (*err != 0) return 0;
  const long long blocks =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cached[device] = blocks;
  return blocks;
}

template <typename T, int kVec>
int launch_spread_vec(const T* fb_re, const T* fb_im, const T* cu, T cl,
                      T* e0, long long total, long long n,
                      cudaStream_t stream) {
  int err = 0;
  long long blocks = spread_blocks<T, kVec>(&err);
  if (err != 0) return err;
  const long long tiles = (total + kTileInstants<T> - 1) / kTileInstants<T>;
  if (blocks > tiles) blocks = tiles;
  spread_fb_kernel<T, kVec>
      <<<static_cast<unsigned>(blocks), kSpreadThreads<T>, kSpreadBytes<T>,
         stream>>>(fb_re, fb_im, cu, cl, e0, n, total, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Whether kVec consecutive instants of every row start on a boundary of
// their size: n a multiple of kVec, and each pointer aligned.
template <typename T, int kVec>
bool vec_fits(long long n, const void* a, const void* b, const void* c) {
  constexpr auto kAlign = static_cast<uintptr_t>(kVec * sizeof(T));
  return n % kVec == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) %
          kAlign) == 0;
}

// Copies of 16 bytes where the rows allow them, else of 8, else of one
// value.
template <typename T>
int launch_spread(const void* fb_re, const void* fb_im, const void* cu,
                  double cl, void* e0, long long leads, long long n,
                  void* stream) {
  if (leads <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const auto* re = static_cast<const T*>(fb_re);
  const auto* im = static_cast<const T*>(fb_im);
  const auto* c = static_cast<const T*>(cu);
  auto* out = static_cast<T*>(e0);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long total = leads * n;
  const T cl_t = static_cast<T>(cl);
  constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));
  if (vec_fits<T, kVec16>(n, re, im, c)) {
    return launch_spread_vec<T, kVec16>(re, im, c, cl_t, out, total, n, s);
  }
  if constexpr (kVec16 > 2) {
    if (vec_fits<T, 2>(n, re, im, c)) {
      return launch_spread_vec<T, 2>(re, im, c, cl_t, out, total, n, s);
    }
  }
  return launch_spread_vec<T, 1>(re, im, c, cl_t, out, total, n, s);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns the first cudaGetLastError()
// that is not 0 (0 = ok).  rows = prod(lead) * z rows of n instants; leads
// = prod(lead).  slope_state makes two launches (one when a row is one
// tile): agg (scratch) is [rows, tiles]; y0 (nullable = a zero state) is
// [rows]; tiles and seg from ops/tile_scan.py::launch_plan; coef: the
// host's float64 factors, ops/cuda_fb.py::slope_factors(a, seg).
// spread_fb: cl = CL (FBEarConsts.cl), rounded to the working type here.
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
                       double cl, void* e0, long long leads, long long n,
                       void* stream) {
  return launch_spread<float>(fb_re, fb_im, cu, cl, e0, leads, n, stream);
}

int peaq_spread_fb_f64(const void* fb_re, const void* fb_im, const void* cu,
                       double cl, void* e0, long long leads, long long n,
                       void* stream) {
  return launch_spread<double>(fb_re, fb_im, cu, cl, e0, leads, n, stream);
}

}  // extern "C"
