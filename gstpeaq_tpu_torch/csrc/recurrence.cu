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
// FMAs per element, one pow per element in K2) is far below the card's
// rate.  But the rows are few (160 at the FB ear's [2, 2, 40, 2500], 436 at
// the basic [2, 2, 109, 468]) and each is a serial chain, so one warp per
// row left most SMs idle and walked 79 dependent 32-frame chunks per row.
// Design: tile_scan.cuh's runs and slots, one block per row, one launch:
//   * a row of F frames gets the fewest warps, up to kMaxWarps, whose tile
//     of kRun frames a thread covers it: 10 warps and 2,560 frames for the
//     FB ear's rows, 2 warps and 512 frames for the basic rows; registers
//     are capped so that two blocks of 10 warps fit an SM, and the FB
//     ear's 160 rows run in one wave on 132 SMs;
//   * the block stages a tile coalesced through shared memory (slot()'s
//     skew keeps the runs' reads on distinct banks); each thread scans its
//     run of kRun frames serially in registers; run_entry's warp scan and
//     fixed-order fold of the warp ends give each run its entry state;
//   * a longer row is walked tile by tile in the block: the last run's last
//     state enters the next tile through shared memory, and the next tile's
//     b (K1) or uns (K2, whose pow waits on it) is loaded into registers
//     before the current tile is scanned;
//   * thread 0 forms the row's powers a^(kRun 2^e) and a^(kRun kWarp) by
//     repeated squaring in double from a_z, rounds them to the working type
//     and leaves them in shared memory, where they take no registers: no
//     host table and no torch op before the launch;
//   * no cross-block carry and no atomics: two launches give the same bits.
// K2 stages loud = uns^0.3 and exc, builds its three drives from the staged
// tile (loud_{t-1} of a run's first frame is the frame before it in shared
// memory, or the previous tile's last loud, 0 for the row's first frame),
// and scans the three recurrences as one tuple state with the same powers.
//
// Both kernels are templated on float and double; no fast-math intrinsic is
// used (pow, division and the shuffles are IEEE).

#include <cuda_runtime.h>
#include <math.h>

#include "tile_scan.cuh"

namespace {

using peaq::kFull;
using peaq::kGridLimit;
using peaq::kRun;
using peaq::kSkew;
using peaq::kWarp;
using peaq::run_end;
using peaq::run_entry;
using peaq::slot;

constexpr int kMaxWarps = 10;                     // warps a block, at most
constexpr int kMaxThreads = kMaxWarps * kWarp;    // 320
constexpr int kMaxTile = kRun * kMaxThreads;      // 2,560 frames
template <typename T>
constexpr int kRowSlots = kMaxTile + kMaxTile / kSkew<T>;

__device__ __forceinline__ float pow_t(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_t(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// The threads of a row's block: the fewest whole warps, up to kMaxWarps,
// whose runs of kRun frames cover f frames.
int block_threads(long long f) {
  const long long warps = (f + kRun * kWarp - 1) / (kRun * kWarp);
  return kWarp * static_cast<int>(warps < kMaxWarps ? warps : kMaxWarps);
}

// The powers of a row's coefficient that run_entry reads.
template <typename T>
struct RowPowers {
  T run[5];   // a^(kRun 2^e): the warp scan's step factors over runs
  T warp;     // a^(kRun kWarp): one warp's stretch
};

template <typename T>
__device__ __forceinline__ RowPowers<T> row_powers(T a) {
  static_assert(kRun == 8, "a^kRun is three squarings");
  RowPowers<T> p;
  double s = static_cast<double>(a);
  s *= s;
  s *= s;
  s *= s;
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    p.run[e] = static_cast<T>(s);
    s *= s;
  }
  p.warp = static_cast<T>(s);
  return p;
}

// K2's three states (exc, deriv, loud), scanned with one real factor.
template <typename T>
struct Tri {
  T e, d, l;
};

template <typename T>
__device__ __forceinline__ Tri<T> mul(T a, Tri<T> y) {
  return {a * y.e, a * y.d, a * y.l};
}
template <typename T>
__device__ __forceinline__ Tri<T> add(Tri<T> x, Tri<T> y) {
  return {x.e + y.e, x.d + y.d, x.l + y.l};
}
template <typename T>
__device__ __forceinline__ Tri<T> shfl_up(Tri<T> v, int off) {
  return {__shfl_up_sync(kFull, v.e, off), __shfl_up_sync(kFull, v.d, off),
          __shfl_up_sync(kFull, v.l, off)};
}
template <typename T>
__device__ __forceinline__ Tri<T> rec(T a, Tri<T> y, Tri<T> v) {
  return {a * y.e + v.e, a * y.d + v.d, a * y.l + v.l};
}

// The frames of a row of f frames in the tile that starts at frame t0.
__device__ __forceinline__ int tile_frames(long long f, long long t0,
                                           int tile) {
  return f - t0 < tile ? static_cast<int>(f - t0) : tile;
}

// Thread k's share of a tile of m frames at src: frames k + j * blockDim.x,
// j < kRun (coalesced), 0 past the row.
template <typename T>
__device__ __forceinline__ void load_tile(T (&r)[kRun],
                                          const T* __restrict__ src, int m) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    r[j] = i < m ? src[i] : T(0);
  }
}

// The first m frames of a staged tile out to dst, coalesced.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const T* sh,
                                           int m) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = sh[slot<T>(i)];
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
recurrence_banded_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ y0, T* __restrict__ y, int z,
                         long long f) {
  __shared__ T sh[kRowSlots<T>];
  __shared__ T ends[kMaxWarps];
  __shared__ T entry;   // the state before the tile
  __shared__ RowPowers<T> p;
  const int k = threadIdx.x, nt = blockDim.x, tile = kRun * nt;
  const long long row = blockIdx.x;
  const T az = a[row % z];
  const T* src = b + row * f;
  T* dst = y + row * f;
  if (k == 0) {
    p = row_powers(az);
    entry = y0 != nullptr ? y0[row] : T(0);
  }
  T next[kRun];
  load_tile(next, src, tile_frames(f, 0, tile));
  for (long long t0 = 0; t0 < f; t0 += tile) {
    const int m = tile_frames(f, t0, tile);
    if (t0 > 0) __syncthreads();  // the last tile's stores have read sh
#pragma unroll
    for (int j = 0; j < kRun; ++j) sh[slot<T>(k + j * nt)] = next[j];
    __syncthreads();
    if (t0 + tile < f) {
      load_tile(next, src + t0 + tile, tile_frames(f, t0 + tile, tile));
    }
    T v[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = sh[slot<T>(k * kRun + j)];
    // every read of the tile lies before run_entry's barriers
    T yt = run_entry(run_end(az, v), &entry, p, ends);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      sh[slot<T>(k * kRun + j)] = yt = az * yt + v[j];
    }
    if (k == nt - 1) entry = yt;  // the tile's exit
    __syncthreads();
    store_tile(dst + t0, sh, m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
fused_mod_smoothers_kernel(const T* __restrict__ a, const T* __restrict__ exc,
                           const T* __restrict__ uns, T* __restrict__ exc_filt,
                           T* __restrict__ mod, T* __restrict__ loud_filt,
                           int z, long long f, T scale) {
  __shared__ T sh_e[kRowSlots<T>];   // exc, then exc_filt, then mod
  __shared__ T sh_l[kRowSlots<T>];   // loud, then loud_filt
  __shared__ Tri<T> ends[kMaxWarps];
  __shared__ Tri<T> entry;           // the states before the tile
  __shared__ T last_loud;            // loud at the frame before the tile
  __shared__ RowPowers<T> p;
  const int k = threadIdx.x, nt = blockDim.x, tile = kRun * nt;
  const long long row = blockIdx.x;
  const T az = a[row % z];
  const T oma = T(1) - az;
  const T* exc_row = exc + row * f;
  const T* uns_row = uns + row * f;
  if (k == 0) {
    p = row_powers(az);
    entry = Tri<T>{T(0), T(0), T(0)};
    last_loud = T(0);
  }
  // the drives: (1 - a) exc at tile frame i, (1 - a) deriv from loud_t and
  // loud_{t-1}, and (1 - a) loud_t
  auto drive_e = [&](int i) { return oma * sh_e[slot<T>(i)]; };
  auto drive_d = [&](T loud, T prev) {
    return oma * (scale * abs_t(loud - prev));
  };
  // only uns waits in registers for the next tile through the scan: with
  // exc beside it the double kernel spills under its 96-register cap (two
  // blocks an SM)
  T next_u[kRun];
  load_tile(next_u, uns_row, tile_frames(f, 0, tile));
  for (long long t0 = 0; t0 < f; t0 += tile) {
    const int m = tile_frames(f, t0, tile);
    // exc's loads go out together and are staged before the pows: a pow's
    // branches would hold back a load behind it, and exc held in registers
    // through the pows spills in double
    T e[kRun];
    load_tile(e, exc_row + t0, m);
    if (t0 > 0) __syncthreads();  // the last tile's stores are done
#pragma unroll
    for (int j = 0; j < kRun; ++j) sh_e[slot<T>(k + j * nt)] = e[j];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int i = k + j * nt;
      sh_l[slot<T>(i)] = i < m ? pow_t(next_u[j], T(0.3)) : T(0);
    }
    __syncthreads();
    if (t0 + tile < f) {
      const int m_next = tile_frames(f, t0 + tile, tile);
      load_tile(next_u, uns_row + t0 + tile, m_next);
    }
    // loud_{t-1} of the run's first frame: the frame before it, or the
    // previous tile's last (0 before the row's first frame)
    const T prev0 = k == 0 ? last_loud : sh_l[slot<T>(k * kRun - 1)];
    T prev = prev0;
    Tri<T> end{T(0), T(0), T(0)};
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int i = k * kRun + j;
      const T loud = sh_l[slot<T>(i)];
      end = rec(az, end, Tri<T>{drive_e(i), drive_d(loud, prev), oma * loud});
      prev = loud;
    }
    // every read of another thread's slots, and of last_loud, lies before
    // run_entry's barriers; after them each thread rewrites its own slots
    const Tri<T> in = run_entry(end, &entry, p, ends);
    if (k == nt - 1) last_loud = prev;
    T ye = in.e;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int i = k * kRun + j;
      sh_e[slot<T>(i)] = ye = az * ye + drive_e(i);
    }
    __syncthreads();
    store_tile(exc_filt + row * f + t0, sh_e, m);
    __syncthreads();
    T yd = in.d, yl = in.l;
    prev = prev0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int i = k * kRun + j;
      const T loud = sh_l[slot<T>(i)];
      yd = az * yd + drive_d(loud, prev);
      sh_l[slot<T>(i)] = yl = az * yl + oma * loud;
      sh_e[slot<T>(i)] = yd / (T(1) + yl / T(0.3));
      prev = loud;
    }
    if (k == nt - 1) entry = Tri<T>{ye, yd, yl};  // the tile's exit
    __syncthreads();
    store_tile(mod + row * f + t0, sh_e, m);
    store_tile(loud_filt + row * f + t0, sh_l, m);
  }
}

template <typename T>
int launch_recurrence(const void* a, const void* b, const void* y0, void* y,
                      long long rows, int z, long long f, void* stream) {
  if (rows > kGridLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && f > 0) {
    recurrence_banded_kernel<T>
        <<<static_cast<unsigned>(rows), block_threads(f), 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<const T*>(y0), static_cast<T*>(y), z, f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused_mod(const void* a, const void* exc, const void* uns,
                     void* exc_filt, void* mod, void* loud_filt,
                     long long rows, int z, long long f, double scale,
                     void* stream) {
  if (rows > kGridLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && f > 0) {
    fused_mod_smoothers_kernel<T>
        <<<static_cast<unsigned>(rows), block_threads(f), 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(a), static_cast<const T*>(exc),
            static_cast<const T*>(uns), static_cast<T*>(exc_filt),
            static_cast<T*>(mod), static_cast<T*>(loud_filt), z, f,
            static_cast<T>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches once on `stream` (one block per row) and returns
// cudaGetLastError() (0 = ok).
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
