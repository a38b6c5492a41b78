// The warp-wide scan of a first-order recurrence x_l <- a x_{l-1} + x_l over
// the 32 lanes of a warp, shared by the tile scans of the banded
// recurrences, the FB slope filter and the DC cascade (tile_scan.cuh) and,
// run from lane 31 down, the FFT ear's lower spreading (spread_fft.cu).
// Each lane holds the drive of one stretch (a run of samples or a group of
// bands); the scan's step factors are a^(2^e) of the factor over one
// stretch, computed in double by the caller, real or complex.

#pragma once

#include <cuda_runtime.h>

namespace peaq {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// A complex value in the working type (the DC cascade's conjugate pole).
template <typename T>
struct Cplx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ T mul(T a, T b) { return a * b; }
template <typename T>
__device__ __forceinline__ T add(T a, T b) { return a + b; }
template <typename T>
__device__ __forceinline__ Cplx<T> mul(Cplx<T> a, Cplx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename T>
__device__ __forceinline__ Cplx<T> add(Cplx<T> a, Cplx<T> b) {
  return {a.re + b.re, a.im + b.im};
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int off) {
  return __shfl_up_sync(kFull, v, off);
}
template <typename T>
__device__ __forceinline__ Cplx<T> shfl_up(Cplx<T> v, int off) {
  return {__shfl_up_sync(kFull, v.re, off), __shfl_up_sync(kFull, v.im, off)};
}
template <typename T>
__device__ __forceinline__ T shfl_down(T v, int off) {
  return __shfl_down_sync(kFull, v, off);
}

// Inclusive scan of x_l <- f x_{l-1} + x_l over the 32 lanes of a warp,
// step[e] = f^(2^e); V is a real working type or a Cplx of one, or a tuple
// of states that share a real factor F (mul(F, V) and add(V, V) defined).
template <typename V, typename F>
__device__ __forceinline__ V warp_scan(V x, const F (&step)[5], int lane) {
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    const int off = 1 << e;
    const V up = shfl_up(x, off);
    if (lane >= off) x = add(x, mul(step[e], up));
  }
  return x;
}

// The same scan run backward, x_l <- f x_{l+1} + x_l from lane 31 down to
// lane 0, step[e] = f^(2^e).
template <typename T>
__device__ __forceinline__ T warp_scan_down(T x, const T (&step)[5],
                                            int lane) {
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    const int off = 1 << e;
    const T down = shfl_down(x, off);
    if (lane + off < kWarp) x = x + step[e] * down;
  }
  return x;
}

}  // namespace peaq
