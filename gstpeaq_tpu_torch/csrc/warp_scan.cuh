// The warp-wide scan of a first-order recurrence x_l <- a x_{l-1} + x_l over
// the 32 lanes of a warp, shared by the banded recurrences (recurrence.cu)
// and the FB slope filter (fb_spread.cu).  Each lane holds one instant of a
// 32-instant chunk; the step factors a^(2^e) are built by repeated squaring
// in the working type, and a^(lane + 1) weighs the state entering the chunk.

#pragma once

#include <cuda_runtime.h>

namespace peaq {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Powers of one row's coefficient, per lane.
template <typename T>
struct LanePowers {
  T carry;       // a^(lane + 1): weight of the state entering the chunk
  T step[5];     // a^(2^e), e = 0..4: the scan's step factors
};

template <typename T>
__device__ __forceinline__ LanePowers<T> lane_powers(T a, int lane) {
  LanePowers<T> p;
  T s = a;
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    p.step[e] = s;
    s = s * s;
  }
  T acc = a;
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    const int off = 1 << e;
    const T up = __shfl_up_sync(kFull, acc, off);
    if (lane >= off) acc = acc * up;
  }
  p.carry = acc;
  return p;
}

// Inclusive scan of x_l <- a x_{l-1} + x_l over the 32 lanes of a warp.
template <typename T>
__device__ __forceinline__ T warp_scan(T x, const LanePowers<T>& p, int lane) {
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    const int off = 1 << e;
    const T up = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = x + p.step[e] * up;
  }
  return x;
}

}  // namespace peaq
