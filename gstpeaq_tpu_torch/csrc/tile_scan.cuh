// A first-order recurrence y_t = a y_{t-1} + v_t along rows that are cut
// into tiles, one block of kThreads threads per tile, shared by the DC
// cascade (dc_chain.cu, D3) and the FB slope filter (fb_spread.cu, D1).
// ops/tile_scan.py holds the host's side: the launch plan and every power
// a^n, computed in float64.  The banded recurrences (recurrence.cu, K1 and
// K2) take the same runs, slots and run_entry with one block of up to ten
// warps per row, walking the row's tiles in the block.
//
// Inside a block, thread k owns the run of kRun samples [k kRun, (k + 1)
// kRun) of the tile, staged coalesced through shared memory (slot() skews
// it by one element per 128 bytes, so that the lanes reading sample j of
// their runs hit distinct banks).  A thread scans its run serially in
// registers; a warp scan (factor a^kRun) and a fold of the kWarps warp ends
// (a^(kRun kWarp)) give the tile's zero-entry end (tile_end) or each run's
// entry state (run_entry).  Between tiles, one warp of each block folds the
// carried state and its row's earlier tile ends with a^kTile in one fixed
// order (tile_entry): no atomics and no look-back, so every run gives the
// same bits.
//
// Everything here has internal linkage (an unnamed namespace), so each
// source compiles it as its own, as if it were written there.

#pragma once

#include <cuda_runtime.h>

#include "warp_scan.cuh"

namespace peaq {
namespace {

constexpr int kRun = 8;                   // samples a thread scans serially
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTile = kRun * kThreads;    // samples a block
constexpr long long kGridLimit = 2147483647LL;

// One pole and its powers a^n, in the order ops/tile_scan.py::
// scan_exponents lays them out.
template <typename V>
struct Powers {
  V a;
  V run[5];     // a^(kRun 2^e): the warp scan's step factors over runs
  V warp;       // a^(kRun kWarp): one warp's stretch
  V tile;       // a^kTile: one tile
  V carry[5];   // a^(kTile seg 2^e): the carry scan's step factors
};

// Shared-memory slot of tile sample i: one element of skew per 128 bytes,
// so the lanes reading sample j of their runs (kRun apart) hit distinct
// banks (float), or distinct bank pairs per half-warp (double).
template <typename T>
constexpr int kSkew = 128 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kSlots = kTile + kTile / kSkew<T>;
template <typename T>
__device__ __forceinline__ int slot(int i) { return i + i / kSkew<T>; }

// One step y <- a y + v of a real or complex stage with a real drive v.
template <typename T>
__device__ __forceinline__ T rec(T a, T y, T v) { return a * y + v; }
template <typename T>
__device__ __forceinline__ Cplx<T> rec(Cplx<T> a, Cplx<T> y, T v) {
  return add(mul(a, y), Cplx<T>{v, T(0)});
}

// The stage's end over a run from a zero entry.
template <typename V, typename T>
__device__ __forceinline__ V run_end(V a, const T (&v)[kRun]) {
  V y{};
#pragma unroll
  for (int j = 0; j < kRun; ++j) y = rec(a, y, v[j]);
  return y;
}

// The tile's end from a zero entry (its aggregate), valid in thread 0: the
// runs' zero-entry ends scanned per warp, the warp ends folded in order.
template <typename V>
__device__ V tile_end(V end, const Powers<V>& p, V* ends) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const V s = warp_scan(end, p.run, lane);
  if (lane == kWarp - 1) ends[warp] = s;
  __syncthreads();
  V agg{};
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) agg = add(mul(p.warp, agg), ends[w]);
  }
  return agg;
}

// The entry state of this thread's run (the stage at the sample before
// it), from the run's zero-entry end and the tile's entry *tile_in, which
// the caller writes to shared memory before the call.  p holds run[5] and
// warp as Powers does (a Powers<V>, or one real factor for a tuple of
// states V); every warp of the block calls it, and ends has one slot a warp.
template <typename V, typename P>
__device__ V run_entry(V end, const V* tile_in, const P& p, V* ends) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const V s = warp_scan(end, p.run, lane);
  if (lane == kWarp - 1) ends[warp] = s;
  __syncthreads();
  V x = *tile_in;   // becomes the warp's entry
  for (int w = 0; w < warp; ++w) x = add(mul(p.warp, x), ends[w]);
  // the scan again with the warp's entry folded into lane 0: lane l then
  // ends where lane l + 1 enters
  const V s_in = warp_scan(lane == 0 ? add(end, mul(p.run[0], x)) : end,
                           p.run, lane);
  const V up = shfl_up(s_in, 1);
  __syncthreads();  // ends and *tile_in are written again after the call
  return lane == 0 ? x : up;
}

// The entry state of tile j, by one warp, valid in lane 31: the carried
// state c0 (as tile -1) and the row's aggregates agg[0..j) folded with
// a^kTile in one fixed order.  Lane l folds the tiles [j - (32 - l) seg,
// j - (31 - l) seg) by Horner; a warp scan with (a^(kTile seg))^(2^e)
// folds the lanes.
template <typename V>
__device__ V tile_entry(const V* agg, long long j, long long seg, V c0,
                        const Powers<V>& p) {
  const int lane = threadIdx.x % kWarp;
  const long long hi = j - (kWarp - 1 - lane) * seg;
  V h{};
  for (long long i = hi - seg < -1 ? -1 : hi - seg; i < hi; ++i) {
    h = add(mul(p.tile, h), i < 0 ? c0 : agg[i]);
  }
  return warp_scan(h, p.carry, lane);
}

// Whether the host's plan fits the kernels: `tiles` tiles of kTile cover a
// row of t_len, kWarp segments of `seg` tiles reach back to tile 0, and
// rows * tiles blocks fit one grid.
inline bool plan_fits(long long rows, long long t_len, long long tiles,
                      long long seg) {
  return tiles == (t_len + kTile - 1) / kTile && seg >= 1 &&
         kWarp * seg >= tiles && rows <= kGridLimit / tiles;
}

// Reads one pole and its powers from the host's float64 factors.
template <typename T>
const double* fill(Powers<T>& p, const double* c) {
  p.a = static_cast<T>(*c++);
  for (T& f : p.run) f = static_cast<T>(*c++);
  p.warp = static_cast<T>(*c++);
  p.tile = static_cast<T>(*c++);
  for (T& f : p.carry) f = static_cast<T>(*c++);
  return c;
}

template <typename T>
const double* fill(Powers<Cplx<T>>& p, const double* c) {
  auto next = [&c] {
    const Cplx<T> z{static_cast<T>(c[0]), static_cast<T>(c[1])};
    c += 2;
    return z;
  };
  p.a = next();
  for (Cplx<T>& f : p.run) f = next();
  p.warp = next();
  p.tile = next();
  for (Cplx<T>& f : p.carry) f = next();
  return c;
}

}  // namespace
}  // namespace peaq
