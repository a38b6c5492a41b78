// The filter-bank ear model's DC-rejection cascade, for Hopper (sm_90a).
// BS.1387 / src/fbearmodel.c:291-303.
//
// D3  dc_chain  replaces gstpeaq_tpu/ops/pallas_dc.py::dc_chain_blocked
//     (K7, its pallas_call at :237).  Per signal row of T samples, with
//     xs = level_factor * x:
//       v1 = xs - 2 xs_{t-1} + xs_{t-2}              (ff1)
//       w  = rec(lp, v1),  y1 = rec(lm, w)          (HP1: real poles lp, lm)
//       v2 = y1 - 2 y1_{t-1} + y1_{t-2}              (ff2)
//       u  = rec(lam, v2), y2 = 2 Re(g u)           (HP2: complex pair lam)
//     with rec(a, v)_t = a rec_{t-1} + v_t.  The ff1 -> poles1 -> ff2 ->
//     poles2 interleaving, the cascade of the near-degenerate real pair and
//     the single conjugate-pair recurrence are the well-conditioned forms of
//     gstpeaq_tpu/ops/fb_ear.py::dc_reject: the poles sit at r ~ 0.9988 with
//     ~833x DC gain each, and a partial-fraction or collapsed form amplifies
//     the rounding by hundreds.  Each pole stays its own first-order scan.
//     The state is dc_reject's tuple, packed per row as [x_{T-2}, x_{T-1},
//     w_{T-1}, y1_{T-1}, y1_{T-2}, y1_{T-1}, Re u_{T-1}, Im u_{T-1}] in the
//     scaled domain.
//
// What bounds it: the arithmetic is ~20 flops a sample, so the bytes and
// the serial dependency of each recurrence.  One block per row would put
// 4 of the card's 132 SMs to work at the main shape, and a contiguous
// chunk per thread makes every warp access touch 32 strided sectors (3.9
// ms at [4, 480000]).  A call at [4, 480000] moves ~7 passes over one row
// array (x read three times, y1 written once and read twice, hp2 written)
// through five launches: on an H100 (80GB HBM3, 700 W) 0.050 ms in double
// and 0.037 ms in float, 2.1 and 1.5 TB/s of that traffic (64% and 43% of
// the 3.35 TB/s peak), each launch 5-13 us; the two that write an array
// take the longest.  So the bytes bound it in double, and in float the
// latency of each launch's wave of short blocks as much.  Design: each row
// is cut into tiles of kTile = 2048 samples, one block of 256 threads each
// (940 blocks at the main shape), and each call makes five launches:
//   0  the lp aggregates of ff1(x)
//   1  w from its entry, then the lm aggregates of w
//   2  w and y1 from their entries, writing y1
//   3  the lam aggregates of ff2(y1)
//   4  u from its entry, writing hp2 and the final state
// where a tile's aggregate is its end state from a zero entry.  The tile
// scan is tile_scan.cuh's, which D1 (fb_spread.cu) shares.  Inside a
// block the tile is loaded coalesced into shared memory, skewed by one
// element per 128 bytes so that a thread's run of 8 samples reads without
// bank conflicts; each thread scans its run serially in registers, a warp
// scan (factor a^8) and a fold of the 8 warp ends (a^256) give each run its
// entry, and the run is scanned again from it; stores go back through
// shared memory, coalesced.  Between tiles, one warp of each block folds the
// carried state and its row's earlier aggregates with a^2048 in one fixed
// order: no atomics and no look-back, so every run gives the same bits.
// Every factor a^n is computed in double on the host (ops/cuda_dc.py::
// scan_factors) and cast to the working type.
//
// Templated on float and double; no fast-math intrinsic is used.

#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace {

using peaq::Cplx;
using peaq::fill;
using peaq::kRun;
using peaq::kSlots;
using peaq::kThreads;
using peaq::kTile;
using peaq::kWarp;
using peaq::kWarps;
using peaq::plan_fits;
using peaq::Powers;
using peaq::rec;
using peaq::run_end;
using peaq::run_entry;
using peaq::slot;
using peaq::tile_end;
using peaq::tile_entry;

enum Step : int { kAggLp, kAggLm, kY1, kAggLam, kOut };

template <typename T>
struct DcCoef {
  Powers<T> lp, lm;
  Powers<Cplx<T>> lam;
  Cplx<T> g;
};

template <typename T, int kStep>
__global__ void __launch_bounds__(kThreads)
dc_chain_kernel(const T* __restrict__ x, T lf, const T* __restrict__ st_in,
                T* __restrict__ out, T* __restrict__ y1,
                T* __restrict__ agg, T* __restrict__ st_out, long long t_len,
                long long tiles, long long seg, DcCoef<T> co) {
  using C = Cplx<T>;
  __shared__ T sh[kSlots<T>];
  __shared__ T halo[2];        // the two samples before the tile
  __shared__ T ends_r[kWarps];
  __shared__ C ends_c[kWarps];
  __shared__ T entry_r[2];     // the tile's entry states of lp and lm
  __shared__ C entry_c;        // and of lam
  const int k = threadIdx.x, lane = k % kWarp, warp = k / kWarp;
  const long long plane = gridDim.x;  // rows * tiles
  const long long row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long t0 = tile * kTile;
  const int n = t_len - t0 < kTile ? static_cast<int>(t_len - t0) : kTile;
  const bool last = tile == tiles - 1;
  auto st = [&](int i) {
    return st_in != nullptr ? st_in[row * 8 + i] : T(0);
  };
  T* agg_lp = agg + row * tiles;
  T* agg_lm = agg + plane + row * tiles;
  C* agg_lam = reinterpret_cast<C*>(agg + 2 * plane) + row * tiles;
  T* sto = st_out + row * 8;

  // ---- the tile, coalesced: lf x (steps 0-2) or y1 (steps 3-4) ----
  constexpr bool kFromX = kStep < kAggLam;
  const T* src = (kFromX ? x : y1) + row * t_len;
  auto load = [&](long long t) { return kFromX ? lf * src[t] : src[t]; };
  for (int i = k; i < kTile; i += kThreads) {
    sh[slot<T>(i)] = i < n ? load(t0 + i) : T(0);
  }
  if (k < 2) {
    const long long t = t0 + k - 2;
    // before the row: the carried tail, x at [0, 1], y1 at [4, 5]
    halo[k] = t >= 0 ? load(t) : st(static_cast<int>(t) + (kFromX ? 2 : 6));
  }
  __syncthreads();
  auto at = [&](int i) { return i >= 0 ? sh[slot<T>(i)] : halo[i + 2]; };

  // ---- the feedforward (1 - z^-1)^2 over this thread's run ----
  const int base = k * kRun;
  // this thread's run holds the row's last sample at j_last
  const int j_last = last ? n - 1 - base : -1;
  T v[kRun];
  {
    T m2 = at(base - 2), m1 = at(base - 1);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const T c = sh[slot<T>(base + j)];
      v[j] = c - T(2) * m1 + m2;
      m2 = m1;
      m1 = c;
    }
  }

  if constexpr (kStep == kAggLp) {
    const T a = tile_end(run_end(co.lp.a, v), co.lp, ends_r);
    if (k == 0) agg_lp[tile] = a;
  } else if constexpr (kStep == kAggLm || kStep == kY1) {
    if (warp == 0) {
      const T c = tile_entry<T>(agg_lp, tile, seg, st(2), co.lp);
      if (lane == kWarp - 1) entry_r[0] = c;
    } else if (kStep == kY1 && warp == 1) {
      const T c = tile_entry<T>(agg_lm, tile, seg, st(3), co.lm);
      if (lane == kWarp - 1) entry_r[1] = c;
    }
    T w[kRun];
    T y = run_entry(run_end(co.lp.a, v), &entry_r[0], co.lp, ends_r);
#pragma unroll
    for (int j = 0; j < kRun; ++j) w[j] = y = co.lp.a * y + v[j];
    const T end = run_end(co.lm.a, w);
    if constexpr (kStep == kAggLm) {
      const T a = tile_end(end, co.lm, ends_r);
      if (k == 0) agg_lm[tile] = a;
    } else {
      // every read of the tile's x lies before run_entry's barriers
      y = run_entry(end, &entry_r[1], co.lm, ends_r);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        sh[slot<T>(base + j)] = y = co.lm.a * y + w[j];
        if (j == j_last) sto[2] = w[j];
      }
      __syncthreads();
      T* dst = y1 + row * t_len + t0;
      for (int i = k; i < n; i += kThreads) dst[i] = sh[slot<T>(i)];
    }
  } else {
    if constexpr (kStep == kOut) {
      if (warp == 0) {
        const C c = tile_entry<C>(agg_lam, tile, seg, C{st(6), st(7)},
                                  co.lam);
        if (lane == kWarp - 1) entry_c = c;
      }
    }
    const C end = run_end(co.lam.a, v);
    if constexpr (kStep == kAggLam) {
      const C a = tile_end(end, co.lam, ends_c);
      if (k == 0) agg_lam[tile] = a;
    } else {
      if (last && k == 0) {
        // the tails, y1 from the tile before run_entry's barriers
        sto[3] = sto[5] = at(n - 1);
        sto[4] = at(n - 2);
        const T* xr = x + row * t_len;
        sto[0] = t_len >= 2 ? lf * xr[t_len - 2] : st(1);
        sto[1] = lf * xr[t_len - 1];
      }
      C u = run_entry(end, &entry_c, co.lam, ends_c);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        u = rec(co.lam.a, u, v[j]);
        sh[slot<T>(base + j)] = T(2) * (co.g.re * u.re - co.g.im * u.im);
        if (j == j_last) {
          sto[6] = u.re;
          sto[7] = u.im;
        }
      }
      __syncthreads();
      T* dst = out + row * t_len + t0;
      for (int i = k; i < n; i += kThreads) dst[i] = sh[slot<T>(i)];
    }
  }
}

template <typename T>
int launch_dc(const void* x, double lf, const void* st_in, void* out,
              void* y1, void* agg, void* st_out, long long rows,
              long long t_len, long long tiles, long long seg,
              const double* coef, void* stream) {
  if (rows <= 0 || t_len <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits(rows, t_len, tiles, seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DcCoef<T> co;
  const double* c = fill(co.lp, coef);
  c = fill(co.lm, c);
  c = fill(co.lam, c);
  co.g = {static_cast<T>(c[0]), static_cast<T>(c[1])};
  const auto blocks = static_cast<unsigned>(rows * tiles);
  using Kernel = void (*)(const T*, T, const T*, T*, T*, T*, T*, long long,
                          long long, long long, DcCoef<T>);
  const Kernel steps[] = {
      dc_chain_kernel<T, kAggLp>, dc_chain_kernel<T, kAggLm>,
      dc_chain_kernel<T, kY1>, dc_chain_kernel<T, kAggLam>,
      dc_chain_kernel<T, kOut>};
  for (const Kernel kernel : steps) {
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T>(lf),
        static_cast<const T*>(st_in), static_cast<T*>(out),
        static_cast<T*>(y1), static_cast<T*>(agg), static_cast<T*>(st_out),
        t_len, tiles, seg, co);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Each entry makes five launches on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 = ok).  x, out, y1 (scratch):
// [rows, t_len]; agg (scratch): [4, rows, tiles]; st_in (nullable = zero
// state), st_out: [rows, 8]; tiles and seg from ops/tile_scan.py::
// launch_plan; coef: the host's float64 factors, ops/cuda_dc.py::
// scan_factors(seg).
int peaq_dc_chain_f32(const void* x, double lf, const void* st_in, void* out,
                      void* y1, void* agg, void* st_out, long long rows,
                      long long t_len, long long tiles, long long seg,
                      const double* coef, void* stream) {
  return launch_dc<float>(x, lf, st_in, out, y1, agg, st_out, rows, t_len,
                          tiles, seg, coef, stream);
}

int peaq_dc_chain_f64(const void* x, double lf, const void* st_in, void* out,
                      void* y1, void* agg, void* st_out, long long rows,
                      long long t_len, long long tiles, long long seg,
                      const double* coef, void* stream) {
  return launch_dc<double>(x, lf, st_in, out, y1, agg, st_out, rows, t_len,
                           tiles, seg, coef, stream);
}

}  // extern "C"
