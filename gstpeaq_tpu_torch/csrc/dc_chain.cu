// The filter-bank ear model's DC-rejection cascade, for Hopper (sm_90a).
// BS.1387 / src/fbearmodel.c:291-303.
//
// D3  dc_chain  replaces gstpeaq_tpu/ops/pallas_dc.py::dc_chain_blocked
//     (K7).  Per signal row of T samples, with xs = level_factor * x:
//       v1 = xs - 2 xs_{t-1} + xs_{t-2}              (ff1)
//       w  = rec(lp, v1),  y1 = rec(lm, w)          (HP1: real poles lp, lm)
//       v2 = y1 - 2 y1_{t-1} + y1_{t-2}              (ff2)
//       u  = rec(lam, v2), y2 = 2 Re(g u)           (HP2: complex pair lam)
//     with rec(a, v)_t = a rec_{t-1} + v_t.  The ff1 -> poles1 -> ff2 ->
//     poles2 interleaving, the cascade of the near-degenerate real pair and
//     the single conjugate-pair recurrence are the well-conditioned forms of
//     gstpeaq_tpu/ops/fb_ear.py::dc_reject: the poles sit at r ~ 0.9988 with
//     ~833x DC gain each, and a partial-fraction or collapsed form amplifies
//     the rounding by hundreds.  The state is dc_reject's tuple, packed per
//     row as [x_{T-2}, x_{T-1}, w_{T-1}, y1_{T-1}, y1_{T-2}, y1_{T-1},
//     Re u_{T-1}, Im u_{T-1}] in the scaled domain.
//
// What bounds it: the serial dependency of each recurrence over 480,000
// samples per row, and with only 4 rows (ref and test, two channels) only
// 4 blocks, so 4 of the card's 132 SMs, work.  Second, the access pattern:
// each thread walks its own contiguous chunk, so one warp-wide load or
// store in the six serial passes touches 32 addresses L samples apart
// (L = 469 at 480,000 samples), about 32 sectors per request where a
// coalesced access takes 4 (float) or 8 (double); only L1 hits on the
// neighbouring samples of a sector can hide that.  Staging each warp's
// chunks through shared memory with coalesced loads and stores, or a
// lane-interleaved chunk layout, is left to a later change, as is
// splitting a row across blocks.  Design: one block of 1024
// threads per row; each thread owns a contiguous chunk of L = ceil(T /
// 1024) samples, and each first-order stage is a chunked scan:
//   1. a serial pass over the chunk from a zero state;
//   2. a block-wide Hillis-Steele scan (shared memory, 10 steps) of the
//      chunk end states with the factor lam^L, seeded with the carried
//      state, giving each chunk its entry state;
//   3. a fix-up pass adding entry * lam^(j+1), with the power walked by one
//      multiplication per sample as a serial recurrence would.
// The feedforwards read their two previous samples across chunk edges and
// from the carried state.  The stages run in place in the output row and one
// scratch row (the imaginary part of u), both allocated by the wrapper; the
// scan factors lam^(L 2^e) are computed on the host in double.
//
// Templated on float and double; no fast-math intrinsic is used.

#include <cuda_runtime.h>

#include <cmath>
#include <complex>

namespace {

constexpr int kThreads = 1024;
constexpr int kScanSteps = 10;  // 2^10 = kThreads

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
struct DcCoef {
  T lp, lm;                   // HP1's real poles
  Cplx<T> lam;                // HP2's pole (upper half plane)
  Cplx<T> g;                  // y2 = 2 Re(g u)
  T fp[kScanSteps];           // lp^(L 2^e)
  T fm[kScanSteps];           // lm^(L 2^e)
  Cplx<T> f2[kScanSteps];     // lam^(L 2^e)
};

// Entry state of this thread's chunk: the exclusive scan of the chunk end
// states `end` with factor f = lam^L, seeded with y0 (the carried state).
template <typename V>
__device__ V chunk_entry(V end, V y0, const V* factors, V* sh) {
  const int k = threadIdx.x;
  sh[k] = end;
  __syncthreads();
  V h = k == 0 ? y0 : sh[k - 1];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kScanSteps; ++e) {
    const int off = 1 << e;
    sh[k] = h;
    __syncthreads();
    if (k >= off) h = add(h, mul(factors[e], sh[k - off]));
    __syncthreads();
  }
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dc_chain_kernel(const T* __restrict__ x, T lf, const T* __restrict__ st_in,
                T* __restrict__ out, T* __restrict__ scratch,
                T* __restrict__ st_out, long long t_len, long long chunk,
                DcCoef<T> co) {
  __shared__ T sh_r[kThreads];
  __shared__ Cplx<T> sh_c[kThreads];
  __shared__ T captured[4];   // w_{T-1}, y1_{T-1}, y1_{T-2}, y1_{T-1}
  const long long row = blockIdx.x;
  const T* xr = x + row * t_len;
  T* yr = out + row * t_len;
  T* sr = scratch + row * t_len;
  T st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = st_in != nullptr ? st_in[row * 8 + i] : T(0);
  const long long t0 = threadIdx.x * chunk;
  const long long t1 = t0 + chunk < t_len ? t0 + chunk : t_len;
  // scaled input at i, the carried tail (x_{-2}, x_{-1}) before the row
  auto xs_at = [&](long long i) { return i >= 0 ? lf * xr[i] : st[i + 2]; };

  // ---- ff1 and w = rec(lp, v1) ----
  // a thread whose chunk lies past the row's end reads nothing
  const bool busy = t0 < t_len;
  T xm1 = busy ? xs_at(t0 - 1) : T(0);
  T xm2 = busy ? xs_at(t0 - 2) : T(0);
  T acc = T(0);
  for (long long t = t0; t < t1; ++t) {
    const T xs = lf * xr[t];
    acc = co.lp * acc + (xs - T(2) * xm1 + xm2);
    yr[t] = acc;
    xm2 = xm1;
    xm1 = xs;
  }
  T c = chunk_entry<T>(acc, st[2], co.fp, sh_r);
  for (long long t = t0; t < t1; ++t) {
    c = co.lp * c;
    yr[t] += c;
  }
  __syncthreads();
  if (threadIdx.x == 0) captured[0] = yr[t_len - 1];
  __syncthreads();

  // ---- y1 = rec(lm, w), in place ----
  acc = T(0);
  for (long long t = t0; t < t1; ++t) {
    acc = co.lm * acc + yr[t];
    yr[t] = acc;
  }
  c = chunk_entry<T>(acc, st[3], co.fm, sh_r);
  for (long long t = t0; t < t1; ++t) {
    c = co.lm * c;
    yr[t] += c;
  }
  __syncthreads();
  // y1 at i, the carried tail (y1_{-2}, y1_{-1}) before the row
  auto y1_at = [&](long long i) { return i >= 0 ? yr[i] : st[i + 6]; };
  if (threadIdx.x == 0) {
    captured[1] = yr[t_len - 1];
    captured[2] = y1_at(t_len - 2);
    captured[3] = yr[t_len - 1];
  }
  T ym1 = busy ? y1_at(t0 - 1) : T(0);
  T ym2 = busy ? y1_at(t0 - 2) : T(0);
  __syncthreads();

  // ---- ff2 and u = rec(lam, v2): Re u in place, Im u in scratch ----
  Cplx<T> u = {T(0), T(0)};
  for (long long t = t0; t < t1; ++t) {
    const T y1 = yr[t];
    u = add(mul(co.lam, u), Cplx<T>{y1 - T(2) * ym1 + ym2, T(0)});
    yr[t] = u.re;
    sr[t] = u.im;
    ym2 = ym1;
    ym1 = y1;
  }
  Cplx<T> cc = chunk_entry<Cplx<T>>(u, Cplx<T>{st[6], st[7]}, co.f2, sh_c);
  for (long long t = t0; t < t1; ++t) {
    cc = mul(co.lam, cc);
    const T ur = yr[t] + cc.re;
    const T ui = sr[t] + cc.im;
    yr[t] = T(2) * (co.g.re * ur - co.g.im * ui);
    if (t == t_len - 1) {
      st_out[row * 8 + 6] = ur;
      st_out[row * 8 + 7] = ui;
    }
  }
  if (threadIdx.x == 0) {
    st_out[row * 8 + 0] = xs_at(t_len - 2);
    st_out[row * 8 + 1] = xs_at(t_len - 1);
    st_out[row * 8 + 2] = captured[0];
    st_out[row * 8 + 3] = captured[1];
    st_out[row * 8 + 4] = captured[2];
    st_out[row * 8 + 5] = captured[3];
  }
}

template <typename T>
int launch_dc(const void* x, double lf, const void* st_in, void* out,
              void* scratch, void* st_out, long long rows, long long t_len,
              double lp, double lm, double lam_re, double lam_im, double g_re,
              double g_im, void* stream) {
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && t_len > 0) {
    const long long chunk = (t_len + kThreads - 1) / kThreads;
    DcCoef<T> co;
    co.lp = static_cast<T>(lp);
    co.lm = static_cast<T>(lm);
    co.lam = {static_cast<T>(lam_re), static_cast<T>(lam_im)};
    co.g = {static_cast<T>(g_re), static_cast<T>(g_im)};
    const std::complex<double> lam(lam_re, lam_im);
    for (int e = 0; e < kScanSteps; ++e) {
      const double n = static_cast<double>(chunk) * static_cast<double>(1 << e);
      co.fp[e] = static_cast<T>(std::pow(lp, n));
      co.fm[e] = static_cast<T>(std::pow(lm, n));
      const std::complex<double> f =
          std::polar(std::pow(std::abs(lam), n), std::arg(lam) * n);
      co.f2[e] = {static_cast<T>(f.real()), static_cast<T>(f.imag())};
    }
    dc_chain_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T>(lf),
        static_cast<const T*>(st_in), static_cast<T*>(out),
        static_cast<T*>(scratch), static_cast<T*>(st_out), t_len, chunk, co);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// x, out, scratch: [rows, t_len]; st_in (nullable = zero state), st_out:
// [rows, 8]; the poles and the output gain come from the caller.
int peaq_dc_chain_f32(const void* x, double lf, const void* st_in, void* out,
                      void* scratch, void* st_out, long long rows,
                      long long t_len, double lp, double lm, double lam_re,
                      double lam_im, double g_re, double g_im, void* stream) {
  return launch_dc<float>(x, lf, st_in, out, scratch, st_out, rows, t_len, lp,
                          lm, lam_re, lam_im, g_re, g_im, stream);
}

int peaq_dc_chain_f64(const void* x, double lf, const void* st_in, void* out,
                      void* scratch, void* st_out, long long rows,
                      long long t_len, double lp, double lm, double lam_re,
                      double lam_im, double g_re, double g_im, void* stream) {
  return launch_dc<double>(x, lf, st_in, out, scratch, st_out, rows, t_len,
                           lp, lm, lam_re, lam_im, g_re, g_im, stream);
}

}  // extern "C"
