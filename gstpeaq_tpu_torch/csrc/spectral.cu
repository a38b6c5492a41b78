// The FFT ear's bin-domain stage, for Hopper (sm_90a): S1 pair_frames and
// S2 spectral_movs.  BS.1387 / src/fftearmodel.c:432-515 and the bin-domain
// parts of src/movs.c's bandwidth (:775-809), NMR (:970-1023) and EHS
// (:1345-1443).
//
// Neither replaces a TPU kernel.  The JAX package leaves this stage to XLA,
// which fuses it under jit around the rDFT: gstpeaq_tpu/ops/fft_ear.py:473
// stateless_pair_hop (frames of (ref, ref - test), power and delta-power
// spectra, grouping, the threshold gate's energies) and the bin-domain
// halves of gstpeaq_tpu/models/movs.py:65 bandwidth, :101 nmr and :175 ehs.
// The port ran it as some seventy eager launches, each reading and writing
// a whole [.., F, 1025] tensor.
//
// S1 pair_frames, per frame f of a row (hop blocks b_0 .. b_F of 1024):
//   frames[0] = hann * (b_f | b_{f+1}) of ref
//   frames[1] = hann * (b_f | b_{f+1}) of ref - test, the difference taken
//               in the spectrum type T
//   energy[s] = sum of the squares of b_{f+1} of ref (s = 0) and test (1)
// What bounds it on the H100: bytes, its writes above all (2 x 2048 values
// a frame against 2 x 1024 read).  Design: one block of 256 threads a
// frame (two contiguous hop blocks), 16-byte vectors of T, each step of a
// warp on one contiguous span (a thread's vectors 256 vectors apart); the
// input is converted to T on the fly (float or double either way), so the
// rDFT reads one [2, .., F, 2048] tensor and one batched cuFFT call
// transforms both signals.  Each energy is a fixed-order sum (a thread's
// samples of b_{f+1} in order, a warp butterfly, the eight warps in
// order), so two launches give the same bits.
//
// S2 spectral_movs, per spectrum row (one frame of one channel) from the
// rDFTs R (of ref) and D (of ref - test), T = R - D, S = R + T:
//   pr = level (Rre^2 + Rim^2), pt = level (Tre^2 + Tim^2)
//   dp = level (Dre Sre + Dim Sim)            (= pr - pt, exactly cancelled)
//   band[s][z] = max(sum_k p_s[k] G[k, z], 1e-12)      (s: ref, test)
//   noise[z]   = max(sum_k (dp / (sqrt pr + sqrt pt))^2 G[k, z], 1e-12)
//   zt = max pt[921..1023]; bw_ref = max{i <= 921 : pr[i-1] > 10 zt} or 0;
//   bw_test = max{i <= bw_ref : pt[i-1] >= 5dB zt} or 0; valid = bw_ref > 346
//   d[k < 512] = log1p(-dp/pr) where |dp/pr| <= 1/2, else log(pt/pr) where
//                pt > 0, else -inf; 0 where pr = pt = 0 or ehs_zero[k]
// What bounds it on the H100: bytes.  A row reads 2 x 1025 complex values
// and writes ~2 Z + Z + 512 + 3, so the [.., F, 1025] power, delta-power
// and noise spectra that the eager version wrote and read again are the
// bytes saved.  Design: one block of 256 threads a row; each thread loads
// its bins' R and D (coalesced 8- or 16-byte loads), forms pr, pt, dp,
// writes d and keeps pr, pt and the noise spectrum in shared memory (3 x
// 1025 values, 24.6 KB in double); then one thread a band sums its run of
// the compact group table (first bin, count, weights: G's nonzero runs) in
// bin order, and block max-reductions give zt and the bandwidth indices.
// Every product, sum and quotient that a comparison reads (bandwidth's
// > 10 zt and >= 5dB zt, EHS's |dp/pr| <= 1/2, pr == 0) is rounded op for
// op as the plain version rounds it (__dmul_rn / __dadd_rn, never
// contracted into an fma), so those decisions agree with it bit for bit;
// sqrt, log1p and log are CUDA's IEEE / libdevice functions.
// Templated on float and double; no fast-math intrinsic is used.  Offsets
// are 64-bit.

#include <climits>

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHop = 1024;
constexpr int kFrame = 2 * kHop;
constexpr int kBins = kHop + 1;
constexpr int kEhsBins = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// bandwidth (src/movs.c:775-809): bins below 921, the test's floor over
// 921..1023, validity above 346
constexpr int kBwBins = 921;
constexpr int kZtEnd = 1024;
constexpr int kBwValid = 346;
constexpr double kFiveDbPower = 3.16227766016838;  // src/movs.c:41
constexpr int kRefOnly = 1;    // ops/cuda_spectral.py REF_ONLY
constexpr int kBandwidth = 2;  // ops/cuda_spectral.py BANDWIDTH

// rounded operations: none is contracted with its neighbour into an fma
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }

// torch.amax's max: a NaN on either side wins
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// torch.clamp_min(x, 1e-12): a NaN stays
template <typename T>
__device__ __forceinline__ T floor_band(T x) {
  return x < T(1e-12) ? T(1e-12) : x;
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// S1's vectors: 16 bytes of the spectrum type T a thread and step (2
// doubles or 4 floats), the input read as as many values of its own type
__device__ __forceinline__ void load_vec(const float* p, float (&v)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max_nan(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// S1: one block a frame (row r, frame f of n), blocks in row-major order.
// Frame f is the 2048 contiguous samples of hop blocks f and f + 1; step k
// of thread t takes the vector at sample kVec (256 k + t), so each step of
// a warp reads and writes one contiguous span.
template <typename In, typename T>
__global__ void __launch_bounds__(kThreads)
pair_frames_kernel(const In* __restrict__ ref, const In* __restrict__ test,
                   const T* __restrict__ hann, T* __restrict__ frames,
                   T* __restrict__ energy, long long rows, long long n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSteps = kFrame / (kThreads * kVec);
  __shared__ T part[kWarps][2];
  const long long frame = blockIdx.x;
  const long long r = frame / n;
  const long long f = frame - r * n;
  const long long src = (r * (n + 1) + f) * kHop;
  const long long out = frame * kFrame;
  T er = T(0), et = T(0);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int j = (k * kThreads + threadIdx.x) * kVec;
    In a[kVec], b[kVec];
    T w[kVec], x[kVec], y[kVec];
    load_vec(ref + src + j, a);
    load_vec(test + src + j, b);
    load_vec(hann + j, w);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const T rr = static_cast<T>(a[e]);
      const T tt = static_cast<T>(b[e]);
      x[e] = mul_rn(rr, w[e]);
      y[e] = mul_rn(sub_rn(rr, tt), w[e]);
      // the energies of block f + 1: the frame's second half, whole steps
      if (k * kThreads * kVec >= kHop) {
        er += rr * rr;
        et += tt * tt;
      }
    }
    store_vec(frames + out + j, x);
    store_vec(frames + rows * n * kFrame + out + j, y);
  }
  // fixed order: each thread's sum, a warp butterfly, the warps in order
  const int warp = threadIdx.x / 32;
  er = warp_sum(er);
  et = warp_sum(et);
  if (threadIdx.x % 32 == 0) {
    part[warp][0] = er;
    part[warp][1] = et;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T sr = part[0][0], st = part[0][1];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) {
      sr += part[q][0];
      st += part[q][1];
    }
    energy[frame] = sr;
    energy[rows * n + frame] = st;
  }
}

// S2: one block a spectrum row; spec is [2][rows][1025] complex (R, D).
template <typename T>
__global__ void __launch_bounds__(kThreads)
spectral_movs_kernel(const T* __restrict__ spec, const T* __restrict__ level_p,
                     const int* __restrict__ span,
                     const T* __restrict__ weights, int z,
                     const unsigned char* __restrict__ ehs_zero, int flags,
                     T* __restrict__ band, T* __restrict__ noise,
                     T* __restrict__ bw, bool* __restrict__ valid,
                     T* __restrict__ d, long long rows) {
  using P = typename Pair<T>::type;
  __shared__ T s_pr[kBins];
  __shared__ T s_pt[kBins];
  __shared__ T s_q[kBins];
  __shared__ T s_zt[kWarps];
  __shared__ int s_idx[kWarps];
  const long long row = blockIdx.x;
  const T level = *level_p;
  const P* rs = reinterpret_cast<const P*>(spec) + row * kBins;
  const P* ds = reinterpret_cast<const P*>(spec) + (rows + row) * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    const P rv = rs[i];
    const P dv = ds[i];
    const T t_re = sub_rn(rv.x, dv.x);
    const T t_im = sub_rn(rv.y, dv.y);
    const T pr =
        mul_rn(add_rn(mul_rn(rv.x, rv.x), mul_rn(rv.y, rv.y)), level);
    const T pt =
        mul_rn(add_rn(mul_rn(t_re, t_re), mul_rn(t_im, t_im)), level);
    const T dp = mul_rn(add_rn(mul_rn(dv.x, add_rn(rv.x, t_re)),
                               mul_rn(dv.y, add_rn(rv.y, t_im))),
                        level);
    // NMR's noise spectrum (dp / (sqrt pr + sqrt pt))^2
    const T denom = add_rn(sqrt_rn(pr), sqrt_rn(pt));
    const T ratio = div_rn(dp, denom > T(0) ? denom : T(1));
    s_q[i] = mul_rn(ratio, ratio);
    s_pr[i] = pr;
    s_pt[i] = pt;
    if (i < kEhsBins) {
      // EHS's log-spectral difference, both regimes
      const T x = div_rn(dp, pr);
      T v;
      if (abs_t(x) <= T(0.5)) {
        v = log1p_t(-x);
      } else if (pt > T(0)) {
        v = log_t(div_rn(pt, pr));
      } else {
        v = -static_cast<T>(INFINITY);
      }
      if ((pr == T(0) && pt == T(0)) || ehs_zero[i]) v = T(0);
      d[row * kEhsBins + i] = v;
    }
  }
  __syncthreads();
  // band sums: one thread a band, its weight run in bin order
  for (int b = threadIdx.x; b < z; b += kThreads) {
    const int first = span[b];
    const int count = span[z + b];
    const T* wb = weights + span[2 * z + b];
    T ar = T(0), at = T(0), aq = T(0);
    for (int k = 0; k < count; ++k) {
      const T w = wb[k];
      ar += s_pr[first + k] * w;
      at += s_pt[first + k] * w;
      aq += s_q[first + k] * w;
    }
    band[row * z + b] = floor_band(ar);
    if (!(flags & kRefOnly)) band[(rows + row) * z + b] = floor_band(at);
    noise[row * z + b] = floor_band(aq);
  }
  if (!(flags & kBandwidth)) return;  // uniform over the block
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  T m = -static_cast<T>(INFINITY);
  for (int i = kBwBins + threadIdx.x; i < kZtEnd; i += kThreads) {
    m = max_nan(m, s_pt[i]);
  }
  m = warp_max_nan(m);
  if (lane == 0) s_zt[warp] = m;
  __syncthreads();
  T zt = s_zt[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) zt = max_nan(zt, s_zt[q]);
  const T ten_zt = mul_rn(T(10), zt);
  const T five_db_zt = mul_rn(static_cast<T>(kFiveDbPower), zt);
  int cand = 0;
  for (int i = threadIdx.x; i < kBwBins; i += kThreads) {
    if (s_pr[i] > ten_zt) cand = i + 1;
  }
  cand = warp_max(cand);
  if (lane == 0) s_idx[warp] = cand;
  __syncthreads();
  int bw_ref = s_idx[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) bw_ref = max(bw_ref, s_idx[q]);
  __syncthreads();  // every thread has read s_idx before it is written again
  cand = 0;
  for (int i = threadIdx.x; i < bw_ref; i += kThreads) {
    if (s_pt[i] >= five_db_zt) cand = i + 1;
  }
  cand = warp_max(cand);
  if (lane == 0) s_idx[warp] = cand;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bw_test = s_idx[0];
    for (int q = 1; q < kWarps; ++q) bw_test = max(bw_test, s_idx[q]);
    bw[row] = static_cast<T>(bw_ref);
    bw[rows + row] = static_cast<T>(bw_test);
    valid[row] = bw_ref > kBwValid;
  }
}

template <typename T>
int launch_pair_frames(const void* ref, const void* test, int in_double,
                       const void* hann, void* frames, void* energy,
                       long long rows, long long n, void* stream) {
  if (rows < 0 || n < 0 || (n > 0 && rows > INT_MAX / n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && n > 0) {
    const auto blocks = static_cast<unsigned>(rows * n);
    const auto s = static_cast<cudaStream_t>(stream);
    if (in_double) {
      pair_frames_kernel<double, T><<<blocks, kThreads, 0, s>>>(
          static_cast<const double*>(ref), static_cast<const double*>(test),
          static_cast<const T*>(hann), static_cast<T*>(frames),
          static_cast<T*>(energy), rows, n);
    } else {
      pair_frames_kernel<float, T><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(ref), static_cast<const float*>(test),
          static_cast<const T*>(hann), static_cast<T*>(frames),
          static_cast<T*>(energy), rows, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spectral_movs(const void* spec, const void* level,
                         const void* span, const void* weights, int z,
                         const void* ehs_zero, int flags, void* band,
                         void* noise, void* bw, void* valid, void* d,
                         long long rows, void* stream) {
  if (z < 1 || rows < 0 || rows > INT_MAX ||
      ((flags & kBandwidth) && (bw == nullptr || valid == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    spectral_movs_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(spec), static_cast<const T*>(level),
        static_cast<const int*>(span), static_cast<const T*>(weights), z,
        static_cast<const unsigned char*>(ehs_zero), flags,
        static_cast<T*>(band), static_cast<T*>(noise), static_cast<T*>(bw),
        static_cast<bool*>(valid), static_cast<T*>(d), rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The suffix names the spectrum type T (frames, energies, every S2 value).
// pair_frames: ref/test [rows][n + 1][1024] of float (in_double = 0) or
// double (1); hann [2048]; frames [2][rows][n][2048]; energy [2][rows][n].
int peaq_pair_frames_f32(const void* ref, const void* test, int in_double,
                         const void* hann, void* frames, void* energy,
                         long long rows, long long n, void* stream) {
  return launch_pair_frames<float>(ref, test, in_double, hann, frames,
                                   energy, rows, n, stream);
}

int peaq_pair_frames_f64(const void* ref, const void* test, int in_double,
                         const void* hann, void* frames, void* energy,
                         long long rows, long long n, void* stream) {
  return launch_pair_frames<double>(ref, test, in_double, hann, frames,
                                    energy, rows, n, stream);
}

// spectral_movs: spec [2][rows][1025][2] (R, D); level [1]; span [3][z]
// int32 (first bin, count, weight offset); weights; ehs_zero [512] bool;
// flags: 1 ref only, 2 bandwidth; band [2 | 1][rows][z]; noise [rows][z];
// bw [2][rows] and valid [rows] bool (null without the bandwidth flag);
// d [rows][512].
int peaq_spectral_movs_f32(const void* spec, const void* level,
                           const void* span, const void* weights, int z,
                           const void* ehs_zero, int flags, void* band,
                           void* noise, void* bw, void* valid, void* d,
                           long long rows, void* stream) {
  return launch_spectral_movs<float>(spec, level, span, weights, z, ehs_zero,
                                     flags, band, noise, bw, valid, d, rows,
                                     stream);
}

int peaq_spectral_movs_f64(const void* spec, const void* level,
                           const void* span, const void* weights, int z,
                           const void* ehs_zero, int flags, void* band,
                           void* noise, void* bw, void* valid, void* d,
                           long long rows, void* stream) {
  return launch_spectral_movs<double>(spec, level, span, weights, z,
                                      ehs_zero, flags, band, noise, bw, valid,
                                      d, rows, stream);
}

}  // extern "C"
