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
//   halves[s] = sum of the squares of b_f of ref (s = 0) and of ref - test
//               (1): the frame's first half, the totalsnr energies
//               (src/gstpeaq.c:913-918), which no pass over the signal
//               takes any more
// What bounds it on the H100: bytes, its writes above all (2 x 2048 values
// a frame against 2 x 1024 read).  Design: one block of 256 threads a
// frame (two contiguous hop blocks), 16-byte vectors of T, each step of a
// warp on one contiguous span (a thread's vectors 256 vectors apart); the
// input is converted to T on the fly (float or double either way), so the
// rDFT reads one [2, .., F, 2048] tensor and one batched cuFFT call
// transforms both signals.  Each energy and half is a fixed-order sum (a
// thread's samples of its block in order, a warp butterfly, the eight
// warps in order), so two launches give the same bits.
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
// S2 reads only the bins its call needs (ops/cuda_spectral.py bins_read):
// those below group_bin_hi (769 at 109 and 55 bands; the grouping matrix
// is zero from there up) and below 512 (EHS), and with the bandwidth flag
// (the basic call) those below 1024; bin 1024 is never read.  The noise
// spectrum is formed below group_bin_hi alone.
// What bounds it on the H100: bytes.  A row reads 2 x bins complex values
// and writes ~2 Z + Z + 512 + 3, so the [.., F, 1025] power, delta-power
// and noise spectra that the eager version wrote and read again are the
// bytes saved.  Its FP64 math (the noise's roots and division, EHS's
// division and log1p) is about a third of the bytes' time at the basic
// batch, so it must run while other rows load.
// Design.  Forming a bin (pr, pt, dp at it, EHS's d below 512, written at
// once, the noise spectrum below group_bin_hi) writes pr, pt and the
// noise into a stage in shared memory; the band sums take `lanes` threads
// a band (lane l adding its run's bins l, l + lanes, ... in order, a
// butterfly adding the lanes in a fixed order; in float one thread a
// band), the last reducing warp with the bandwidth flag the bandwidth
// alone (zt by a warp max over pt[921..1023], bw_ref and bw_test by
// __ballot_sync over 32 bins at a time from the top down, stopping at the
// first hit).  Two launches, chosen by the host planner
// (ops/cuda_spectral.py movs_plan) from the row count, the dtype and the
// flags, each where it ran fastest (PERF.md section 6):
// - a row a block (spectral_movs_row_kernel; kRowResident<T> blocks of
//   kRowThreads an SM), where the ring's grid would walk some block
//   through two rows or more, save the float64 batches without the
//   bandwidth flag: every thread forms its bins of the row (no more than
//   five) from device memory, each pass's loads issued while the pass
//   before forms (from 8,192 rows the first thread prefetches the row
//   into L2 first), then every warp reduces the row (in double lanes 2 at
//   109 bands with the bandwidth flag, 4 at 55 without), the tables read
//   where they lie.
// - else a persistent ring (spectral_movs_kernel; kMovsResident<T> blocks
//   of kMovsThreads threads an SM, none without a row): block b walks rows
//   b, b + grid, ... through a ring of `stages` stages, each row's R and D
//   bins staged by two cp.async.bulk (TMA 1-D) copies that complete on
//   the stage's `full` mbarrier.  A double row starts on a 16-byte
//   boundary; a float row of an odd index does not (1,025 x 8 bytes a
//   row), so its copy starts one bin early and the stage holds it one
//   slot on (`lead`).  The weights, the group table and EHS's dead bins
//   are copied into shared memory once a block, while the first rows
//   load.  kFormThreads form threads form a row in place once it lands
//   and arrive on the stage's `formed` mbarrier; kReduceWarps reduction
//   warps take it from there (in double lanes 1 at 109 bands with the
//   bandwidth flag, 2 at 55 without), and once all are done (a named
//   barrier of theirs) their first thread copies the row `stages` rows on
//   into the stage.  The form threads so run up to `stages` rows ahead of
//   the reductions, and the loads overlap both.
// Every product, sum and quotient that a comparison reads (bandwidth's
// > 10 zt and >= 5dB zt, EHS's |dp/pr| <= 1/2, pr == 0) is rounded op for
// op as the plain version rounds it (__dmul_rn / __dadd_rn, never
// contracted into an fma), so those decisions agree with it bit for bit;
// log1p and log are CUDA's libdevice functions.  The noise spectrum is
// the plain version's form, its roots and division rounded as IEEE's.
// Each band sum runs in the same order in every launch, so two launches
// give the same bits.
// Templated on float and double; no fast-math flag.  Offsets are 64-bit.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHop = 1024;
constexpr int kFrame = 2 * kHop;
constexpr int kBins = kHop + 1;
constexpr int kEhsBins = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// S2's launch (ops/cuda_spectral.py movs_plan holds the same numbers): a
// block's threads, its reduction warps (the rest form each row's spectra)
constexpr int kMovsThreads = 512;
constexpr int kResidentFloat = 3;       // blocks an SM, float
constexpr int kResidentDouble = 2;      // and double
constexpr int kMaxStages = 32;          // the ring's stages: a parity bit each
constexpr int kReduceWarps = 4;         // band sums and bandwidth
constexpr int kReduceThreads = 32 * kReduceWarps;
constexpr int kFormThreads = kMovsThreads - kReduceThreads;
template <typename T>
constexpr int kMovsResident = sizeof(T) == 8 ? kResidentDouble : kResidentFloat;
// S2's row-a-block launch (movs_plan's rowwise plan): a block's threads,
// all forming one row and then all reducing it, and its blocks an SM
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowResidentFloat = 8;
constexpr int kRowResidentDouble = 4;
template <typename T>
constexpr int kRowResident =
    sizeof(T) == 8 ? kRowResidentDouble : kRowResidentFloat;
// a band's threads at most: in float one (a band's products are quick, a
// butterfly over lanes cost more than it saved on an H100: PERF.md
// section 6), in double what the configurations reach, 4 at 55 bands in a
// row block (2 at 109 with the bandwidth flag; 2 and 1 in the ring)
constexpr int kMaxBandLanesFloat = 1;
constexpr int kMaxBandLanesDouble = 4;
template <typename T>
constexpr int kMaxBandLanes =
    sizeof(T) == 8 ? kMaxBandLanesDouble : kMaxBandLanesFloat;
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

// S1: one block a frame (row r, frame f of n), blocks in row-major order.
// Frame f is the 2048 contiguous samples of hop blocks f and f + 1; step k
// of thread t takes the vector at sample kVec (256 k + t), so each step of
// a warp reads and writes one contiguous span.
template <typename In, typename T>
__global__ void __launch_bounds__(kThreads)
pair_frames_kernel(const In* __restrict__ ref, const In* __restrict__ test,
                   const T* __restrict__ hann, T* __restrict__ frames,
                   T* __restrict__ energy, T* __restrict__ halves,
                   long long rows, long long n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSteps = kFrame / (kThreads * kVec);
  __shared__ T part[kWarps][4];
  const long long frame = blockIdx.x;
  const long long r = frame / n;
  const long long f = frame - r * n;
  const long long src = (r * (n + 1) + f) * kHop;
  const long long out = frame * kFrame;
  T er = T(0), et = T(0), hr = T(0), hn = T(0);
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
      const T dd = sub_rn(rr, tt);
      x[e] = mul_rn(rr, w[e]);
      y[e] = mul_rn(dd, w[e]);
      // whole steps: block f + 1 (the frame's second half) gives the
      // energies, block f the halves
      if (k * kThreads * kVec >= kHop) {
        er += rr * rr;
        et += tt * tt;
      } else {
        hr += rr * rr;
        hn += dd * dd;
      }
    }
    store_vec(frames + out + j, x);
    store_vec(frames + rows * n * kFrame + out + j, y);
  }
  // fixed order: each thread's sum, a warp butterfly, the warps in order
  const int warp = threadIdx.x / 32;
  er = warp_sum(er);
  et = warp_sum(et);
  hr = warp_sum(hr);
  hn = warp_sum(hn);
  if (threadIdx.x % 32 == 0) {
    part[warp][0] = er;
    part[warp][1] = et;
    part[warp][2] = hr;
    part[warp][3] = hn;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int s = threadIdx.x;
    T sum = part[0][s];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) sum += part[q][s];
    T* out = s < 2 ? energy : halves;
    out[(s % 2) * rows * n + frame] = sum;
  }
}

__device__ __forceinline__ unsigned smem_of(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_of(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_of(bar))
               : "memory");
}

// the stage's one arrival, expecting `bytes` from the copies it starts
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_of(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_of(bar)), "r"(parity)
        : "memory");
  }
}

// one TMA 1-D copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  // the stage was last read and written in the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_of(dst)),
      "l"(src), "r"(bytes), "r"(smem_of(bar))
      : "memory");
}

// one TMA 1-D prefetch into L2 of `bytes` (a multiple of 16, 16-byte
// aligned)
__device__ __forceinline__ void bulk_prefetch(const void* src,
                                              unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

template <typename T>
struct MovsArgs {
  const T* spec;              // [2][rows][1025] complex (R, D)
  const T* level;
  const int* span;            // [3][z]: first bin, count, weight offset
  const T* weights;
  const unsigned char* ehs_zero;
  T* band;
  T* noise;
  T* bw;
  bool* valid;
  T* d;
  long long rows;
  int z, n_weights, flags, hi, bins, region, stages, prefetch;
};

// The tables every row reads, copied into shared memory once a block: the
// band weights, the group table and EHS's dead bins.
template <typename T>
struct Tables {
  const T* weights;
  const int* span;
  const unsigned char* ehs_zero;
};

// A spectrum row g's copy: a double row from its bin 0, a float row of an
// odd g from its bin -1 (the previous row's bin 1024), which puts its
// source on a 16-byte boundary; whole 16-byte units either way, inside
// the tensor (an even float row reads at most bin 1025 of a 1,025-bin
// call, the next row's first, and the last row g = 2 rows - 1 is odd).
template <typename T>
__device__ __forceinline__ int row_lead(long long g) {
  return sizeof(T) == 4 ? static_cast<int>(g & 1) : 0;
}

template <typename T>
__device__ __forceinline__ unsigned row_bytes(int bins, int lead) {
  return sizeof(T) == 8 ? 16u * bins : 8u * ((bins + lead + 1) & ~1);
}

// NMR's noise spectrum (dp / (sqrt pr + sqrt pt))^2, 0-safe as the plain
// version is (a zero denominator taken as 1), in both types.
template <typename T>
__device__ __forceinline__ T noise_of(T pr, T pt, T dp) {
  const T denom = add_rn(sqrt_rn(pr), sqrt_rn(pt));
  const T ratio = div_rn(dp, denom > T(0) ? denom : T(1));
  return mul_rn(ratio, ratio);
}

// The copies of row `row` into `stage` (one thread): R's row and D's.
template <typename T>
__device__ __forceinline__ void issue_row(const MovsArgs<T>& a,
                                          typename Pair<T>::type* stage,
                                          uint64_t* bar, long long row) {
  using P = typename Pair<T>::type;
  const P* spec = reinterpret_cast<const P*>(a.spec);
  const int lr = row_lead<T>(row);
  const int ld = row_lead<T>(a.rows + row);
  const unsigned br = row_bytes<T>(a.bins, lr);
  const unsigned bd = row_bytes<T>(a.bins, ld);
  bar_expect(bar, br + bd);
  bulk_copy(stage, spec + row * kBins - lr, br, bar);
  bulk_copy(stage + a.region, spec + (a.rows + row) * kBins - ld, bd, bar);
}

// the reduction warps' own barrier (id 1; __syncthreads takes 0)
__device__ __forceinline__ void reduce_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kReduceThreads) : "memory");
}

// Bin i of a row from its R and D values: pr, pt into rs[i], the noise
// spectrum into ds[i]'s real part below hi, EHS's d below 512, written at
// once.
template <typename T>
__device__ __forceinline__ void form_bin(const MovsArgs<T>& a,
                                         const Tables<T>& t,
                                         typename Pair<T>::type rv,
                                         typename Pair<T>::type dv,
                                         typename Pair<T>::type* rs,
                                         typename Pair<T>::type* ds,
                                         T level, long long row, int i) {
  using P = typename Pair<T>::type;
  const T t_re = sub_rn(rv.x, dv.x);
  const T t_im = sub_rn(rv.y, dv.y);
  const T pr = mul_rn(add_rn(mul_rn(rv.x, rv.x), mul_rn(rv.y, rv.y)), level);
  const T pt =
      mul_rn(add_rn(mul_rn(t_re, t_re), mul_rn(t_im, t_im)), level);
  rs[i] = P{pr, pt};
  if (i < a.hi || i < kEhsBins) {
    const T dp = mul_rn(add_rn(mul_rn(dv.x, add_rn(rv.x, t_re)),
                               mul_rn(dv.y, add_rn(rv.y, t_im))),
                        level);
    if (i < a.hi) ds[i].x = noise_of(pr, pt, dp);
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
      if ((pr == T(0) && pt == T(0)) || t.ehs_zero[i]) v = T(0);
      a.d[row * kEhsBins + i] = v;
    }
  }
}

// One staged row's spectra by kForm form threads (f: 0 .. kForm - 1), each
// forming bins f, f + kForm, ... in place.
template <typename T, int kForm>
__device__ __forceinline__ void form_row(const MovsArgs<T>& a,
                                         const Tables<T>& t,
                                         typename Pair<T>::type* rs,
                                         typename Pair<T>::type* ds,
                                         T level, long long row, int f) {
#pragma unroll
  for (int pass = 0; pass < (kBins + kForm - 1) / kForm; ++pass) {
    const int i = f + pass * kForm;
    if (i >= a.bins) break;
    form_bin(a, t, rs[i], ds[i], rs, ds, level, row, i);
  }
}

// One row's band sums and bandwidth by kWarps reduction warps (r: 0 ..
// 32 kWarps - 1): `lanes` threads a band; with the bandwidth flag the last
// warp takes the bandwidth alone, the warps before it the bands.
template <typename T, int kWarps>
__device__ __forceinline__ void reduce_row(const MovsArgs<T>& a,
                                           const Tables<T>& t,
                                           const typename Pair<T>::type* rs,
                                           const typename Pair<T>::type* ds,
                                           long long row, int r) {
  using P = typename Pair<T>::type;
  const int z = a.z;
  const bool bandwidth = a.flags & kBandwidth;
  const int summing = 32 * (bandwidth ? kWarps - 1 : kWarps);
  // a band's lanes: consecutive threads, the most (a power of two, at
  // most kMaxBandLanes<T>) that give every band its lanes at once; lane l
  // adds the run's bins l, l + lanes, ... in order, and a butterfly over
  // the lanes adds theirs in a fixed order
  int lanes = 1;
  while (lanes < kMaxBandLanes<T> && 2 * lanes * z <= summing) lanes *= 2;
  const int part = r % lanes;
  // warp-uniform: summing is a whole number of warps
  for (int b0 = 0; r < summing && b0 < z; b0 += summing / lanes) {
    const int b = b0 + r / lanes;
    T ar = T(0), at = T(0), aq = T(0);
    if (b < z) {
      const int first = t.span[b];
      const int count = t.span[z + b];
      const T* wb = t.weights + t.span[2 * z + b];
#pragma unroll 4
      for (int m = part; m < count; m += lanes) {
        const T w = wb[m];
        const P p = rs[first + m];
        ar += p.x * w;
        at += p.y * w;
        aq += ds[first + m].x * w;
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      ar += __shfl_xor_sync(0xffffffffu, ar, off);
      at += __shfl_xor_sync(0xffffffffu, at, off);
      aq += __shfl_xor_sync(0xffffffffu, aq, off);
    }
    if (b < z && part == 0) {
      a.band[row * z + b] = floor_band(ar);
      if (!(a.flags & kRefOnly)) a.band[(a.rows + row) * z + b] =
          floor_band(at);
      a.noise[row * z + b] = floor_band(aq);
    }
  }
  const int lane = r & 31;
  if (!bandwidth || r / 32 != kWarps - 1) return;
  T m = -static_cast<T>(INFINITY);
  for (int i = kBwBins + lane; i < kZtEnd; i += 32) m = max_nan(m, rs[i].y);
  const T zt = warp_max_nan(m);
  const T ten_zt = mul_rn(T(10), zt);
  const T five_db_zt = mul_rn(static_cast<T>(kFiveDbPower), zt);
  // the highest bin i < 921 with pr[i] > 10 zt, 32 bins a step down
  int bw_ref = 0;
  for (int base = (kBwBins - 1) & ~31; base >= 0; base -= 32) {
    const int i = base + lane;
    const unsigned hit =
        __ballot_sync(0xffffffffu, i < kBwBins && rs[i].x > ten_zt);
    if (hit) {
      bw_ref = base + 32 - __clz(hit);
      break;
    }
  }
  // the highest bin i < bw_ref with pt[i] >= 5dB zt
  int bw_test = 0;
  for (int base = (bw_ref - 1) & ~31; base >= 0; base -= 32) {
    const int i = base + lane;
    const unsigned hit =
        __ballot_sync(0xffffffffu, i < bw_ref && rs[i].y >= five_db_zt);
    if (hit) {
      bw_test = base + 32 - __clz(hit);
      break;
    }
  }
  if (lane == 0) {
    a.bw[row] = static_cast<T>(bw_ref);
    a.bw[a.rows + row] = static_cast<T>(bw_test);
    a.valid[row] = bw_ref > kBwValid;
  }
}

// S2: a persistent grid, block b taking rows b, b + grid, ...  The form
// threads take a row once its copies land (stage s's `full` mbarrier) and
// arrive on its `formed` mbarrier; the reduction threads take it from
// there, and once they are all done their first thread copies the row
// `stages` rows on into the stage.  The form threads so run up to
// `stages` rows ahead of the reduction threads.  Dynamic shared memory: `stages` stages
// of 2 x region complex slots (R, D), then `stages` `full` and `stages`
// `formed` mbarriers, then the tables (Tables).
template <typename T>
__global__ void __launch_bounds__(kMovsThreads, kMovsResident<T>)
spectral_movs_kernel(const MovsArgs<T> a) {
  using P = typename Pair<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  P* ring = reinterpret_cast<P*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + sizeof(P) * 2 * a.region * a.stages);
  uint64_t* formed = full + a.stages;
  T* s_weights = reinterpret_cast<T*>(formed + a.stages);
  int* s_span = reinterpret_cast<int*>(s_weights + a.n_weights);
  unsigned char* s_zero =
      reinterpret_cast<unsigned char*>(s_span + 3 * a.z);
  const Tables<T> t{s_weights, s_span, s_zero};
  const int tid = threadIdx.x;
  const long long grid = gridDim.x;
  const int producer = kFormThreads;   // the first reduction thread
  // the first rows' copies go out before the tables are read; the
  // barriers' init reaches them through the proxy fence each bulk copy
  // takes, and the other threads through the __syncthreads below
  if (tid == producer) {
    for (int s = 0; s < a.stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&formed[s], kFormThreads);
    }
    for (int s = 0; s < a.stages; ++s) {
      const long long row = blockIdx.x + s * grid;
      if (row < a.rows) {
        issue_row(a, ring + s * 2 * a.region, &full[s], row);
      }
    }
  }
  for (int i = tid; i < a.n_weights; i += kMovsThreads) {
    s_weights[i] = a.weights[i];
  }
  for (int i = tid; i < 3 * a.z; i += kMovsThreads) s_span[i] = a.span[i];
  for (int i = tid; i < kEhsBins; i += kMovsThreads) {
    s_zero[i] = a.ehs_zero[i];
  }
  __syncthreads();
  unsigned parity = 0;          // bit s: the phase of stage s's mbarrier
  int s = 0;
  if (tid < kFormThreads) {
    const T level = *a.level;
    for (long long row = blockIdx.x; row < a.rows; row += grid) {
      bar_wait(&full[s], (parity >> s) & 1u);
      parity ^= 1u << s;
      P* stage = ring + s * 2 * a.region;
      P* rs = stage + row_lead<T>(row);
      P* ds = stage + a.region + row_lead<T>(a.rows + row);
      form_row<T, kFormThreads>(a, t, rs, ds, level, row, tid);
      bar_arrive(&formed[s]);
      s = s + 1 == a.stages ? 0 : s + 1;
    }
  } else {
    const int r = tid - kFormThreads;
    for (long long row = blockIdx.x; row < a.rows; row += grid) {
      bar_wait(&formed[s], (parity >> s) & 1u);
      parity ^= 1u << s;
      P* stage = ring + s * 2 * a.region;
      reduce_row<T, kReduceWarps>(a, t, stage + row_lead<T>(row),
                 stage + a.region + row_lead<T>(a.rows + row), row, r);
      reduce_sync();            // stage s read: its next row may land
      const long long next = row + a.stages * grid;
      if (r == 0 && next < a.rows) {
        issue_row(a, stage, &full[s], next);
      }
      s = s + 1 == a.stages ? 0 : s + 1;
    }
  }
}

// S2 a row a block (the rowwise plan; ops/cuda_spectral.py movs_plan
// says where): every thread forms its bins of the row (f, f +
// kRowThreads, ...) from device memory into the block's stage, each
// pass's loads issued while the pass before forms (with `prefetch` the
// first thread prefetching the row into L2 first, as the ring copies a
// row); then, after a barrier, every warp reduces the row (the band sums
// on all but the last warp with the bandwidth flag, on all without), the
// tables read where they lie.  Dynamic shared memory: the stage.
template <typename T>
__global__ void __launch_bounds__(kRowThreads, kRowResident<T>)
spectral_movs_row_kernel(const MovsArgs<T> a) {
  using P = typename Pair<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  P* stage = reinterpret_cast<P*>(smem);
  const Tables<T> t{a.weights, a.span, a.ehs_zero};
  const long long row = blockIdx.x;
  const P* spec = reinterpret_cast<const P*>(a.spec);
  const int f = threadIdx.x;
  const int lr = row_lead<T>(row);
  const int ld = row_lead<T>(a.rows + row);
  P* rs = stage + lr;
  P* ds = stage + a.region + ld;
  const P* src_r = spec + row * kBins;
  const P* src_d = spec + (a.rows + row) * kBins;
  if (a.prefetch && f == 0) {
    bulk_prefetch(src_r - lr, row_bytes<T>(a.bins, lr));
    bulk_prefetch(src_d - ld, row_bytes<T>(a.bins, ld));
  }
  // each pass's bins loaded while the pass before forms
  P r_next{}, d_next{};
  if (f < a.bins) {
    r_next = src_r[f];
    d_next = src_d[f];
  }
#pragma unroll
  for (int pass = 0; pass < (kBins + kRowThreads - 1) / kRowThreads;
       ++pass) {
    const int i = f + pass * kRowThreads;
    if (i >= a.bins) break;
    const P rv = r_next;
    const P dv = d_next;
    if (i + kRowThreads < a.bins) {
      r_next = src_r[i + kRowThreads];
      d_next = src_d[i + kRowThreads];
    }
    // the level read at each bin (a register fewer held across the row;
    // faster on an H100, PERF.md section 6)
    form_bin(a, t, rv, dv, rs, ds, *a.level, row, i);
  }
  __syncthreads();
  reduce_row<T, kRowWarps>(a, t, rs, ds, row, f);
}

template <typename T>
int launch_pair_frames(const void* ref, const void* test, int in_double,
                       const void* hann, void* frames, void* energy,
                       void* halves, long long rows, long long n,
                       void* stream) {
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
          static_cast<T*>(energy), static_cast<T*>(halves), rows, n);
    } else {
      pair_frames_kernel<float, T><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(ref), static_cast<const float*>(test),
          static_cast<const T*>(hann), static_cast<T*>(frames),
          static_cast<T*>(energy), static_cast<T*>(halves), rows, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spectral_movs(const void* spec, const void* level,
                         const void* span, const void* weights, int z,
                         int n_weights, const void* ehs_zero, int flags,
                         int hi, int bins, int rowwise, int prefetch,
                         int region, int stages, int blocks, int shared,
                         void* band, void* noise, void* bw, void* valid,
                         void* d, long long rows, void* stream) {
  using P = typename Pair<T>::type;
  const int need_bins = (flags & kBandwidth) ? kZtEnd : 0;
  const long long stage = static_cast<long long>(sizeof(P)) * 2 * region;
  const long long need =
      rowwise ? stage
              : (stage + 16LL) * stages +
                    static_cast<long long>(sizeof(T)) * n_weights + 12LL * z +
                    kEhsBins;
  if (z < 1 || n_weights < 1 || rows < 0 || hi < 1 || hi > kBins ||
      bins > kBins || bins < hi || bins < kEhsBins || bins < need_bins ||
      region < bins + 2 || (region * sizeof(P)) % 16 != 0 || stages < 1 ||
      stages > kMaxStages || (rowwise && (stages != 1 || blocks < rows)) ||
      (prefetch && !rowwise) ||
      shared < need || blocks < 1 ||
      ((flags & kBandwidth) && (bw == nullptr || valid == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    const MovsArgs<T> a{static_cast<const T*>(spec),
                        static_cast<const T*>(level),
                        static_cast<const int*>(span),
                        static_cast<const T*>(weights),
                        static_cast<const unsigned char*>(ehs_zero),
                        static_cast<T*>(band),
                        static_cast<T*>(noise),
                        static_cast<T*>(bw),
                        static_cast<bool*>(valid),
                        static_cast<T*>(d),
                        rows, z, n_weights, flags, hi, bins, region,
                        stages, prefetch};
    auto kernel = rowwise ? spectral_movs_row_kernel<T> : spectral_movs_kernel<T>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long grid = blocks < rows ? blocks : rows;
    kernel<<<static_cast<unsigned>(grid), rowwise ? kRowThreads
                                                  : kMovsThreads,
             shared, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The suffix names the spectrum type T (frames, energies, every S2 value).
// pair_frames: ref/test [rows][n + 1][1024] of float (in_double = 0) or
// double (1); hann [2048]; frames [2][rows][n][2048]; energy and halves
// [2][rows][n].
int peaq_pair_frames_f32(const void* ref, const void* test, int in_double,
                         const void* hann, void* frames, void* energy,
                         void* halves, long long rows, long long n,
                         void* stream) {
  return launch_pair_frames<float>(ref, test, in_double, hann, frames,
                                   energy, halves, rows, n, stream);
}

int peaq_pair_frames_f64(const void* ref, const void* test, int in_double,
                         const void* hann, void* frames, void* energy,
                         void* halves, long long rows, long long n,
                         void* stream) {
  return launch_pair_frames<double>(ref, test, in_double, hann, frames,
                                    energy, halves, rows, n, stream);
}

// spectral_movs: spec [2][rows][1025][2] (R, D), 16-byte aligned; level
// [1]; span [3][z] int32 (first bin, count, weight offset: each run below
// hi); weights [n_weights]; ehs_zero [512] bool; flags: 1 ref only, 2 bandwidth; hi:
// group_bin_hi; bins: the bins read a row (at least hi, 512 and, with the
// bandwidth flag, 1024); the plan from ops/cuda_spectral.py movs_plan
// (rowwise: a row a block of kRowThreads, else the persistent ring;
// prefetch: a row block prefetches its row into L2;
// region: a spectrum's slots in a stage, stages (1 rowwise), blocks (at
// least rows rowwise), shared: the block's bytes of dynamic shared
// memory); band [2 | 1][rows][z]; noise
// [rows][z]; bw [2][rows] and valid [rows] bool (null without the
// bandwidth flag); d [rows][512].
int peaq_spectral_movs_f32(const void* spec, const void* level,
                           const void* span, const void* weights, int z,
                           int n_weights, const void* ehs_zero, int flags,
                           int hi, int bins, int rowwise, int prefetch,
                           int region, int stages, int blocks, int shared,
                           void* band, void* noise, void* bw, void* valid,
                           void* d, long long rows, void* stream) {
  return launch_spectral_movs<float>(spec, level, span, weights, z,
                                     n_weights, ehs_zero, flags, hi, bins,
                                     rowwise, prefetch, region, stages,
                                     blocks,
                                     shared, band,
                                     noise, bw, valid, d, rows, stream);
}

int peaq_spectral_movs_f64(const void* spec, const void* level,
                           const void* span, const void* weights, int z,
                           int n_weights, const void* ehs_zero, int flags,
                           int hi, int bins, int rowwise, int prefetch,
                           int region, int stages, int blocks, int shared,
                           void* band, void* noise, void* bw, void* valid,
                           void* d, long long rows, void* stream) {
  return launch_spectral_movs<double>(spec, level, span, weights, z,
                                      n_weights, ehs_zero, flags, hi, bins,
                                      rowwise, prefetch, region, stages,
                                      blocks,
                                      shared, band,
                                      noise, bw, valid, d, rows, stream);
}

}  // extern "C"
