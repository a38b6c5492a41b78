// The band-domain epilogues, for Hopper (sm_90a): L1 levcorr, L2
// pattern_adapt and M1 band_movs.  BS.1387 / src/leveladapter.c:260-340 and
// src/movs.c:204-254 (ModDiff, TempWt), :708-743 (noise loudness),
// :970-1023 (NMR's band half), :1223-1276 (detection probability, steps),
// src/earmodel.c:890-907 (the overall loudness of the MOV gates).
//
// None replaces a TPU kernel.  The JAX package leaves this work to XLA,
// which fuses it under jit (gstpeaq_tpu/models/level_adapt.py:45
// adapt_stage2, gstpeaq_tpu/models/movs.py:20 modulation_difference, :46
// noise_loudness, :101 nmr, :136 prob_detect); the port ran each line as its
// own launch over a whole [.., Z, F] tensor, some 100 launches a call.
//
// Layout: [.., Z, F], frames contiguous.  A row is one lead index (pair x
// channel); rows x Z x F elements a band tensor.  A block takes 32 frames
// of one row (a column each) and splits the Z bands into 8 groups, one
// warp each: a thread walks its group's bands in ascending order and keeps
// its partial reductions in registers, loads coalesced across the warp's
// frames and each element read once; warp 0 then adds the 8 partials in
// group order.  The sums are so taken in one fixed order (group by group,
// each ascending), and a thread's chain of dependent steps is Z / 8 long:
// one thread a column walking all Z bands was latency-bound at the
// per-pair and chunk shapes on an H100 (0.45 ms for M1 on one 10 s pair
// in double, against 0.85 ms for the eager version).
//
// L1 levcorr, per column, from the stacked excitations E (ref, test) and
// their stage-1 smoothed excitations P (ref, test), after K1 or K2:
//   num = sum_z sqrt(Pr Pt), den = sum_z Pt          (the fixed order)
//   lev = num num / (den den)                        (out: lev [rows, F])
//   Lr = Er / lev, Lt = Et where lev > 1; Lr = Er, Lt = Et lev elsewhere
//   drive = (Lt Lr, Lr Lr)                           (out: [2, rows, Z, F])
// For an identical pair sqrt(fl(x x)) == x, so num == den bit for bit and
// lev == 1 exactly: the identical pair's exact zeros rest on that.
// L2 pattern_adapt, per column, from the num/den smoothers' outputs N, D:
//   Ar = 1, At = D / N where N >= D; Ar = N / D, At = 1 elsewhere
//   out_s[k] = (1 - a_k) (avg[k, k] sum_{w = k-m1c}^{k+m2c} A_s[w])
// the window sum in ascending w from 0, bands past either edge entering as
// exact zeros (band_average's order), over a register window of m1c + m2c
// + 1 values (8 at Z = 109, 3 at Z = 40; a kernel for each width), each
// A computed once a group (and its halo of m1c + m2c bands again, the same
// bits), so L2's bits equal the plain version's.
// M1 band_movs, per column, the per-frame MOV terms of one call site:
//   ModDiff1/2 and TempWt (src/movs.c:204-254), the noise loudness of one
//   set (basic) or three (advanced: NoiseLoudAsym, its missing components
//   and LinDist, swapped by swap_mod_patts_for_noise_loudness_movs), each
//   on the adapted excitations Lr pc_ref and Lt pc_test recomputed from E,
//   lev and pc (they are never written); the overall loudness of both
//   signals (the MOV gates); NMR's mean and disturbed flag from S2's noise
//   per band, which lies [rows, F, Z] and is staged through shared memory
//   a tile of 32 frames x Z bands (up to 128; past that read in place);
//   and per pair and frame the binaural detection probability and steps:
//   the maximum over channels inside the kernel, the product of
//   (1 - p_band) and the sum of q_band in the fixed order.  The pairs'
//   tiles are blocks of their own in the same launch (they read the
//   channels of a pair, in order).
//
// What bounds them on the H100: bytes.  At the basic float64 batch
// ([64, 2, 109, 512], 57 MB a band tensor) L1 reads four and writes two
// (343 MB, 0.10 ms at 3.35 TB/s), L2 reads two and writes two (229 MB), M1
// reads eight (457 MB, 0.14 ms; the pairs' columns read E a second time).
//
// Numerics.  This file is built with -fmad=false (ops/_build.py), so no
// product is contracted into an fma with the sum that follows: every
// product, sum and quotient is rounded as the plain version's eager
// launches round it, op for op in its order.  That matters where a
// discontinuous decision reads the value: trunc / floor(e) of the steps,
// nl < nl_min, nmr_max > 1.5 dB (disturbed) and l > 0.  The comparisons
// where both branches meet (lev > 1, N >= D, mod_test >= mod_ref,
// eref_db > etest_db) may stay as they fall.  pow, exp, log10 and sqrt are
// the CUDA math library's functions, the ones torch's CUDA kernels call
// (pow(x, 0.23) for ** 0.23, pow(l, 4) for l ** 4, l l l for l ** 3);
// the even powers t^4 / t^4 t^2 of the detection probability are products,
// never a pow of a negative base.  Band sums run in the fixed order above,
// where torch's reductions take an order of their own: kernel and plain
// agree to rounding there.  float32 computes in float and float64 in double;
// NMR's terms in the spectrum type S of the noise (S >= T).  Offsets are
// 64-bit.

#include <climits>

#include <cuda_runtime.h>
#include <math.h>

namespace {

// A block: 32 frames (a warp's lanes) by 8 band groups (one warp each).
// Thread (g, lane) walks band group g, bands [g Z / 8, (g + 1) Z / 8), of
// frame f0 + lane; the groups' partial sums meet in shared memory and warp
// 0 adds them in group order.  So a column's work is spread over 8
// threads: a short chain of dependent loads and transcendentals a thread,
// and 8 times the threads of one a column at the small per-pair and chunk
// shapes, where the walk's latency and not the bytes bound the kernel.
constexpr int kLanes = 32;
constexpr int kGroups = 8;
constexpr int kThreads = kLanes * kGroups;
constexpr int kMaxBands = 256;    // M1's per-band constants in shared memory
constexpr int kMaxWindow = 16;    // L2's band-average window, bands
constexpr int kNmrTile = 128;     // M1 stages NMR's noise up to 128 bands

// the model's constants (constants.py; tests/test_torch_band.py holds them
// equal): src/movs.c:1223-1276's s(l) coefficients, src/movs.c:42
constexpr double kPdS0 = 5.95072;
constexpr double kPdS1 = 6.39468;
constexpr double kPdS2 = 1.71332;
constexpr double kPdS3 = 9.01033e-11;
constexpr double kPdS4 = 5.05622e-6;
constexpr double kPdS5 = 0.00102438;
constexpr double kPdS6 = 0.0550197;
constexpr double kPdS7 = 0.198719;
constexpr double kOnePointFiveDb = 1.41253754462275;
// the noise loudness sets (alpha, thres_fac, s0, nl_min): basic
// (src/movs.c:708-743 as models/basic.py calls it), and the advanced FB
// path's NoiseLoudAsym and its missing components / LinDist (s0 and
// nl_min as models/advanced.py calls them)
constexpr double kBasicAlpha = 1.5, kBasicThres = 0.15, kBasicS0 = 0.5,
                 kBasicMin = 0.0;
constexpr double kAsymAlpha = 2.5, kAsymThres = 0.3, kAsymS0 = 1.0,
                 kAsymMin = 0.1;
constexpr double kMissAlpha = 1.5, kMissThres = 0.15, kMissS0 = 1.0,
                 kMissMin = 0.0;

// M1's parts, the `parts` bits of peaq_band_movs_*
constexpr int kModBasic = 1;    // ModDiff (not rms, lev_wt 100), one nl
constexpr int kModFb = 2;       // ModDiff (rms, lev_wt 1), three nl
constexpr int kLoudness = 4;    // the overall loudness of ref and test
constexpr int kNmr = 8;         // NMR's mean and disturbed flag
constexpr int kProb = 16;       // p_bin and steps_bin per pair
constexpr int kUseFloor = 32;   // floor(e) for the steps, else trunc(e)
constexpr int kSwap = 64;       // swap_mod_patts_for_noise_loudness_movs

__device__ __forceinline__ float pow_t(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_t(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log10_t(float x) { return log10f(x); }
__device__ __forceinline__ double log10_t(double x) { return log10(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float trunc_t(float x) { return truncf(x); }
__device__ __forceinline__ double trunc_t(double x) { return trunc(x); }
__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }

// torch.maximum / torch.amax: a NaN on either side wins
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// torch.clamp_min(x, 0): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp0(T x) {
  return x < T(0) ? T(0) : x;
}

// a thread's place: the block's row (or pair) and frame tile, its lane's
// frame and its band group [lo, hi)
struct Place {
  long long r;
  int fr, lane, g, lo, hi;
  bool live;
};

__device__ __forceinline__ Place place_of(long long blk, int tiles, int z,
                                          int f) {
  Place p;
  p.r = blk / tiles;
  p.lane = threadIdx.x % kLanes;
  p.g = threadIdx.x / kLanes;
  p.fr = static_cast<int>(blk % tiles) * kLanes + p.lane;
  p.live = p.fr < f;
  p.lo = p.g * z / kGroups;
  p.hi = (p.g + 1) * z / kGroups;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
levcorr_kernel(const T* __restrict__ exc_ref, const T* __restrict__ exc_test,
               const T* __restrict__ filt_ref,
               const T* __restrict__ filt_test, int z, int f, int tiles,
               T* __restrict__ lev_out, T* __restrict__ drive_num,
               T* __restrict__ drive_den) {
  __shared__ T s_num[kGroups][kLanes], s_den[kGroups][kLanes];
  __shared__ T s_lev[kLanes];
  const Place at = place_of(blockIdx.x, tiles, z, f);
  const long long base = at.r * z * f + at.fr;
  T num = T(0), den = T(0);
  if (at.live) {
#pragma unroll 4
    for (int b = at.lo; b < at.hi; ++b) {
      const long long i = base + static_cast<long long>(b) * f;
      const T tf = filt_test[i];
      num = num + sqrt_t(filt_ref[i] * tf);
      den = den + tf;
    }
  }
  s_num[at.g][at.lane] = num;
  s_den[at.g][at.lane] = den;
  __syncthreads();
  if (at.g == 0) {
    // num and den summed in one order: for an identical pair num == den
    T n = s_num[0][at.lane], d = s_den[0][at.lane];
    for (int k = 1; k < kGroups; ++k) {
      n = n + s_num[k][at.lane];
      d = d + s_den[k][at.lane];
    }
    const T lev = n * n / (d * d);
    s_lev[at.lane] = lev;
    if (at.live) lev_out[at.r * f + at.fr] = lev;
  }
  __syncthreads();
  if (!at.live) return;
  const T lev = s_lev[at.lane];
  const bool louder = lev > T(1);
#pragma unroll 4
  for (int b = at.lo; b < at.hi; ++b) {
    const long long i = base + static_cast<long long>(b) * f;
    const T er = exc_ref[i], et = exc_test[i];
    const T lr = louder ? er / lev : er;
    const T lt = louder ? et : et * lev;
    drive_num[i] = lt * lr;
    drive_den[i] = lr * lr;
  }
}

// the pattern adaptation factors (ref, test) of band w of a column, 0 past
// the edges
template <typename T>
struct Pair {
  T r, t;
};

template <typename T>
__device__ __forceinline__ Pair<T> pattadapt(const T* __restrict__ num,
                                             const T* __restrict__ den,
                                             long long base, int w, int z,
                                             int f) {
  if (w < 0 || w >= z) return {T(0), T(0)};
  const long long i = base + static_cast<long long>(w) * f;
  const T n = num[i], d = den[i];
  const bool ge = n >= d;
  return {ge ? T(1) : n / d, ge ? d / n : T(1)};
}

// W: the register window, m1c + m2c + 1 bands; each thread walks its band
// group, its window filled first with the bands before the group's first
// (each group forms its halo's factors again, the same bits)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
pattern_adapt_kernel(const T* __restrict__ num, const T* __restrict__ den,
                     const T* __restrict__ a, const T* __restrict__ avg,
                     int z, int f, int tiles, int m1c,
                     T* __restrict__ out_ref, T* __restrict__ out_test) {
  const Place at = place_of(blockIdx.x, tiles, z, f);
  if (!at.live || at.lo == at.hi) return;
  const long long base = at.r * z * f + at.fr;
  // slot s holds band k - m1c + s of the output band k
  Pair<T> win[W];
#pragma unroll
  for (int s = 0; s < W; ++s) {
    win[s] = pattadapt(num, den, base, at.lo - m1c + s, z, f);
  }
  for (int k = at.lo; k < at.hi; ++k) {
    T sr = win[0].r, st = win[0].t;
#pragma unroll
    for (int s = 1; s < W; ++s) {
      sr = sr + win[s].r;
      st = st + win[s].t;
    }
    const T oma = T(1) - a[k];
    const T d = avg[static_cast<long long>(k) * (z + 1)];   // avg[k, k]
    const long long i = base + static_cast<long long>(k) * f;
    out_ref[i] = oma * (d * sr);
    out_test[i] = oma * (d * st);
#pragma unroll
    for (int s = 0; s + 1 < W; ++s) win[s] = win[s + 1];
    win[W - 1] = pattadapt(num, den, base, k + 1 - m1c + W - 1, z, f);
  }
}

// one band's term of the noise loudness, (66)-(68) of BS.1387, as
// models/movs.py::noise_loudness forms it
template <typename T>
__device__ __forceinline__ T nl_term(double alpha, double thres, double s0,
                                     T noise, T mr, T mt, T er, T et) {
  const T sref = static_cast<T>(thres) * mr + static_cast<T>(s0);
  const T stest = static_cast<T>(thres) * mt + static_cast<T>(s0);
  const T beta = exp_t(static_cast<T>(-alpha) * (et - er) / er);
  const T lead = pow_t(noise / stest, T(0.23));
  const T excess = clamp0(stest * et - sref * er);
  return lead * (pow_t(T(1) + excess / (noise + sref * er * beta), T(0.23))
                 - T(1));
}

// the overall loudness's term of one band (src/earmodel.c:890-907)
template <typename T>
__device__ __forceinline__ T loud_term(T e, T one_minus_th, T th, T et,
                                       T lf) {
  return clamp0(lf * (pow_t(one_minus_th + th * e / et, T(0.23)) - T(1)));
}

template <typename T, typename S>
struct MovsArgs {
  const T* exc_ref;
  const T* exc_test;
  const T* lev_corr;
  const T* pc_ref;
  const T* pc_test;
  const T* mod_ref;
  const T* mod_test;
  const T* avg_loud;
  const S* noise;           // [rows, F, Z]
  const T* internal_noise;
  const T* loudness_factor;
  const T* threshold;
  const T* exc_threshold;
  const T* masking_difference;
  T lev_wt, md1_scale, md2_scale, nl_scale;
  long long rows;
  int channels, z, f, tiles, parts;
  T* terms;                 // [n_terms, rows, F]
  T* loud;                  // [2, rows, F]
  S* nmr;                   // [2, rows, F]
  T* pd;                    // [2, rows / channels, F]
};

// the row terms' partial sums of a band group, in the order they are
// written and added: md1, md2, temp_wt, three nl sets, the two loudnesses
constexpr int kRowSums = 8;
// M1's shared memory, one buffer of 8-byte slots laid out twice: during the
// band walk NMR's noise tile [32][kNmrTile + 1] and the per-band constants
// s_tw, s_noise [kMaxBands] each; after it the groups' partial sums
constexpr int kNmrSlots = kLanes * (kNmrTile + 1);
constexpr int kRawSlots = kNmrSlots + 2 * kMaxBands;
static_assert((kRowSums + 2) * kGroups * kLanes <= kNmrSlots,
              "the partial sums fit in the noise tile's slots");

// a column's row terms: ModDiff, TempWt, the noise loudness, the loudness
// and NMR, over the thread's band group; the groups' partial sums are
// added in group order by warp 0, which writes the terms.  Every thread of
// the block reaches its barriers.
template <typename T, typename S>
__device__ void row_terms(const MovsArgs<T, S>& p, long long blk,
                          double* raw) {
  // during the walk
  auto s_nb = reinterpret_cast<S(*)[kNmrTile + 1]>(raw);   // [frame][band]
  T* s_tw = reinterpret_cast<T*>(raw + kNmrSlots);
  T* s_noise = reinterpret_cast<T*>(raw + kNmrSlots + kMaxBands);
  // after it
  auto s_sum = reinterpret_cast<T(*)[kGroups][kLanes]>(raw);
  auto s_nsum = reinterpret_cast<S(*)[kLanes]>(raw + kRowSums * kGroups
                                                * kLanes);
  auto s_nmax = reinterpret_cast<S(*)[kLanes]>(raw + (kRowSums + 1)
                                                * kGroups * kLanes);
  const int z = p.z, f = p.f;
  const Place at = place_of(blk, p.tiles, z, f);
  const bool mods = p.parts & (kModBasic | kModFb);
  const bool fb = p.parts & kModFb;
  const bool loudness = p.parts & kLoudness;
  const bool nmr = p.parts & kNmr;
  const bool swap = p.parts & kSwap;
  const bool staged = nmr && z <= kNmrTile;
  const long long f0 = at.r * f + (at.fr - at.lane);   // the tile's frame 0
  const int frames = min(kLanes, f - static_cast<int>(f0 - at.r * f));
  if (mods) {
    for (int b = threadIdx.x; b < z; b += kThreads) {
      const T n = p.internal_noise[b];
      s_noise[b] = n;
      s_tw[b] = p.lev_wt * pow_t(n, T(0.3));
    }
  }
  if (staged) {
    // the tile noise[r, f0 .. f0 + frames - 1, 0 .. z - 1], contiguous
    const S* src = p.noise + f0 * z;
    for (int e = threadIdx.x; e < frames * z; e += kThreads) {
      const int i = e / z;
      s_nb[i][e - i * z] = src[e];
    }
  }
  __syncthreads();
  const long long base = at.r * z * f + at.fr;
  T lev = T(1);
  if (at.live && mods) lev = p.lev_corr[at.r * f + at.fr];
  const bool louder = lev > T(1);
  T sum[kRowSums];
#pragma unroll
  for (int k = 0; k < kRowSums; ++k) sum[k] = T(0);
  S nsum = S(0), nmax = -S(INFINITY);
  if (at.live) {
#pragma unroll 2
    for (int b = at.lo; b < at.hi; ++b) {
      const long long i = base + static_cast<long long>(b) * f;
      const T er = p.exc_ref[i];
      if (mods) {
        const T et = p.exc_test[i];
        const T mr = p.mod_ref[i], mt = p.mod_test[i];
        const T diff = abs_t(mr - mt);
        sum[0] = sum[0] + diff / (T(1) + mr);
        const T w = mt >= mr ? T(1) : T(0.1);
        sum[1] = sum[1] + w * diff / (T(0.01) + mr);
        const T al = p.avg_loud[i];
        sum[2] = sum[2] + al / (al + s_tw[b]);
        const T ar = (louder ? er / lev : er) * p.pc_ref[i];
        const T at_ = (louder ? et : et * lev) * p.pc_test[i];
        const T n = s_noise[b];
        if (fb) {
          sum[3] = sum[3] + nl_term(kAsymAlpha, kAsymThres, kAsymS0, n, mr,
                                    mt, ar, at_);
          sum[4] = sum[4] + (swap ? nl_term(kMissAlpha, kMissThres, kMissS0,
                                            n, mt, mr, at_, ar)
                                  : nl_term(kMissAlpha, kMissThres, kMissS0,
                                            n, mr, mt, at_, ar));
          sum[5] = sum[5] + (swap ? nl_term(kMissAlpha, kMissThres, kMissS0,
                                            n, mr, mr, ar, er)
                                  : nl_term(kMissAlpha, kMissThres, kMissS0,
                                            n, mr, mt, ar, er));
        } else {
          sum[3] = sum[3] + nl_term(kBasicAlpha, kBasicThres, kBasicS0, n,
                                    mr, mt, ar, at_);
        }
      }
      if (loudness) {
        const T th = p.threshold[b], et_ = p.exc_threshold[b];
        const T lf = p.loudness_factor[b];
        sum[6] = sum[6] + loud_term(er, T(1) - th, th, et_, lf);
        sum[7] = sum[7] + loud_term(p.exc_test[i], T(1) - th, th, et_, lf);
      }
      if (nmr) {
        const S noise = staged ? s_nb[at.lane][b]
                               : p.noise[(at.r * f + at.fr) * z + b];
        const S v = noise / static_cast<S>(er / p.masking_difference[b]);
        nsum = nsum + v;
        nmax = max_nan(nmax, v);
      }
    }
  }
  __syncthreads();                         // the walk's buffer is free
#pragma unroll
  for (int k = 0; k < kRowSums; ++k) s_sum[k][at.g][at.lane] = sum[k];
  s_nsum[at.g][at.lane] = nsum;
  s_nmax[at.g][at.lane] = nmax;
  __syncthreads();
  if (at.g != 0 || !at.live) return;
#pragma unroll
  for (int k = 0; k < kRowSums; ++k) {
    for (int g = 1; g < kGroups; ++g) sum[k] = sum[k] + s_sum[k][g][at.lane];
  }
  for (int g = 1; g < kGroups; ++g) {
    nsum = nsum + s_nsum[g][at.lane];
    nmax = max_nan(nmax, s_nmax[g][at.lane]);
  }
  const long long o = at.r * f + at.fr;
  const long long plane = p.rows * f;
  if (mods) {
    p.terms[o] = sum[0] * p.md1_scale;
    p.terms[plane + o] = sum[1] * p.md2_scale;
    p.terms[2 * plane + o] = sum[2];
    const T nl = sum[3] * p.nl_scale;
    const T nl_min = static_cast<T>(fb ? kAsymMin : kBasicMin);
    p.terms[3 * plane + o] = nl < nl_min ? T(0) : nl;
    if (fb) {
      const T missing = sum[4] * p.nl_scale, lin_dist = sum[5] * p.nl_scale;
      p.terms[4 * plane + o] =
          missing < static_cast<T>(kMissMin) ? T(0) : missing;
      p.terms[5 * plane + o] =
          lin_dist < static_cast<T>(kMissMin) ? T(0) : lin_dist;
    }
  }
  if (loudness) {
    p.loud[o] = sum[6] * p.nl_scale;
    p.loud[plane + o] = sum[7] * p.nl_scale;
  }
  if (nmr) {
    p.nmr[o] = nsum / static_cast<S>(z);
    p.nmr[plane + o] = nmax > static_cast<S>(kOnePointFiveDb) ? S(1) : S(0);
  }
}

// a pair's column: the binaural detection probability and steps
// (src/movs.c:1223-1276) over the thread's band group, the maximum over
// channels in channel order; warp 0 multiplies the groups' products of
// (1 - p_band) and adds their sums of q_band in group order.  CH > 0: the
// pair's channels at compile time, 0: p.channels.
template <int CH, typename T, typename S>
__device__ void pair_terms(const MovsArgs<T, S>& p, long long blk,
                           double* raw) {
  auto s_prod = reinterpret_cast<T(*)[kLanes]>(raw);
  auto s_steps = reinterpret_cast<T(*)[kLanes]>(raw + kGroups * kLanes);
  const int z = p.z, f = p.f, ch = CH > 0 ? CH : p.channels;
  const Place at = place_of(blk, p.tiles, z, f);
  const long long q = at.r;
  const bool use_floor = p.parts & kUseFloor;
  T prod = T(1), steps = T(0);
  if (at.live) {
#pragma unroll 2
    for (int b = at.lo; b < at.hi; ++b) {
      T pmax = T(0), qmax = T(0);
#pragma unroll
      for (int c = 0; c < ch; ++c) {
        const long long i =
            ((q * ch + c) * z + b) * static_cast<long long>(f) + at.fr;
        const T eref_db = T(10) * log10_t(p.exc_ref[i]);
        const T etest_db = T(10) * log10_t(p.exc_test[i]);
        const T l = T(0.3) * max_nan(eref_db, etest_db) + T(0.7) * etest_db;
        const bool audible = l > T(0);
        const T ls = audible ? l : T(1);
        const T s = audible
            ? static_cast<T>(kPdS0) * pow_t(static_cast<T>(kPdS1) / ls,
                                            static_cast<T>(kPdS2))
                + static_cast<T>(kPdS3) * pow_t(ls, T(4))
                + static_cast<T>(kPdS4) * (ls * ls * ls)
                - static_cast<T>(kPdS5) * ls * ls
                + static_cast<T>(kPdS6) * ls - static_cast<T>(kPdS7)
            : T(1e30);
        const T e = eref_db - etest_db;
        const T t = e / s;
        const T t2 = t * t;
        const T t4 = t2 * t2;
        const T tb = eref_db > etest_db ? t4 : t4 * t2;
        const T pc = T(1) - pow_t(T(0.5), tb);
        const T qc = abs_t(use_floor ? floor_t(e) : trunc_t(e)) / s;
        pmax = c == 0 ? pc : max_nan(pmax, pc);
        qmax = c == 0 ? qc : max_nan(qmax, qc);
      }
      prod = prod * (T(1) - pmax);
      steps = steps + qmax;
    }
  }
  s_prod[at.g][at.lane] = prod;
  s_steps[at.g][at.lane] = steps;
  __syncthreads();
  if (at.g != 0 || !at.live) return;
  for (int g = 1; g < kGroups; ++g) {
    prod = prod * s_prod[g][at.lane];
    steps = steps + s_steps[g][at.lane];
  }
  const long long pairs = p.rows / ch;
  const long long o = q * f + at.fr;
  p.pd[o] = T(1) - prod;
  p.pd[pairs * f + o] = steps;
}

// blocks [0, row_blocks): the rows' tiles; after them the pairs'
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
band_movs_kernel(MovsArgs<T, S> p, long long row_blocks) {
  __shared__ double raw[kRawSlots];
  const long long blk = blockIdx.x;
  if (blk < row_blocks) {
    row_terms(p, blk, raw);
  } else if (p.channels == 2) {
    pair_terms<2>(p, blk - row_blocks, raw);
  } else if (p.channels == 1) {
    pair_terms<1>(p, blk - row_blocks, raw);
  } else {
    pair_terms<0>(p, blk - row_blocks, raw);
  }
}

long long tiles_of(int f) { return (f + kLanes - 1) / kLanes; }

template <typename T>
int launch_levcorr(const void* exc2, const void* filt2, long long rows,
                   int z, int f, void* lev, void* drive, void* stream) {
  const long long tiles = tiles_of(f);
  if (rows < 0 || z < 1 || f < 0 || (f > 0 && rows > INT_MAX / tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && f > 0) {
    const long long band = rows * z * f;
    const T* e = static_cast<const T*>(exc2);
    const T* p = static_cast<const T*>(filt2);
    T* d = static_cast<T*>(drive);
    levcorr_kernel<T><<<static_cast<unsigned>(rows * tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        e, e + band, p, p + band, z, f, static_cast<int>(tiles),
        static_cast<T*>(lev), d, d + band);
  }
  return static_cast<int>(cudaGetLastError());
}

// L2 at its exact window W = m1c + m2c + 1, found from 1 up
template <typename T, int W>
void pattern_adapt_w(int width, const T* nd, const T* a, const T* avg,
                     long long rows, int z, int f, int m1c, T* out,
                     cudaStream_t s) {
  if constexpr (W < kMaxWindow) {
    if (width > W) {
      pattern_adapt_w<T, W + 1>(width, nd, a, avg, rows, z, f, m1c, out, s);
      return;
    }
  }
  const long long tiles = tiles_of(f);
  const long long band = rows * z * f;
  pattern_adapt_kernel<T, W><<<static_cast<unsigned>(rows * tiles),
                               kThreads, 0, s>>>(
      nd, nd + band, a, avg, z, f, static_cast<int>(tiles), m1c, out,
      out + band);
}

template <typename T>
int launch_pattern_adapt(const void* nd, const void* a, const void* avg,
                         long long rows, int z, int f, int m1c, int m2c,
                         void* out, void* stream) {
  const long long tiles = tiles_of(f);
  const int width = m1c + m2c + 1;
  if (rows < 0 || z < 1 || f < 0 || m1c < 0 || m2c < 0
      || width > kMaxWindow || (f > 0 && rows > INT_MAX / tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && f > 0) {
    pattern_adapt_w<T, 1>(width, static_cast<const T*>(nd),
                          static_cast<const T*>(a),
                          static_cast<const T*>(avg), rows, z, f, m1c,
                          static_cast<T*>(out),
                          static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_band_movs(const void* const* in, const void* const* consts,
                     const double* scalars, long long rows, int channels,
                     int z, int f, int parts, void* terms, void* loud,
                     void* nmr, void* pd, void* stream) {
  const long long tiles = tiles_of(f);
  const bool row_parts = parts & (kModBasic | kModFb | kLoudness | kNmr);
  const bool prob = parts & kProb;
  if (rows < 0 || channels < 1 || rows % channels || z < 1
      || z > kMaxBands || f < 0
      || (f > 0 && rows > (INT_MAX / tiles) / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && f > 0 && (row_parts || prob)) {
    MovsArgs<T, S> p;
    p.exc_ref = static_cast<const T*>(in[0]);
    p.exc_test = static_cast<const T*>(in[1]);
    p.lev_corr = static_cast<const T*>(in[2]);
    p.pc_ref = static_cast<const T*>(in[3]);
    p.pc_test = static_cast<const T*>(in[4]);
    p.mod_ref = static_cast<const T*>(in[5]);
    p.mod_test = static_cast<const T*>(in[6]);
    p.avg_loud = static_cast<const T*>(in[7]);
    p.noise = static_cast<const S*>(in[8]);
    p.internal_noise = static_cast<const T*>(consts[0]);
    p.loudness_factor = static_cast<const T*>(consts[1]);
    p.threshold = static_cast<const T*>(consts[2]);
    p.exc_threshold = static_cast<const T*>(consts[3]);
    p.masking_difference = static_cast<const T*>(consts[4]);
    p.lev_wt = static_cast<T>(scalars[0]);
    p.md1_scale = static_cast<T>(scalars[1]);
    p.md2_scale = static_cast<T>(scalars[2]);
    p.nl_scale = static_cast<T>(scalars[3]);
    p.rows = rows;
    p.channels = channels;
    p.z = z;
    p.f = f;
    p.tiles = static_cast<int>(tiles);
    p.parts = parts;
    p.terms = static_cast<T*>(terms);
    p.loud = static_cast<T*>(loud);
    p.nmr = static_cast<S*>(nmr);
    p.pd = static_cast<T*>(pd);
    const long long row_blocks = row_parts ? rows * tiles : 0;
    const long long blocks = row_blocks + (prob ? rows / channels * tiles : 0);
    band_movs_kernel<T, S><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        p, row_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// Every tensor is contiguous; rows is the product of the lead axes.
// levcorr: exc2, filt2 [2][rows][z][f] (ref, test); lev [rows][f]; drive
// [2][rows][z][f] (num, den).
int peaq_levcorr_f32(const void* exc2, const void* filt2, long long rows,
                     int z, int f, void* lev, void* drive, void* stream) {
  return launch_levcorr<float>(exc2, filt2, rows, z, f, lev, drive, stream);
}

int peaq_levcorr_f64(const void* exc2, const void* filt2, long long rows,
                     int z, int f, void* lev, void* drive, void* stream) {
  return launch_levcorr<double>(exc2, filt2, rows, z, f, lev, drive, stream);
}

// pattern_adapt: nd [2][rows][z][f] (num, den smoothers); a [z]; avg the
// [z][z] band-average matrix (its diagonal read); m1c = z / 36, m2c =
// z / 25; out [2][rows][z][f] (ref, test).
int peaq_pattern_adapt_f32(const void* nd, const void* a, const void* avg,
                           long long rows, int z, int f, int m1c, int m2c,
                           void* out, void* stream) {
  return launch_pattern_adapt<float>(nd, a, avg, rows, z, f, m1c, m2c, out,
                                     stream);
}

int peaq_pattern_adapt_f64(const void* nd, const void* a, const void* avg,
                           long long rows, int z, int f, int m1c, int m2c,
                           void* out, void* stream) {
  return launch_pattern_adapt<double>(nd, a, avg, rows, z, f, m1c, m2c, out,
                                      stream);
}

// band_movs: in[9] = exc_ref, exc_test, lev_corr [rows][f], pc_ref,
// pc_test, mod_ref, mod_test, avg_loud (each [rows][z][f], T), noise
// [rows][f][z] (S: double where noise_double, else float); consts[5] =
// internal_noise, loudness_factor, threshold, excitation_threshold,
// masking_difference [z]; scalars[4] = lev_wt, md1_scale, md2_scale,
// nl_scale (24 / z); parts: the k* bits; terms [3 + 1 or 3][rows][f]
// (md1, md2, temp_wt, nl...), loud [2][rows][f], nmr [2][rows][f] of S,
// pd [2][rows / channels][f].  A pointer a part does not read may be null.
int peaq_band_movs_f32(const void* const* in, const void* const* consts,
                       const double* scalars, long long rows, int channels,
                       int z, int f, int parts, int noise_double,
                       void* terms, void* loud, void* nmr, void* pd,
                       void* stream) {
  if (noise_double) {
    return launch_band_movs<float, double>(in, consts, scalars, rows,
                                           channels, z, f, parts, terms,
                                           loud, nmr, pd, stream);
  }
  return launch_band_movs<float, float>(in, consts, scalars, rows, channels,
                                        z, f, parts, terms, loud, nmr, pd,
                                        stream);
}

int peaq_band_movs_f64(const void* const* in, const void* const* consts,
                       const double* scalars, long long rows, int channels,
                       int z, int f, int parts, int noise_double,
                       void* terms, void* loud, void* nmr, void* pd,
                       void* stream) {
  if (!noise_double) return static_cast<int>(cudaErrorInvalidValue);
  return launch_band_movs<double, double>(in, consts, scalars, rows,
                                          channels, z, f, parts, terms, loud,
                                          nmr, pd, stream);
}

}  // extern "C"
