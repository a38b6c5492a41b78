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
//   per band, which lies [rows, F, Z]; and per pair and frame the binaural
//   detection probability and steps: the maximum over channels inside the
//   kernel, the product of (1 - p_band) and the sum of q_band in the fixed
//   order.  Where the pairs' tiles fill the card, a pair of one or two
//   channels is one tile (its rows), so each excitation is read once for
//   the row terms and the detection; on smaller grids (one pair, a chunk
//   step), and for pairs of other channel counts, the pairs' detection
//   takes blocks of its own after the rows' tiles, reading the excitations
//   again.  Each thread copies its next band's inputs to shared memory with
//   cp.async while it computes this band's, and reads only what it copied
//   (no barrier in the walk); NMR alone in float reads its two inputs in
//   place.
//
// What bounds them on the H100.  L1 and L2: bytes.  At the basic float64
// batch ([64, 2, 109, 512], 57 MB a band tensor) L1 reads four and writes
// two (343 MB, 0.10 ms at 3.35 TB/s), L2 reads two and writes two (229
// MB).  M1 reads six there (343 MB, 0.10 ms), and in double its library
// calls bound it: per band element of a row 5 pow, 1 exp, 1 exp2, 2 log10
// and 11 quotients at the basic site, 7 pow, 3 exp and 12 quotients at the
// FB site (M1_CALLS in chip_smoke.py, which times each call's
// rate on the card for M1's math floor).
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
// (pow(x, 0.23) for ** 0.23, l l l for l ** 3); the even powers t^4 /
// t^4 t^2 of the detection probability are products, never a pow of a
// negative base.  Where no decision reads a value M1 forms it with less
// work, within 1e-14 of the plain forms (tests/test_torch_band.py): l ** 4
// as (l l)(l l), 0.5 ** tb as exp2(-tb), e / s and trunc(e) / s through 1 /
// s, the loudness's th e / et as e (th / et); the FB site's missing
// components and LinDist share their lead (noise / s_test)^0.23, the same
// bits.  Band sums run in the fixed order above, where torch's reductions
// take an order of their own: kernel and plain agree to rounding there.
// float32 computes in float and float64 in double; NMR's terms in the
// spectrum type S of the noise (S >= T).  Offsets are 64-bit.

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
constexpr int kMaxBands = 256;    // M1's bands (its per-band constants)
constexpr int kMaxWindow = 16;    // L2's band-average window, bands

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
__device__ __forceinline__ float exp2_t(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_t(double x) { return exp2(x); }
__device__ __forceinline__ float log10_t(float x) { return log10f(x); }
__device__ __forceinline__ double log10_t(double x) { return log10(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }
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
// models/movs.py::noise_loudness forms it, from its lead factor
// (noise / s_test)^0.23 (nl_lead)
template <typename T>
__device__ __forceinline__ T nl_lead(double thres, double s0, T noise,
                                     T mt) {
  return pow_t(noise / (static_cast<T>(thres) * mt + static_cast<T>(s0)),
               T(0.23));
}

template <typename T>
__device__ __forceinline__ T nl_term(double alpha, double thres, double s0,
                                     T lead, T noise, T mr, T mt, T er,
                                     T et) {
  const T sref = static_cast<T>(thres) * mr + static_cast<T>(s0);
  const T stest = static_cast<T>(thres) * mt + static_cast<T>(s0);
  const T beta = exp_t(static_cast<T>(-alpha) * (et - er) / er);
  const T excess = clamp0(stest * et - sref * er);
  return lead * (pow_t(T(1) + excess / (noise + sref * er * beta), T(0.23))
                 - T(1));
}

// the overall loudness's term of one band (src/earmodel.c:890-907),
// (1 - th) + th e / et with th / et taken once a band (tde): no quotient a
// band element
template <typename T>
__device__ __forceinline__ T loud_term(T e, T omt, T tde, T lf) {
  return clamp0(lf * (pow_t(omt + e * tde, T(0.23)) - T(1)));
}

// a channel's terms of the binaural detection probability and steps in one
// band (src/movs.c:1223-1276): p = 1 - 0.5^(t^4 or t^6), q = |trunc(e)| /
// s.  l > 0 and trunc / floor(e) read the two log10 as the plain version
// forms them; where no decision reads a value it is formed with less work:
// l^4 = (l l)(l l), 0.5^tb = exp2(-tb), and e / s, trunc(e) / s through
// one 1 / s.
template <typename T>
struct Detect {
  T p, q;
};

template <typename T>
__device__ __forceinline__ Detect<T> detect(T er, T et, bool use_floor) {
  const T eref_db = T(10) * log10_t(er);
  const T etest_db = T(10) * log10_t(et);
  const T l = T(0.3) * max_nan(eref_db, etest_db) + T(0.7) * etest_db;
  const bool audible = l > T(0);
  const T ls = audible ? l : T(1);
  const T l2 = ls * ls;
  const T s = audible
      ? static_cast<T>(kPdS0) * pow_t(static_cast<T>(kPdS1) / ls,
                                      static_cast<T>(kPdS2))
          + static_cast<T>(kPdS3) * (l2 * l2)
          + static_cast<T>(kPdS4) * (l2 * ls)
          - static_cast<T>(kPdS5) * ls * ls
          + static_cast<T>(kPdS6) * ls - static_cast<T>(kPdS7)
      : T(1e30);
  const T e = eref_db - etest_db;
  const T rs = T(1) / s;
  const T t = e * rs;
  const T t2 = t * t;
  const T t4 = t2 * t2;
  const T tb = eref_db > etest_db ? t4 : t4 * t2;
  return {T(1) - exp2_t(-tb),
          abs_t(use_floor ? floor_t(e) : trunc_t(e)) * rs};
}

// M1's band inputs of a row, in the order of MovsArgs::in: the excitations
// (ref, test), then, with ModDiff, pc (ref, test), the modulations (ref,
// test) and the reference's average loudness
constexpr int kIns = 7;

template <typename T, typename S>
struct MovsArgs {
  const T* in[kIns];        // each [rows, z, f]
  const T* lev_corr;        // [rows, f]
  const S* noise;           // [rows, f, z]
  const T* internal_noise;
  const T* loudness_factor;
  const T* threshold;
  const T* exc_threshold;
  const T* masking_difference;
  T lev_wt, md1_scale, md2_scale, nl_scale;
  long long rows;
  int channels, z, f, tiles, parts;
  bool fused;               // the tile's rows are a pair's channels, and
                            // the pair's detection is formed with them
  T* terms;                 // [n_terms, rows, F]
  T* loud;                  // [2, rows, F]
  S* nmr;                   // [2, rows, F]
  T* pd;                    // [2, rows / channels, F]
};

// a row's partial sums of a band group, in the order they are written and
// added: md1, md2, temp_wt, three nl sets, the two loudnesses (type T);
// NMR's sum and maximum (type S)
constexpr int kRowSums = 8;
// a thread's ring of staged bands: the band it computes and the next one;
// NMR alone in float (two quotients a band) reads its band in place
// (kDirect: no ring), which an H100 ran 14% faster there at the batch, and
// in double 13-15% slower
constexpr int kStages = 2;
constexpr int kDirect = 0;
// M1's per-band constants in shared memory: the internal noise, TempWt's
// lev_wt n^0.3, 1 - th and th / et of the loudness, its factor, NMR's
// masking difference
constexpr int kConsts = 6;

// M1's dynamic shared memory of a tile of R rows with a ring of `stages`,
// in 8-byte words: the ring (a thread's copies of its band: `ins` values of
// type T and NMR's noise of type S a row and stage; every thread reads only
// what it copied), after the walk the partial sums over it (a thread's R
// kRowSums and the detection's product and sum of type T, then 2 R of type
// S), then the per-band constants.  NMR's noise lies [rows, F, Z], so a
// thread's copies of it read a 32-byte sector for 4 or 8 bytes, the next
// bands of its frame then hitting L1; a block-wide coalesced tile of it,
// tried on an H100, was slower at every site.
struct Layout {
  long long ring_s, part_s, consts, words;
};

__host__ __device__ inline long long words_of(long long values, int size) {
  return (values * size + 7) / 8;
}

__host__ __device__ inline Layout layout_of(int r, int stages, int ins,
                                            bool nmr, int z, int t_size,
                                            int s_size) {
  Layout l;
  l.ring_s = words_of(1LL * stages * r * ins * kThreads, t_size);
  const long long ring =
      l.ring_s + (nmr ? words_of(1LL * stages * r * kThreads, s_size) : 0);
  l.part_s = words_of(1LL * (r * kRowSums + 2) * kThreads, t_size);
  const long long part = l.part_s + words_of(2LL * r * kThreads, s_size);
  l.consts = ring > part ? ring : part;
  l.words = l.consts + words_of(1LL * kConsts * z, t_size);
  return l;
}

// the ins a tile stages a row: all seven with ModDiff, the two excitations
// for the loudness or the detection, else the reference's (NMR alone)
__host__ __device__ inline int ins_of(int parts, bool detection) {
  if (parts & (kModBasic | kModFb)) return kIns;
  return (parts & kLoudness) || detection ? 2 : 1;
}

// an asynchronous copy of one element to shared memory (cp.async, cached
// in L1); where `valid` is false nothing is read and the slot takes zero
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src,
                                           bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to),
               "l"(src), "n"(sizeof(V)), "r"(valid ? int(sizeof(V)) : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until every copy group of this thread but the newest `pending`
// has landed
template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// A tile: 32 frames of R rows, the 8 band groups a warp each.  Thread (g,
// lane) walks its group's bands in ascending order for frame f0 + lane of
// every row, keeping its partial sums in registers: each row's terms
// (ModDiff, TempWt, the noise loudness, the loudness, NMR) and, where the
// tile is a pair (p.fused), the pair's detection from the same staged
// excitations, the maximum over channels taken in channel order.  Bands k
// + 1 .. k + STAGES - 1 are copied asynchronously while band k is computed
// (STAGES = kDirect: each band is read in place).  Then warp 0 adds the
// groups' partials in group order and writes the terms.  Every thread of
// the block reaches its barriers.
template <int R, bool FB, int STAGES, typename T, typename S>
__device__ void tile_terms(const MovsArgs<T, S>& p, long long blk,
                           double* smem) {
  const int z = p.z, f = p.f, tid = threadIdx.x;
  const int lane = tid % kLanes, g = tid / kLanes;
  const long long r0 = blk / p.tiles * R;        // the tile's first row
  const int fr = static_cast<int>(blk % p.tiles) * kLanes + lane;
  const bool live = fr < f;
  const int frc = live ? fr : 0;                 // a frame that exists
  const int lo = g * z / kGroups, hi = (g + 1) * z / kGroups;
  const int steps = (z + kGroups - 1) / kGroups;
  const bool mods = p.parts & (kModBasic | kModFb);
  const bool loudness = p.parts & kLoudness;
  const bool nmr = p.parts & kNmr;
  const bool swap = p.parts & kSwap;
  const bool use_floor = p.parts & kUseFloor;
  const bool prob = p.fused;
  const int ins = ins_of(p.parts, prob);
  const Layout lay =
      layout_of(R, STAGES, ins, nmr, z, sizeof(T), sizeof(S));
  T* ring = reinterpret_cast<T*>(smem);          // [stage][row][in][thread]
  S* ring_s = reinterpret_cast<S*>(smem + lay.ring_s);   // [stage][row][t]
  T* s_c = reinterpret_cast<T*>(smem + lay.consts);      // [kConsts][z]
  constexpr int slots = STAGES == kDirect ? 1 : STAGES;

  // stage band lo + k of every row in ring slot k % STAGES
  auto stage = [&](int k) {
    const int b = lo + k;
    if (STAGES == kDirect || b >= hi) return;
    const int slot = k % slots;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const long long r = r0 + c;
      const long long i = (r * z + b) * static_cast<long long>(f) + frc;
      T* dst = ring + ((slot * R + c) * ins) * kThreads + tid;
#pragma unroll
      for (int s = 0; s < kIns; ++s) {
        if (s < ins) copy_async(dst + s * kThreads, p.in[s] + i, live);
      }
      if (nmr) {
        copy_async(ring_s + (slot * R + c) * kThreads + tid,
                   p.noise + (r * f + frc) * static_cast<long long>(z) + b,
                   live);
      }
    }
  };
#pragma unroll
  for (int k = 0; k + 1 < STAGES; ++k) {
    stage(k);
    copy_commit();
  }
  for (int b = tid; b < z; b += kThreads) {
    if (mods) {
      const T n = p.internal_noise[b];
      s_c[b] = n;
      s_c[z + b] = p.lev_wt * pow_t(n, T(0.3));
    }
    if (loudness) {
      const T th = p.threshold[b];
      s_c[2 * z + b] = T(1) - th;
      s_c[3 * z + b] = th / p.exc_threshold[b];
      s_c[4 * z + b] = p.loudness_factor[b];
    }
    if (nmr) s_c[5 * z + b] = p.masking_difference[b];
  }
  __syncthreads();

  T lev[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    lev[c] = mods ? p.lev_corr[(r0 + c) * f + frc] : T(1);
  }
  T sum[R][kRowSums];
  S nsum[R], nmax[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
#pragma unroll
    for (int k = 0; k < kRowSums; ++k) sum[c][k] = T(0);
    nsum[c] = S(0);
    nmax[c] = -S(INFINITY);
  }
  T prod = T(1), steps_sum = T(0);
  for (int k = 0; k < steps; ++k) {
    if constexpr (STAGES != kDirect) {
      stage(k + STAGES - 1);
      copy_commit();
      copy_wait<STAGES - 1>();
    }
    const int b = lo + k;
    if (b >= hi || !live) continue;
    const int slot = k % slots;
    T pmax = T(0), qmax = T(0);
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const T* v = ring + ((slot * R + c) * ins) * kThreads + tid;
      const long long i = ((r0 + c) * z + b) * static_cast<long long>(f) + fr;
      // input s of this band: staged, or in place
      auto in = [&](int s) {
        return STAGES == kDirect ? p.in[s][i] : v[s * kThreads];
      };
      const T er = in(0);
      const T et = ins > 1 ? in(1) : T(0);
      if (mods) {
        const T pcr = in(2), pct = in(3);
        const T mr = in(4), mt = in(5);
        const T al = in(6);
        const T diff = abs_t(mr - mt);
        sum[c][0] = sum[c][0] + diff / (T(1) + mr);
        const T w = mt >= mr ? T(1) : T(0.1);
        sum[c][1] = sum[c][1] + w * diff / (T(0.01) + mr);
        sum[c][2] = sum[c][2] + al / (al + s_c[z + b]);
        const bool louder = lev[c] > T(1);
        const T ar = (louder ? er / lev[c] : er) * pcr;
        const T at = (louder ? et : et * lev[c]) * pct;
        const T n = s_c[b];
        if constexpr (FB) {
          sum[c][3] = sum[c][3]
              + nl_term(kAsymAlpha, kAsymThres, kAsymS0,
                        nl_lead(kAsymThres, kAsymS0, n, mt), n, mr, mt, ar,
                        at);
          // the missing components and LinDist share s_test, so their
          // lead factor is one
          const T lead = nl_lead(kMissThres, kMissS0, n, swap ? mr : mt);
          sum[c][4] = sum[c][4]
              + (swap ? nl_term(kMissAlpha, kMissThres, kMissS0, lead, n,
                                mt, mr, at, ar)
                      : nl_term(kMissAlpha, kMissThres, kMissS0, lead, n,
                                mr, mt, at, ar));
          sum[c][5] = sum[c][5]
              + (swap ? nl_term(kMissAlpha, kMissThres, kMissS0, lead, n,
                                mr, mr, ar, er)
                      : nl_term(kMissAlpha, kMissThres, kMissS0, lead, n,
                                mr, mt, ar, er));
        } else {
          sum[c][3] = sum[c][3]
              + nl_term(kBasicAlpha, kBasicThres, kBasicS0,
                        nl_lead(kBasicThres, kBasicS0, n, mt), n, mr, mt, ar,
                        at);
        }
      }
      if (loudness) {
        const T omt = s_c[2 * z + b], tde = s_c[3 * z + b];
        const T lf = s_c[4 * z + b];
        sum[c][6] = sum[c][6] + loud_term(er, omt, tde, lf);
        sum[c][7] = sum[c][7] + loud_term(et, omt, tde, lf);
      }
      if (nmr) {
        const S noise = STAGES == kDirect
            ? p.noise[((r0 + c) * f + fr) * static_cast<long long>(z) + b]
            : ring_s[(slot * R + c) * kThreads + tid];
        const S q = noise / static_cast<S>(er / s_c[5 * z + b]);
        nsum[c] = nsum[c] + q;
        nmax[c] = max_nan(nmax[c], q);
      }
      if (prob) {
        const Detect<T> d = detect(er, et, use_floor);
        pmax = c == 0 ? d.p : max_nan(pmax, d.p);
        qmax = c == 0 ? d.q : max_nan(qmax, d.q);
      }
    }
    if (prob) {
      prod = prod * (T(1) - pmax);
      steps_sum = steps_sum + qmax;
    }
  }
  __syncthreads();                               // the ring is free
  T* part = reinterpret_cast<T*>(smem);          // [value][thread]
  S* part_s = reinterpret_cast<S*>(smem + lay.part_s);
#pragma unroll
  for (int c = 0; c < R; ++c) {
#pragma unroll
    for (int k = 0; k < kRowSums; ++k) {
      part[(c * kRowSums + k) * kThreads + tid] = sum[c][k];
    }
    part_s[2 * c * kThreads + tid] = nsum[c];
    part_s[(2 * c + 1) * kThreads + tid] = nmax[c];
  }
  part[R * kRowSums * kThreads + tid] = prod;
  part[(R * kRowSums + 1) * kThreads + tid] = steps_sum;
  __syncthreads();
  if (g != 0 || !live) return;
  const long long plane = p.rows * f;
#pragma unroll
  for (int c = 0; c < R; ++c) {
    for (int h = 1; h < kGroups; ++h) {
      const int ix = h * kLanes + lane;
#pragma unroll
      for (int k = 0; k < kRowSums; ++k) {
        sum[c][k] = sum[c][k] + part[(c * kRowSums + k) * kThreads + ix];
      }
      nsum[c] = nsum[c] + part_s[2 * c * kThreads + ix];
      nmax[c] = max_nan(nmax[c], part_s[(2 * c + 1) * kThreads + ix]);
    }
    const long long o = (r0 + c) * f + fr;
    if (mods) {
      p.terms[o] = sum[c][0] * p.md1_scale;
      p.terms[plane + o] = sum[c][1] * p.md2_scale;
      p.terms[2 * plane + o] = sum[c][2];
      const T nl = sum[c][3] * p.nl_scale;
      const T nl_min = static_cast<T>(FB ? kAsymMin : kBasicMin);
      p.terms[3 * plane + o] = nl < nl_min ? T(0) : nl;
      if constexpr (FB) {
        const T missing = sum[c][4] * p.nl_scale;
        const T lin_dist = sum[c][5] * p.nl_scale;
        p.terms[4 * plane + o] =
            missing < static_cast<T>(kMissMin) ? T(0) : missing;
        p.terms[5 * plane + o] =
            lin_dist < static_cast<T>(kMissMin) ? T(0) : lin_dist;
      }
    }
    if (loudness) {
      p.loud[o] = sum[c][6] * p.nl_scale;
      p.loud[plane + o] = sum[c][7] * p.nl_scale;
    }
    if (nmr) {
      p.nmr[o] = nsum[c] / static_cast<S>(z);
      p.nmr[plane + o] =
          nmax[c] > static_cast<S>(kOnePointFiveDb) ? S(1) : S(0);
    }
  }
  if (prob) {
    for (int h = 1; h < kGroups; ++h) {
      const int ix = h * kLanes + lane;
      prod = prod * part[R * kRowSums * kThreads + ix];
      steps_sum = steps_sum + part[(R * kRowSums + 1) * kThreads + ix];
    }
    const long long pairs = p.rows / R;
    const long long o = blk / p.tiles * f + fr;
    p.pd[o] = T(1) - prod;
    p.pd[pairs * f + o] = steps_sum;
  }
}

// a pair's detection where its channels are not a tile's rows: the pair's
// excitations read in place, each channel in turn, as tile_terms forms
// them
template <typename T, typename S>
__device__ void pair_terms(const MovsArgs<T, S>& p, long long blk,
                           double* smem) {
  const int z = p.z, f = p.f, ch = p.channels, tid = threadIdx.x;
  const int lane = tid % kLanes, g = tid / kLanes;
  const long long q = blk / p.tiles;
  const int fr = static_cast<int>(blk % p.tiles) * kLanes + lane;
  const bool live = fr < f;
  const bool use_floor = p.parts & kUseFloor;
  T prod = T(1), steps = T(0);
  if (live) {
    for (int b = g * z / kGroups; b < (g + 1) * z / kGroups; ++b) {
      T pmax = T(0), qmax = T(0);
      for (int c = 0; c < ch; ++c) {
        const long long i =
            ((q * ch + c) * z + b) * static_cast<long long>(f) + fr;
        const Detect<T> d = detect(p.in[0][i], p.in[1][i], use_floor);
        pmax = c == 0 ? d.p : max_nan(pmax, d.p);
        qmax = c == 0 ? d.q : max_nan(qmax, d.q);
      }
      prod = prod * (T(1) - pmax);
      steps = steps + qmax;
    }
  }
  T* part = reinterpret_cast<T*>(smem);
  part[tid] = prod;
  part[kThreads + tid] = steps;
  __syncthreads();
  if (g != 0 || !live) return;
  for (int h = 1; h < kGroups; ++h) {
    prod = prod * part[h * kLanes + lane];
    steps = steps + part[kThreads + h * kLanes + lane];
  }
  const long long pairs = p.rows / ch;
  const long long o = q * f + fr;
  p.pd[o] = T(1) - prod;
  p.pd[pairs * f + o] = steps;
}

// M1's blocks per SM, from ptxas's registers (tile_terms in double wants
// about twice float's)
template <typename T>
constexpr int kMovsBlocks = sizeof(T) == 8 ? 2 : 3;

// blocks [0, tile_blocks): tiles of R rows; after them the detection of
// pairs that are not tiles
template <int R, bool FB, int STAGES, typename T, typename S>
__global__ void __launch_bounds__(kThreads, kMovsBlocks<T>)
band_movs_kernel(MovsArgs<T, S> p, long long tile_blocks) {
  extern __shared__ double smem[];
  const long long blk = blockIdx.x;
  if (blk < tile_blocks) {
    tile_terms<R, FB, STAGES>(p, blk, smem);
  } else {
    pair_terms(p, blk - tile_blocks, smem);
  }
}

// M1's math floor: the card's throughput of each library call M1 makes (and
// of S2's sqrt and log1p, for tools/spectral_ab.py), in a loop of kChains independent chains a thread over values kept in
// registers, with no memory traffic.  A step is the call and one add that
// keeps the value in range (kMathMulAdd: a multiply and that add alone).
constexpr int kMathPow = 0;      // pow(x, 0.23)
constexpr int kMathExp = 1;      // exp(-x)
constexpr int kMathExp2 = 2;     // exp2(-x)
constexpr int kMathLog10 = 3;    // log10(x)
constexpr int kMathDiv = 4;      // 1.5 / x
constexpr int kMathMulAdd = 5;   // 0.5 x
constexpr int kMathSqrt = 6;     // sqrt(x)
constexpr int kMathLog1p = 7;    // log1p(x)
constexpr int kChains = 8;

template <typename T, int OP>
__device__ __forceinline__ T math_step(T x) {
  if constexpr (OP == kMathPow) return pow_t(x, T(0.23)) + T(1);
  if constexpr (OP == kMathExp) return exp_t(-x) + T(0.5);
  if constexpr (OP == kMathExp2) return exp2_t(-x) + T(0.5);
  if constexpr (OP == kMathLog10) return log10_t(x) + T(2);
  if constexpr (OP == kMathDiv) return T(1.5) / x + T(0.5);
  if constexpr (OP == kMathSqrt) return sqrt_t(x) + T(0.5);
  if constexpr (OP == kMathLog1p) return log1p_t(x) + T(0.5);
  return T(0.5) * x + T(0.5);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
math_rate_kernel(long long iters, T* __restrict__ out) {
  T x[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    x[j] = T(1.25) + T(0.001) * static_cast<T>(threadIdx.x % kLanes + j);
  }
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) x[j] = math_step<T, OP>(x[j]);
  }
  T s = x[0];
#pragma unroll
  for (int j = 1; j < kChains; ++j) s = s + x[j];
  out[static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x] = s;
}

template <typename T>
int launch_math_rate(int op, long long iters, int blocks, void* out,
                     void* stream) {
  if (iters < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  T* o = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kMathPow:
      math_rate_kernel<T, kMathPow><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case kMathExp:
      math_rate_kernel<T, kMathExp><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case kMathExp2:
      math_rate_kernel<T, kMathExp2><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case kMathLog10:
      math_rate_kernel<T, kMathLog10><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case kMathDiv:
      math_rate_kernel<T, kMathDiv><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case kMathMulAdd:
      math_rate_kernel<T, kMathMulAdd><<<blocks, kThreads, 0, s>>>(iters,
                                                                   o);
      break;
    case kMathSqrt:
      math_rate_kernel<T, kMathSqrt><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case kMathLog1p:
      math_rate_kernel<T, kMathLog1p><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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

// M1 as tiles of R rows with a ring of STAGES (FB: the FB site's three
// noise loudness sets), its dynamic shared memory sized for the parts it
// runs
template <int R, bool FB, int STAGES, typename T, typename S>
int launch_tiles(const MovsArgs<T, S>& p, long long tile_blocks,
                 long long blocks, cudaStream_t stream) {
  const Layout l = layout_of(R, STAGES, ins_of(p.parts, p.fused),
                             p.parts & kNmr, p.z, sizeof(T), sizeof(S));
  long long words = l.words;
  if (blocks > tile_blocks) {
    words = words > words_of(2LL * kThreads, sizeof(T))
        ? words : words_of(2LL * kThreads, sizeof(T));
  }
  const int bytes = static_cast<int>(words * 8);
  auto kernel = band_movs_kernel<R, FB, STAGES, T, S>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      p, tile_blocks);
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
  const bool fb = parts & kModFb;
  if (rows < 0 || channels < 1 || rows % channels || z < 1
      || z > kMaxBands || f < 0
      || (f > 0 && rows > (INT_MAX / tiles) / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || f == 0 || !(row_parts || prob)) {
    return static_cast<int>(cudaGetLastError());
  }
  MovsArgs<T, S> p;
  // in: exc_ref, exc_test, lev_corr, pc_ref, pc_test, mod_ref, mod_test,
  // avg_loud, noise
  const int order[kIns] = {0, 1, 3, 4, 5, 6, 7};
  for (int s = 0; s < kIns; ++s) {
    p.in[s] = static_cast<const T*>(in[order[s]]);
  }
  p.lev_corr = static_cast<const T*>(in[2]);
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
  // a pair of one or two channels is one tile, its rows, where the pairs'
  // tiles fill the card at least once; on fewer (one pair, a chunk step)
  // the rows' tiles and the pairs' detection run in blocks of their own,
  // three times the threads, since a thread's chain of bands then sets the
  // time
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pairs = rows / channels;
  p.fused = prob && !fb && channels <= 2
            && pairs * tiles >= 1LL * sms * kMovsBlocks<T>;
  const long long tile_blocks =
      p.fused ? pairs * tiles : (row_parts ? rows * tiles : 0);
  const long long blocks =
      tile_blocks + (prob && !p.fused ? pairs * tiles : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fb) return launch_tiles<1, true, kStages>(p, tile_blocks, blocks, s);
  if (p.fused && channels == 2) {
    return launch_tiles<2, false, kStages>(p, tile_blocks, blocks, s);
  }
  if (ins_of(parts, p.fused) == 1) {             // NMR alone
    constexpr int stages = sizeof(T) == 4 ? kDirect : kStages;
    return launch_tiles<1, false, stages>(p, tile_blocks, blocks, s);
  }
  return launch_tiles<1, false, kStages>(p, tile_blocks, blocks, s);
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

// band_math_rate: op one of the kMath* codes; blocks x 256 threads, each
// running iters steps of 8 chains; out [blocks x 256] takes each thread's
// sum.  No path of the port calls it.
int peaq_band_math_rate_f32(int op, long long iters, int blocks, void* out,
                            void* stream) {
  return launch_math_rate<float>(op, iters, blocks, out, stream);
}

int peaq_band_math_rate_f64(int op, long long iters, int blocks, void* out,
                            void* stream) {
  return launch_math_rate<double>(op, iters, blocks, out, stream);
}

}  // extern "C"
