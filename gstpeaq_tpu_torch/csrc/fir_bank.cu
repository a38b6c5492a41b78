// The filter-bank ear model's complex FIR bank, for Hopper (sm_90a).
// BS.1387 / src/fbearmodel.c:398-435.
//
// F1  fir_bank  replaces the cuDNN conv1d of ops/cuda_fir.py::
//     fir_bank_plain.  It is not a TPU kernel: the JAX package leaves the
//     bank to XLA (gstpeaq_tpu/ops/fb_ear.py::_conv_group_outputs, :426, a
//     conv per group of bands, no pallas_call).  Per signal row, with xs
//     the last FIR_PAD = 1472 samples of the history (zeros without one)
//     followed by hp2, and w_c[j] = h_c[1472 - j] channel c's taps by
//     offset j (40 real channels, then 40 imaginary):
//       out[c, i] = sum over j in [lo(c), hi(c)) of xs[32 i + j] w_c[j]
//     at every 32nd sample, I = T / 32 instants.
//
// What bounds it: the multiply-adds.  The 40 Table-8 filter lengths fall
// from 1,456 to 52 taps, each centred in the 1,456-lag window, so of the
// uniform conv's 80 x 1,456 taps an instant 43,578 lie inside a channel's
// nonzero window (2.67x fewer).  The host plan (ops/cuda_fir.py::fir_plan)
// groups the bands four at a time in band order, where the windows nest,
// 8 channels (re and im) a group, and packs each group's taps [K_g, 8] over
// the union of its windows rounded out to 4: 48,096 taps an instant, 2
// flops each.  At 67 TFLOP/s (the FP64 tensor cores; float32 outside them)
// that takes 5.4x (double) and 10.7x (float) the time of the bytes at
// 3.35 TB/s (hp2 read once, 80 values written an instant).
//
// Design: an implicit GEMM over the Hankel matrix X[i, j] = xs[32 i + j]
// (M = instants, N = a group's 8 channels, K = its window).  A block takes
// one row, a tile of instants and a part of the groups.  It stages the
// strip of xs its instants read in shared memory once, from the history
// and hp2 through two pointers (no padded copy of the signal), skewed by
// kSkew values every 32 samples; then it walks its groups, each over its
// own window, in chunks of kChunk taps whose weights (packed [K_g, 8] on
// the host) cp.async brings into shared memory one chunk ahead, and writes
// re and im [rows, 40, I] in place when a group ends.  A small grid (fewer
// than 4 blocks an SM) splits the groups into up to 4 parts of near-equal
// work, one block each (the host's plan, ops/cuda_fir.py).  Each output is
// written once, by one block, summed in one fixed order: no atomics, so
// two launches give the same bits.
//  - double: mma.sync.aligned.m8n8k4 on the FP64 tensor cores.  A warp
//    owns 4 m-tiles of 8 instants, a block of 4 warps 128 instants.  The 8
//    rows of an A fragment lie 32 samples apart; with 4 values of skew a
//    row of the strip is 36 doubles, so the 16 values a half warp reads
//    fall in 16 distinct bank pairs.  The weights come in fragment order
//    (each k-step's [4, 8] stored [8, 4]), so a B fragment is 32
//    consecutive doubles.
//  - float: FFMA in IEEE float32 (no TF32, no fast math), a register tile
//    of 4 instants x 8 channels a thread, the instants 128 apart, so the 32
//    lanes of a warp read 32 consecutive instants: with 1 value of skew (a
//    row of 33 floats) 32 distinct banks.  A tap's 8 weights are two
//    broadcast 16-byte loads.
// Offsets are 64-bit: the one-hour one shot, [4, 172,800,000] samples,
// writes 864,000,000 values a part, 6.9 GB in double.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kSub = 32;          // one instant every 32 samples
constexpr int kFirPad = 1472;     // the history samples the bank reads
constexpr int kBands = 40;
constexpr int kGroupBands = 4;    // a group: 4 bands, 8 channels
constexpr int kGroupChannels = 2 * kGroupBands;
constexpr int kMaxGroups = 16;
constexpr int kMaxParts = 4;
constexpr int kKAlign = 4;        // the k of mma.m8n8k4
constexpr int kChunk = 32;        // taps of weights staged at once
constexpr int kChunkValues = kChunk * kGroupChannels;
constexpr int kThreads = 128;
// float: instants a thread; double: m-tiles a warp
constexpr int kPerThread = 4;
constexpr int kMmaRows = 8;
template <typename T>
constexpr int kTileInstants = sizeof(T) == 4 ? 512 : 128;
template <typename T>
constexpr int kSkew = sizeof(T) == 4 ? 1 : 4;
template <typename T>
constexpr int kStripRow = kSub + kSkew<T>;
// blocks an SM holds, as its 228 KB of shared memory allow (the registers
// are held to that many)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 4;

static_assert(kTileInstants<float> == kThreads * kPerThread,
              "a float thread owns kPerThread instants kThreads apart");
static_assert(kTileInstants<double> == kThreads / 32 * kPerThread * kMmaRows,
              "a double warp owns kPerThread m-tiles of 8 instants");
static_assert(kChunk % kKAlign == 0, "a chunk holds whole k-steps");

// The host plan: group g's window [lo[g], hi[g]) of offsets j (multiples of
// kKAlign, lo >= jbase) and the first of its K_g x 8 packed weights; the
// groups in part order and where each part starts.
struct FirPlan {
  int groups;
  int parts;
  int jbase;       // a multiple of 32: strip value 0 is xs[32 i0 + jbase]
  int strip_rows;  // rows of 32 samples a block stages
  int lo[kMaxGroups];
  int hi[kMaxGroups];
  int offset[kMaxGroups];
  int order[kMaxGroups];
  int part_start[kMaxParts + 1];
};

// Stage xs[p0, p0 + 32 rows) of one signal row: sample s at
// s + (s / 32) kSkew.  x: the row of hp2, hist: its last kFirPad history
// samples or null for zeros; past the end of hp2, zeros (read only by
// instants past the last).
template <typename T>
__device__ void stage(T* strip, const T* __restrict__ x,
                      const T* __restrict__ hist, long long t_len,
                      long long p0, int rows) {
  const int n = rows * kSub;
  for (int s = threadIdx.x; s < n; s += kThreads) {
    const long long p = p0 + s;
    T v = T(0);
    if (p < kFirPad) {
      if (hist != nullptr) v = hist[p];
    } else if (p - kFirPad < t_len) {
      v = x[p - kFirPad];
    }
    strip[s + (s >> 5) * kSkew<T>] = v;
  }
}

// Queue the weights of taps [j, j + kChunk) of group g (fewer at its end)
// into buf as one cp.async group, 16 bytes a copy.
template <typename T>
__device__ void stage_weights(T* buf, const T* __restrict__ w,
                              const FirPlan& plan, int g, int j) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int taps = min(kChunk, plan.hi[g] - j);
  const T* src = w + plan.offset[g] + (j - plan.lo[g]) * kGroupChannels;
  for (int v = threadIdx.x * kVec; v < taps * kGroupChannels;
       v += kThreads * kVec) {
    const auto to = static_cast<uint32_t>(__cvta_generic_to_shared(buf + v));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + v)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// One chunk of taps [j, j + taps) of the double tile: k-steps of 4.
// Fragments (PTX ISA, mma.m8n8k4 .f64): lane l holds A[l / 4][l % 4],
// B[l % 4][l / 4] and D[l / 4][2 (l % 4) + e]; rows of A and D are
// instants, columns of B and D channels.
template <int kTaps>
__device__ __forceinline__ void chunk_f64(double (&acc)[kPerThread][2],
                                          const double* strip,
                                          const double* wbuf, int jj,
                                          int taps) {
  constexpr int kRow = kStripRow<double>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const double* a_row =
      strip + (kSub * warp + (lane >> 2)) * kRow + (lane & 3);
  const int steps = kTaps > 0 ? kTaps / kKAlign : taps / kKAlign;
#pragma unroll
  for (int s = 0; s < (kTaps > 0 ? kTaps / kKAlign : kChunk / kKAlign); ++s) {
    if (kTaps == 0 && s >= steps) break;
    const double b = wbuf[s * 32 + lane];
    const int step = jj + kKAlign * s;     // a multiple of 4: no row crossed
    const double* a = a_row + step + (step >> 5) * kSkew<double>;
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      mma_f64(acc[m], a[m * kMmaRows * kRow], b);
    }
  }
}

// One chunk of the float tile: thread k sums instants i0 + k + 128 r.
template <int kTaps>
__device__ __forceinline__ void chunk_f32(
    float (&acc)[kPerThread][kGroupChannels], const float* strip,
    const float* wbuf, int jj, int taps) {
  constexpr int kRow = kStripRow<float>;
  const float* x_row = strip + threadIdx.x * kRow;
  const auto* w4 = reinterpret_cast<const float4*>(wbuf);
#pragma unroll
  for (int k = 0; k < (kTaps > 0 ? kTaps : kChunk); ++k) {
    if (kTaps == 0 && k >= taps) break;
    const float4 w0 = w4[2 * k];
    const float4 w1 = w4[2 * k + 1];
    const int col = jj + k;
    const float* a = x_row + col + (col >> 5) * kSkew<float>;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const float v = a[r * kThreads * kRow];
      acc[r][0] = fmaf(v, w0.x, acc[r][0]);
      acc[r][1] = fmaf(v, w0.y, acc[r][1]);
      acc[r][2] = fmaf(v, w0.z, acc[r][2]);
      acc[r][3] = fmaf(v, w0.w, acc[r][3]);
      acc[r][4] = fmaf(v, w1.x, acc[r][4]);
      acc[r][5] = fmaf(v, w1.y, acc[r][5]);
      acc[r][6] = fmaf(v, w1.z, acc[r][6]);
      acc[r][7] = fmaf(v, w1.w, acc[r][7]);
    }
  }
}

// Write group grp's sums at tile start i0 of output row out_row (= signal
// row x 40) and clear them: channel ch < 4 is band 4 grp + ch of re, the
// rest of im.
__device__ __forceinline__ void store_f64(double (&acc)[kPerThread][2],
                                          double* __restrict__ re,
                                          double* __restrict__ im, int grp,
                                          long long out_row, long long i0,
                                          long long n_inst) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ch = 2 * t + e;
    double* out = (ch < kGroupBands ? re : im) +
                  (out_row + kGroupBands * grp + (ch % kGroupBands)) * n_inst;
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const long long i = i0 + kSub * warp + kMmaRows * m + g;
      if (i < n_inst) out[i] = acc[m][e];
      acc[m][e] = 0.0;
    }
  }
}

__device__ __forceinline__ void store_f32(
    float (&acc)[kPerThread][kGroupChannels], float* __restrict__ re,
    float* __restrict__ im, int grp, long long out_row, long long i0,
    long long n_inst) {
#pragma unroll
  for (int ch = 0; ch < kGroupChannels; ++ch) {
    float* out = (ch < kGroupBands ? re : im) +
                 (out_row + kGroupBands * grp + (ch % kGroupBands)) * n_inst;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const long long i = i0 + threadIdx.x + kThreads * r;
      if (i < n_inst) out[i] = acc[r][ch];
      acc[r][ch] = 0.0f;
    }
  }
}

// Block b: part b % parts of the groups, at signal row (b / parts) / tiles
// and instants from kTileInstants ((b / parts) % tiles).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    fir_bank_kernel(const T* __restrict__ x, const T* __restrict__ hist,
                    const T* __restrict__ w, T* __restrict__ re,
                    T* __restrict__ im, long long t_len, long long n_inst,
                    long long tiles, FirPlan plan) {
  extern __shared__ __align__(16) unsigned char fir_smem[];
  T* wbuf = reinterpret_cast<T*>(fir_smem);      // two chunks of weights
  T* strip = wbuf + 2 * kChunkValues;
  const long long block = blockIdx.x;
  const int part = static_cast<int>(block % plan.parts);
  const long long row = block / plan.parts / tiles;
  const long long i0 = (block / plan.parts % tiles) * kTileInstants<T>;
  const long long out_row = row * kBands;
  const int last = plan.part_start[part + 1];
  int idx = plan.part_start[part];
  int j = plan.lo[plan.order[idx]];
  stage_weights(wbuf, w, plan, plan.order[idx], j);
  stage(strip, x + row * t_len,
        hist == nullptr ? nullptr : hist + row * kFirPad, t_len,
        kSub * i0 + plan.jbase, plan.strip_rows);
  using Acc = T[kPerThread][sizeof(T) == 8 ? 2 : kGroupChannels];
  Acc acc = {};
  for (int c = 0; idx < last; ++c) {
    const int grp = plan.order[idx];
    int next = idx;
    int next_j = j + kChunk;
    if (next_j >= plan.hi[grp]) {
      ++next;
      if (next < last) next_j = plan.lo[plan.order[next]];
    }
    T* buf = wbuf + (c & 1) * kChunkValues;
    if (next < last) {
      stage_weights(wbuf + ((c + 1) & 1) * kChunkValues, w, plan,
                    plan.order[next], next_j);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int taps = min(kChunk, plan.hi[grp] - j);
    const int jj = j - plan.jbase;
    if constexpr (sizeof(T) == 8) {
      if (taps == kChunk) {
        chunk_f64<kChunk>(acc, strip, buf, jj, taps);
      } else {
        chunk_f64<0>(acc, strip, buf, jj, taps);
      }
      if (next != idx) store_f64(acc, re, im, grp, out_row, i0, n_inst);
    } else {
      if (taps == kChunk) {
        chunk_f32<kChunk>(acc, strip, buf, jj, taps);
      } else {
        chunk_f32<0>(acc, strip, buf, jj, taps);
      }
      if (next != idx) store_f32(acc, re, im, grp, out_row, i0, n_inst);
    }
    __syncthreads();     // buf is refilled two chunks on
    idx = next;
    j = next_j;
  }
}

// Whether the host's plan is one the kernel reads right: groups of 4 bands
// covering the 40, each once in its parts, windows of whole k-steps past
// jbase, 16-byte aligned weights, and the grid and strip the host
// computed (ops/cuda_fir.py::launch_grid).
template <typename T>
bool plan_fits(const FirPlan& p, long long rows, long long t_len,
               long long tiles, size_t* bytes) {
  if (p.groups * kGroupBands != kBands || p.groups > kMaxGroups ||
      p.parts < 1 || p.parts > kMaxParts || p.parts > p.groups) {
    return false;
  }
  if (p.jbase < 0 || p.jbase % kSub != 0 || t_len % kSub != 0) return false;
  int hi_max = p.jbase;
  int seen[kMaxGroups] = {};
  for (int g = 0; g < p.groups; ++g) {
    if (p.lo[g] < p.jbase || p.hi[g] < p.lo[g] || p.lo[g] % kKAlign != 0 ||
        p.hi[g] % kKAlign != 0 || p.offset[g] % (4 * kGroupChannels) != 0 ||
        p.hi[g] > kFirPad + kSub || p.order[g] < 0 ||
        p.order[g] >= p.groups) {
      return false;
    }
    ++seen[p.order[g]];
    if (p.hi[g] > hi_max) hi_max = p.hi[g];
  }
  for (int g = 0; g < p.groups; ++g) {
    if (seen[g] != 1) return false;
  }
  if (p.part_start[0] != 0 || p.part_start[p.parts] != p.groups) return false;
  for (int q = 0; q < p.parts; ++q) {
    if (p.part_start[q + 1] <= p.part_start[q]) return false;
  }
  const long long n_inst = t_len / kSub;
  const long long want_tiles =
      (n_inst + kTileInstants<T> - 1) / kTileInstants<T>;
  const long long span = static_cast<long long>(kSub) *
                             (kTileInstants<T> - 1) + hi_max - p.jbase;
  if (tiles != want_tiles || rows * tiles * p.parts > INT_MAX ||
      static_cast<long long>(p.strip_rows) * kSub < span) {
    return false;
  }
  *bytes = (2 * static_cast<size_t>(kChunkValues) +
            static_cast<size_t>(p.strip_rows) * kStripRow<T>) * sizeof(T);
  return true;
}

// Raise the kernel's dynamic shared memory limit to `bytes` once per
// device (the largest asked for so far).
template <typename T>
int allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices] = {};
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err != 0) return err;
  if (device < kMaxDevices && allowed[device] >= bytes) return 0;
  err = static_cast<int>(cudaFuncSetAttribute(
      fir_bank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
  if (err == 0 && device < kMaxDevices) allowed[device] = bytes;
  return err;
}

// table: [jbase, lo[G], hi[G], offset[G], parts, order[G],
// part_start[parts + 1]] (ops/cuda_fir.py::FirPlan.table).
template <typename T>
int launch_fir(const void* x, const void* hist, const void* w, void* re,
               void* im, long long rows, long long t_len, long long tiles,
               long long strip_rows, const long long* table, int groups,
               void* stream) {
  if (rows <= 0 || t_len < kSub) return static_cast<int>(cudaGetLastError());
  if (groups <= 0 || groups > kMaxGroups || strip_rows <= 0 ||
      strip_rows > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FirPlan plan{};
  plan.groups = groups;
  plan.jbase = static_cast<int>(table[0]);
  plan.strip_rows = static_cast<int>(strip_rows);
  for (int g = 0; g < groups; ++g) {
    plan.lo[g] = static_cast<int>(table[1 + g]);
    plan.hi[g] = static_cast<int>(table[1 + groups + g]);
    plan.offset[g] = static_cast<int>(table[1 + 2 * groups + g]);
  }
  const long long* parts = table + 1 + 3 * groups;
  if (parts[0] < 1 || parts[0] > kMaxParts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan.parts = static_cast<int>(parts[0]);
  for (int g = 0; g < groups; ++g) {
    plan.order[g] = static_cast<int>(parts[1 + g]);
  }
  for (int q = 0; q <= plan.parts; ++q) {
    plan.part_start[q] = static_cast<int>(parts[1 + groups + q]);
  }
  size_t bytes = 0;
  if (!plan_fits<T>(plan, rows, t_len, tiles, &bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = allow_smem<T>(bytes);
  if (err != 0) return err;
  fir_bank_kernel<T>
      <<<static_cast<unsigned>(rows * tiles * plan.parts), kThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(hist),
          static_cast<const T*>(w), static_cast<T*>(re), static_cast<T*>(im),
          t_len, t_len / kSub, tiles, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch on `stream`; returns cudaGetLastError() (0 = ok).  x: hp2
// [rows, t_len]; hist (nullable = zeros): [rows, 1472], the history's last
// samples; w: the packed group weights (ops/cuda_fir.py::packed_weight);
// re, im: [rows, 40, t_len / 32]; tiles and strip_rows from ops/
// cuda_fir.py::launch_grid; table: the host plan with its parts
// (FirPlan.table(parts)).
int peaq_fir_bank_f32(const void* x, const void* hist, const void* w,
                      void* re, void* im, long long rows, long long t_len,
                      long long tiles, long long strip_rows,
                      const long long* table, int groups, void* stream) {
  return launch_fir<float>(x, hist, w, re, im, rows, t_len, tiles,
                           strip_rows, table, groups, stream);
}

int peaq_fir_bank_f64(const void* x, const void* hist, const void* w,
                      void* re, void* im, long long rows, long long t_len,
                      long long tiles, long long strip_rows,
                      const long long* table, int groups, void* stream) {
  return launch_fir<double>(x, hist, w, re, im, rows, t_len, tiles,
                            strip_rows, table, groups, stream);
}

}  // extern "C"
