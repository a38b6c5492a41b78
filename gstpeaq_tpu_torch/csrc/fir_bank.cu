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
// What bounds it: the multiply-adds, and before them the shared-memory
// reads that feed them.  The 40 Table-8 filter lengths fall from 1,456 to
// 52 taps, each centred in the 1,456-lag window, so of the uniform conv's
// 80 x 1,456 taps an instant 43,578 lie inside a channel's nonzero window.
// The host plan (ops/cuda_fir.py::fir_plan) groups the bands four at a
// time in band order, 8 channels (re and im) a group, each over the union
// of its windows rounded out to 4 taps (8 in double, one k-step): 48,096
// (48,384) taps an instant, 2 flops each, at 67 TFLOP/s (the FP64 tensor
// cores; float32 outside them) 5.4x (double) and 10.7x (float) the time
// of the bytes at 3.35 TB/s.
// The groups' windows nest (every band's is centred), so a tap of the
// 1,464-tap span lies in 4.1 groups' windows on average, 10 at the centre.
//
// Design: an implicit GEMM over the Hankel matrix X[i, j] = xs[32 i + j] (M =
// instants, N = a group's 8 channels, K = taps).  A block takes one row, a
// tile of instants and a part of the groups.  It stages the strip of xs its
// instants read in shared memory once, from the history and hp2 through two
// pointers (no padded copy of the signal), skewed by kSkew values every 32
// samples, and brings its weights into shared memory with cp.async one
// chunk of taps ahead (kChunk taps).  A small grid (fewer blocks than the
// SMs hold at once) splits the groups into up to 4 parts of near-equal
// covering work, one block each (the host's plan).  Each output is written
// once, by one block, summed over its taps in ascending order: no atomics,
// so two launches give the same bits.
//  - double: taps outer and every covering group inner.  Walking the groups
//    one after another, a staged sample was read once per group covering
//    it, for that group's 8 channels: 10 shared-memory wavefronts per 8 SM
//    clocks of DMMA, bound by the loads before the tensor cores (29-39% of
//    the bound).  Here a part's groups come in passes of at most kOpen
//    groups whose windows nest, widest first, so that the groups covering a
//    tap are always the first n of the pass.  The host cuts each pass's
//    union into segments of at most kChunk taps over which n is constant;
//    the block walks its part's segments in order, and at each k-step loads
//    the strip values once and applies them to each of the n covering
//    groups, each with that group's weights into its own accumulators in
//    registers; the segment's body, compiled for its n, has no branch
//    between its loads and its multiply-adds.  The weights come packed
//    k-major (ops/cuda_fir.py::fir_layout): for each k-step of a pass, the
//    fragments of its covering groups in pass order, so a segment is one
//    contiguous copy.  When a pass ends its sums go to re and im [rows, 40,
//    I] in place.  mma.sync.aligned.m16n8k8 on the FP64 tensor cores (the
//    first form's m8n8k4 runs at half their rate on an H100: chip_smoke.py
//    phase 7, fir_mma).  A warp owns kMTiles = 2 m-tiles of 16 instants and reads
//    each group's B fragment once for both; a pass holds 4 groups, 2 x 4
//    accumulators each a lane (64 registers, within the 128 that 2 blocks
//    of 256 threads an SM allow); 8 warps, 256 instants a block.  An 8-tap
//    k-step costs a warp 16 shared-memory wavefronts of A and 4 of B per
//    covering group against 16 SM clocks of DMMA per group, so the tensor
//    cores, not the loads, set the pace.  An A fragment's rows lie 32
//    samples apart; with 4 values of skew a row of the strip is 36 doubles,
//    so the 16 values a half warp reads fall in 16 distinct bank pairs.  A
//    group's B fragment for a k-step is 8 x 8 doubles in lane order, 32
//    consecutive values per half.
//  - float: group by group.  FFMA in IEEE float32 (no TF32, no fast math),
//    a register tile of 4 instants x 8 channels a thread, the instants 128
//    apart, so the 32 lanes of a warp read 32 consecutive instants: with 1
//    value of skew (a row of 33 floats) 32 distinct banks.  A tap's 8
//    weights are two broadcast 16-byte loads per group, which walking taps
//    outer does not share, and its segments' weight buffers cost float the
//    third block an SM: on an H100 taps outer measured slower than this
//    walk.  So the block walks its groups one after another, each over its
//    own window, its weights packed [K_g, 8] per group, and writes a
//    group's sums when its window ends; 3 blocks an SM.
// Offsets are 64-bit: the one-hour one shot, [4, 172,800,000] samples,
// writes 864,000,000 values a part, 6.9 GB in double.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kSub = 32;          // one instant every 32 samples
constexpr int kFirPad = 1472;     // the history samples the bank reads
constexpr int kBands = 40;
constexpr int kGroupBands = 4;    // a group: 4 bands, 8 channels
constexpr int kGroupChannels = 2 * kGroupBands;
constexpr int kMaxGroups = 16;
constexpr int kMaxParts = 4;
constexpr int kMaxPasses = 16;
constexpr int kMaxSegments = 256;
constexpr int kAlign = 4;         // taps a float group's window rounds to
constexpr int kKAlign = 8;        // a double k-step: the k of mma.m16n8k8
constexpr int kChunk = 32;        // taps of weights a block stages at once
constexpr int kOpen = 4;          // double: groups a pass holds open
constexpr int kMmaRows = 16;      // double: instants an m-tile
constexpr int kMTiles = 2;        // double: m-tiles a warp
constexpr int kPerThread = 4;     // float: instants a thread
template <typename T>
constexpr int kThreads = sizeof(T) == 4 ? 128 : 256;
template <typename T>
constexpr int kTileInstants = sizeof(T) == 4 ? 512 : 256;
template <typename T>
constexpr int kSkew = sizeof(T) == 4 ? 1 : 4;
template <typename T>
constexpr int kStripRow = kSub + kSkew<T>;
// values a weight buffer holds: a chunk of one group (float), a segment of
// up to kOpen groups (double)
template <typename T>
constexpr int kWeightValues =
    kChunk * kGroupChannels * (sizeof(T) == 4 ? 1 : kOpen);
// blocks an SM holds, as its 228 KB of shared memory allow (the registers
// are held to that many)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;
// a double segment's first word: its first tap j0, its taps, its covering
// groups n and whether its pass ends with it, in bit fields
constexpr int kTapBits = 12;
constexpr int kCountShift = 12;
constexpr int kCoverShift = 20;
constexpr int kEndShift = 28;

static_assert(kTileInstants<float> == kThreads<float> * kPerThread,
              "a float thread owns kPerThread instants kThreads apart");
static_assert(kTileInstants<double> ==
                  kThreads<double> / 32 * kMTiles * kMmaRows,
              "a double warp owns kMTiles m-tiles of 16 instants");
static_assert(kChunk % kKAlign == 0, "a segment holds whole k-steps");

// The double plan for one split of the groups into parts: the groups in
// pass order, pass k's groups order[pass_start[k] .. pass_start[k + 1])
// (at most kOpen, windows nesting, widest first); part q's passes
// part_pass[q] .. part_pass[q + 1] and its segments part_seg[q] ..
// part_seg[q + 1]; segment i: seg[i].x the fields above, seg[i].y the
// first of its packed weights (taps / 8 k-steps, each the 8 x 8
// fragments of the pass's first n groups).
struct FirPlan {
  int groups;
  int parts;
  int passes;
  int segments;
  int jbase;       // a multiple of 32: strip value 0 is xs[32 i0 + jbase]
  int strip_rows;  // rows of 32 samples a block stages
  int order[kMaxGroups];
  int pass_start[kMaxPasses + 1];
  int part_pass[kMaxParts + 1];
  int part_seg[kMaxParts + 1];
  int2 seg[kMaxSegments];
};

// The float plan: group g's window [lo[g], hi[g]) of offsets j (lo >=
// jbase) and the first of its K_g x 8 packed weights; the groups in part
// order and where each part starts.
struct GroupPlan {
  int groups;
  int parts;
  int jbase;
  int strip_rows;
  int lo[kMaxGroups];
  int hi[kMaxGroups];
  int offset[kMaxGroups];
  int order[kMaxGroups];
  int part_start[kMaxParts + 1];
};

template <typename T>
using PlanOf =
    typename std::conditional<sizeof(T) == 8, FirPlan, GroupPlan>::type;

struct Segment {
  int j0, taps, cover, end, weights;
};

__host__ __device__ __forceinline__ Segment segment(int2 s) {
  return {s.x & ((1 << kTapBits) - 1),
          (s.x >> kCountShift) & ((1 << (kCoverShift - kCountShift)) - 1),
          (s.x >> kCoverShift) & ((1 << (kEndShift - kCoverShift)) - 1),
          (s.x >> kEndShift) & 1, s.y};
}

// Stage xs[p0, p0 + 32 rows) of one signal row: sample s at
// s + (s / 32) kSkew.  x: the row of hp2, hist: its last kFirPad history
// samples or null for zeros; past the end of hp2, zeros (read only by
// instants past the last).
template <typename T>
__device__ void stage(T* strip, const T* __restrict__ x,
                      const T* __restrict__ hist, long long t_len,
                      long long p0, int rows) {
  const int n = rows * kSub;
  for (int s = threadIdx.x; s < n; s += kThreads<T>) {
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

// Queue `n` values from src into buf as one cp.async group, 16 bytes a
// copy.
template <typename T>
__device__ void stage_weights(T* buf, const T* __restrict__ src, int n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  for (int v = threadIdx.x * kVec; v < n; v += kThreads<T> * kVec) {
    const auto to = static_cast<uint32_t>(__cvta_generic_to_shared(buf + v));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + v)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A segment's weights (double): one contiguous run.
__device__ __forceinline__ void stage_segment(double* buf,
                                              const double* __restrict__ w,
                                              Segment s) {
  stage_weights(buf, w + s.weights, s.taps * s.cover * kGroupChannels);
}

// The weights of taps [j, j + kChunk) of group g (fewer at its end), float.
__device__ __forceinline__ void stage_chunk(float* buf,
                                            const float* __restrict__ w,
                                            const GroupPlan& plan, int g,
                                            int j) {
  const int taps = min(kChunk, plan.hi[g] - j);
  stage_weights(buf, w + plan.offset[g] + (j - plan.lo[g]) * kGroupChannels,
                taps * kGroupChannels);
}

// D += A B on the FP64 tensor cores for one k-step of kKAlign = 8 taps,
// mma.sync m16n8k8 (PTX ISA, mma .f64): lane l holds A[g + 8 (i % 2)][t +
// 4 (i / 2)] as a[i], B[t + 4 i][g] as b[i] and D[g + 8 (e / 2)][2 t + e %
// 2] as d[e], g = l / 4, t = l % 4; rows of A and D are instants, columns
// of B and D channels.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

using AccF64 = double[kOpen][kMTiles][4];
using AccF32 = float[kPerThread][kGroupChannels];

// A segment of the double tile at strip column jj, kN covering groups:
// `steps` k-steps of 8 taps.  At each step the warp loads the A fragments
// of its m-tiles once and runs, for each of the kN groups, whose B
// fragments follow one another in the step's record (8 x 8 values a
// group, 32 consecutive per half), one mma per m-tile.
template <int kN>
__device__ __forceinline__ void segment_f64(AccF64& acc,
                                            const double* strip,
                                            const double* wbuf, int jj,
                                            int steps) {
  constexpr int kRow = kStripRow<double>;
  constexpr int kFrag = kKAlign * kGroupChannels;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const double* a_row =
      strip + (kMTiles * kMmaRows * warp + (lane >> 2)) * kRow + (lane & 3);
#pragma unroll
  for (int s = 0; s < kChunk / kKAlign; ++s) {
    if (s >= steps) break;
    // a multiple of 8: the step's taps lie in one row of 32
    const int step = jj + kKAlign * s;
    const double* a0 = a_row + step + (step >> 5) * kSkew<double>;
    double a[kMTiles][4];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[m][i] = a0[(kMmaRows * m + 8 * (i & 1)) * kRow + 4 * (i >> 1)];
      }
    }
    const double* b0 = wbuf + s * kN * kFrag + lane;
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const double b[2] = {b0[q * kFrag], b0[q * kFrag + 32]};
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) mma_f64(acc[q][m], a[m], b);
    }
  }
}

// A double segment with its count of covering groups as a compile-time
// constant: kN from 1 up to kOpen, one body each.
template <int kN = 1>
__device__ __forceinline__ void run_segment(AccF64& acc, const double* strip,
                                            const double* wbuf, int jj,
                                            int taps, int cover) {
  if constexpr (kN <= kOpen) {
    if (cover == kN) {
      segment_f64<kN>(acc, strip, wbuf, jj, taps / kKAlign);
    } else {
      run_segment<kN + 1>(acc, strip, wbuf, jj, taps, cover);
    }
  }
}

// One chunk of the float tile: thread k sums instants i0 + k + 128 r over
// taps [jj, jj + taps) of the strip, kTaps of them (0: `taps`).
template <int kTaps>
__device__ __forceinline__ void chunk_f32(AccF32& acc, const float* strip,
                                          const float* wbuf, int jj,
                                          int taps) {
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
      const float v = a[r * kThreads<float> * kRow];
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

// The output of channel ch (< 4: band 4 grp + ch of re, else of im) at
// output row out_row (= signal row x 40).
template <typename T>
__device__ __forceinline__ T* channel_out(T* __restrict__ re,
                                          T* __restrict__ im, int grp,
                                          int ch, long long out_row,
                                          long long n_inst) {
  return (ch < kGroupBands ? re : im) +
         (out_row + kGroupBands * grp + (ch % kGroupBands)) * n_inst;
}

// Write double pass k's sums at tile start i0 and clear them.
__device__ __forceinline__ void store_pass(AccF64& acc,
                                           double* __restrict__ re,
                                           double* __restrict__ im,
                                           const FirPlan& plan, int k,
                                           long long out_row, long long i0,
                                           long long n_inst) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = plan.pass_start[k];
  const int n = plan.pass_start[k + 1] - first;
#pragma unroll
  for (int q = 0; q < kOpen; ++q) {
    if (q < n) {
      const int grp = plan.order[first + q];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = 2 * (lane & 3) + (e & 1);
          const long long i = i0 + kMmaRows * (kMTiles * warp + m) +
                              (lane >> 2) + 8 * (e >> 1);
          if (i < n_inst) {
            channel_out(re, im, grp, ch, out_row, n_inst)[i] = acc[q][m][e];
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][m][e] = 0.0;
    }
  }
}

// Write float group grp's sums at tile start i0 and clear them.
__device__ __forceinline__ void store_group(AccF32& acc,
                                            float* __restrict__ re,
                                            float* __restrict__ im, int grp,
                                            long long out_row, long long i0,
                                            long long n_inst) {
#pragma unroll
  for (int ch = 0; ch < kGroupChannels; ++ch) {
    float* out = channel_out(re, im, grp, ch, out_row, n_inst);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const long long i = i0 + threadIdx.x + kThreads<float> * r;
      if (i < n_inst) out[i] = acc[r][ch];
      acc[r][ch] = 0.0f;
    }
  }
}

// Block b: part b % parts of the groups, at signal row (b / parts) / tiles
// and instants from kTileInstants ((b / parts) % tiles).
template <typename T>
__global__ void __launch_bounds__(kThreads<T>, kMinBlocks<T>)
    fir_bank_kernel(const T* __restrict__ x, const T* __restrict__ hist,
                    const T* __restrict__ w, T* __restrict__ re,
                    T* __restrict__ im, long long t_len, long long n_inst,
                    long long tiles, const __grid_constant__ PlanOf<T> plan) {
  extern __shared__ __align__(16) unsigned char fir_smem[];
  T* wbuf = reinterpret_cast<T*>(fir_smem);      // two chunks of weights
  T* strip = wbuf + 2 * kWeightValues<T>;
  const long long block = blockIdx.x;
  const int part = static_cast<int>(block % plan.parts);
  const long long row = block / plan.parts / tiles;
  const long long i0 = (block / plan.parts % tiles) * kTileInstants<T>;
  const long long out_row = row * kBands;
  const T* x_row = x + row * t_len;
  const T* h_row = hist == nullptr ? nullptr : hist + row * kFirPad;
  const long long p0 = kSub * i0 + plan.jbase;
  if constexpr (sizeof(T) == 8) {
    // taps outer: the part's segments in order, a pass's sums stored as
    // its last segment ends
    const int first = plan.part_seg[part];
    const int last = plan.part_seg[part + 1];
    stage_segment(wbuf, w, segment(plan.seg[first]));
    stage(strip, x_row, h_row, t_len, p0, plan.strip_rows);
    AccF64 acc = {};
    int k = plan.part_pass[part];
    for (int i = first; i < last; ++i) {
      // segment i's weights are in; every thread is past segment i - 1,
      // whose buffer segment i + 1's weights now fill
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      if (i + 1 < last) {
        stage_segment(wbuf + ((i - first + 1) & 1) * kWeightValues<T>, w,
                      segment(plan.seg[i + 1]));
      }
      const Segment s = segment(plan.seg[i]);
      run_segment(acc, strip, wbuf + ((i - first) & 1) * kWeightValues<T>,
                  s.j0 - plan.jbase, s.taps, s.cover);
      if (s.end) {
        store_pass(acc, re, im, plan, k, out_row, i0, n_inst);
        ++k;
      }
    }
  } else {
    // group by group, each over its own window in chunks of kChunk taps
    const int last = plan.part_start[part + 1];
    int idx = plan.part_start[part];
    int j = plan.lo[plan.order[idx]];
    stage_chunk(wbuf, w, plan, plan.order[idx], j);
    stage(strip, x_row, h_row, t_len, p0, plan.strip_rows);
    AccF32 acc = {};
    for (int c = 0; idx < last; ++c) {
      const int grp = plan.order[idx];
      int next = idx;
      int next_j = j + kChunk;
      if (next_j >= plan.hi[grp]) {
        ++next;
        if (next < last) next_j = plan.lo[plan.order[next]];
      }
      if (next < last) {
        stage_chunk(wbuf + ((c + 1) & 1) * kWeightValues<T>, w, plan,
                    plan.order[next], next_j);
      } else {
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      const T* buf = wbuf + (c & 1) * kWeightValues<T>;
      const int taps = min(kChunk, plan.hi[grp] - j);
      if (taps == kChunk) {
        chunk_f32<kChunk>(acc, strip, buf, j - plan.jbase, taps);
      } else {
        chunk_f32<0>(acc, strip, buf, j - plan.jbase, taps);
      }
      if (next != idx) store_group(acc, re, im, grp, out_row, i0, n_inst);
      __syncthreads();     // buf is refilled two chunks on
      idx = next;
      j = next_j;
    }
  }
}

// The grid and strip the host computed (ops/cuda_fir.py::launch_grid),
// and the shared memory they take.
template <typename T>
bool grid_fits(int parts, int jbase, int strip_rows, int hi_max,
               long long rows, long long t_len, long long tiles,
               size_t* bytes) {
  const long long n_inst = t_len / kSub;
  const long long want_tiles =
      (n_inst + kTileInstants<T> - 1) / kTileInstants<T>;
  const long long span = static_cast<long long>(kSub) *
                             (kTileInstants<T> - 1) + hi_max - jbase;
  if (tiles != want_tiles || rows * tiles * parts > INT_MAX ||
      static_cast<long long>(strip_rows) * kSub < span) {
    return false;
  }
  *bytes = (2 * static_cast<size_t>(kWeightValues<T>) +
            static_cast<size_t>(strip_rows) * kStripRow<T>) * sizeof(T);
  return true;
}

// Whether the groups' windows lo, hi (multiples of `align`, from jbase, a
// multiple of 32) and their order fit: groups of 4 bands covering the 40,
// each once.  hi_max: the largest hi.
bool windows_fit(int groups, int jbase, const int* lo, const int* hi,
                 const int* order, int align, long long t_len,
                 int* hi_max) {
  if (groups * kGroupBands != kBands || groups > kMaxGroups || jbase < 0 ||
      jbase % kSub != 0 || t_len % kSub != 0) {
    return false;
  }
  *hi_max = jbase;
  int seen[kMaxGroups] = {};
  for (int g = 0; g < groups; ++g) {
    if (lo[g] < jbase || hi[g] < lo[g] || lo[g] % align != 0 ||
        hi[g] % align != 0 || hi[g] > kFirPad + kSub || order[g] < 0 ||
        order[g] >= groups) {
      return false;
    }
    ++seen[order[g]];
    if (hi[g] > *hi_max) *hi_max = hi[g];
  }
  for (int g = 0; g < groups; ++g) {
    if (seen[g] != 1) return false;
  }
  return true;
}

// Whether the double plan is one the kernel reads right: the windows (lo,
// hi) and order fit; passes of at most kOpen groups whose windows nest,
// each in one part; each pass's segments tiling the union of its windows
// in ascending taps, at most kChunk taps each, of whole k-steps past
// jbase, each covered by exactly its pass's first n groups; 16-byte
// aligned weights; and the grid.
bool plan_fits(const FirPlan& p, const int* lo, const int* hi,
               long long rows, long long t_len, long long tiles,
               size_t* bytes) {
  int hi_max = 0;
  if (p.parts < 1 || p.parts > kMaxParts || p.passes < p.parts ||
      p.passes > kMaxPasses || p.segments < p.passes ||
      p.segments > kMaxSegments ||
      !windows_fit(p.groups, p.jbase, lo, hi, p.order, kKAlign, t_len,
                   &hi_max)) {
    return false;
  }
  if (p.pass_start[0] != 0 || p.pass_start[p.passes] != p.groups ||
      p.part_pass[0] != 0 || p.part_pass[p.parts] != p.passes ||
      p.part_seg[0] != 0 || p.part_seg[p.parts] != p.segments) {
    return false;
  }
  for (int q = 0; q < p.parts; ++q) {
    if (p.part_pass[q + 1] <= p.part_pass[q] ||
        p.part_seg[q + 1] <= p.part_seg[q]) {
      return false;
    }
  }
  int i = 0;     // the segments, pass by pass
  for (int q = 0; q < p.parts; ++q) {
    if (i != p.part_seg[q]) return false;
    for (int k = p.part_pass[q]; k < p.part_pass[q + 1]; ++k) {
      const int a = p.pass_start[k];
      const int n = p.pass_start[k + 1] - a;
      if (n < 1 || n > kOpen) return false;
      for (int c = 1; c < n; ++c) {
        const int g = p.order[a + c], h = p.order[a + c - 1];
        if (lo[g] < lo[h] || hi[g] > hi[h]) return false;
      }
      int j = lo[p.order[a]];
      for (;; ++i) {
        if (i >= p.part_seg[q + 1]) return false;
        const Segment s = segment(p.seg[i]);
        if (s.j0 != j || s.taps < 0 || s.taps > kChunk ||
            s.taps % kKAlign != 0 || s.cover > n ||
            s.weights % kGroupChannels != 0 || s.weights < 0) {
          return false;
        }
        for (int c = 0; c < n; ++c) {
          const int g = p.order[a + c];
          const bool in = lo[g] <= j && j + s.taps <= hi[g];
          const bool out = j + s.taps <= lo[g] || hi[g] <= j;
          if (s.taps > 0 && (c < s.cover ? !in : !out)) return false;
        }
        j += s.taps;
        if (s.end) break;
      }
      if (j != hi[p.order[a]]) return false;
      ++i;
    }
  }
  if (i != p.segments) return false;
  return grid_fits<double>(p.parts, p.jbase, p.strip_rows, hi_max, rows,
                           t_len, tiles, bytes);
}

// Whether the float plan is one the kernel reads right: the windows and
// order fit, each part holds a group, each group's weights start 32-byte
// aligned; and the grid.
bool plan_fits(const GroupPlan& p, long long rows, long long t_len,
               long long tiles, size_t* bytes) {
  int hi_max = 0;
  if (p.parts < 1 || p.parts > kMaxParts || p.parts > p.groups ||
      !windows_fit(p.groups, p.jbase, p.lo, p.hi, p.order, kAlign, t_len,
                   &hi_max)) {
    return false;
  }
  for (int g = 0; g < p.groups; ++g) {
    if (p.offset[g] < 0 || p.offset[g] % kGroupChannels != 0) return false;
  }
  if (p.part_start[0] != 0 || p.part_start[p.parts] != p.groups) return false;
  for (int q = 0; q < p.parts; ++q) {
    if (p.part_start[q + 1] <= p.part_start[q]) return false;
  }
  return grid_fits<float>(p.parts, p.jbase, p.strip_rows, hi_max, rows,
                          t_len, tiles, bytes);
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

// The double table: [jbase, lo[G], hi[G], parts, passes, segments,
// order[G], pass_start[passes + 1], part_pass[parts + 1], part_seg[parts +
// 1], seg_x[segments], seg_y[segments]] (ops/cuda_fir.py::FirLayout.tables).
bool read_table(FirPlan* plan, int* lo, int* hi, const long long* table,
                int groups) {
  for (int g = 0; g < groups; ++g) {
    lo[g] = static_cast<int>(table[1 + g]);
    hi[g] = static_cast<int>(table[1 + groups + g]);
  }
  const long long* t = table + 1 + 2 * groups;
  if (t[0] < 1 || t[0] > kMaxParts || t[1] < 1 || t[1] > kMaxPasses ||
      t[2] < 1 || t[2] > kMaxSegments) {
    return false;
  }
  plan->parts = static_cast<int>(t[0]);
  plan->passes = static_cast<int>(t[1]);
  plan->segments = static_cast<int>(t[2]);
  t += 3;
  for (int g = 0; g < groups; ++g) plan->order[g] = static_cast<int>(t[g]);
  t += groups;
  for (int k = 0; k <= plan->passes; ++k) {
    plan->pass_start[k] = static_cast<int>(t[k]);
  }
  t += plan->passes + 1;
  for (int q = 0; q <= plan->parts; ++q) {
    plan->part_pass[q] = static_cast<int>(t[q]);
    plan->part_seg[q] = static_cast<int>(t[plan->parts + 1 + q]);
  }
  t += 2 * (plan->parts + 1);
  for (int i = 0; i < plan->segments; ++i) {
    if (t[i] < 0 || t[i] > INT_MAX || t[plan->segments + i] < 0 ||
        t[plan->segments + i] > INT_MAX) {
      return false;
    }
    plan->seg[i] = make_int2(static_cast<int>(t[i]),
                             static_cast<int>(t[plan->segments + i]));
  }
  return true;
}

// The float table: [jbase, lo[G], hi[G], offset[G], parts, order[G],
// part_start[parts + 1]] (ops/cuda_fir.py::FirPlan.tables).
bool read_table(GroupPlan* plan, const long long* table, int groups) {
  for (int g = 0; g < groups; ++g) {
    plan->lo[g] = static_cast<int>(table[1 + g]);
    plan->hi[g] = static_cast<int>(table[1 + groups + g]);
    plan->offset[g] = static_cast<int>(table[1 + 2 * groups + g]);
  }
  const long long* parts = table + 1 + 3 * groups;
  if (parts[0] < 1 || parts[0] > kMaxParts) return false;
  plan->parts = static_cast<int>(parts[0]);
  for (int g = 0; g < groups; ++g) {
    plan->order[g] = static_cast<int>(parts[1 + g]);
  }
  for (int q = 0; q <= plan->parts; ++q) {
    plan->part_start[q] = static_cast<int>(parts[1 + groups + q]);
  }
  return true;
}

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
  PlanOf<T> plan{};
  plan.groups = groups;
  plan.jbase = static_cast<int>(table[0]);
  plan.strip_rows = static_cast<int>(strip_rows);
  size_t bytes = 0;
  bool fits = false;
  if constexpr (sizeof(T) == 8) {
    int lo[kMaxGroups], hi[kMaxGroups];
    fits = read_table(&plan, lo, hi, table, groups) &&
           plan_fits(plan, lo, hi, rows, t_len, tiles, &bytes);
  } else {
    fits = read_table(&plan, table, groups) &&
           plan_fits(plan, rows, t_len, tiles, &bytes);
  }
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem<T>(bytes);
  if (err != 0) return err;
  fir_bank_kernel<T>
      <<<static_cast<unsigned>(rows * tiles * plan.parts), kThreads<T>,
         bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(hist),
          static_cast<const T*>(w), static_cast<T*>(re), static_cast<T*>(im),
          t_len, t_len / kSub, tiles, plan);
  return static_cast<int>(cudaGetLastError());
}

// The FP64 tensor cores' rate per mma shape: each warp runs `iters`
// rounds of 4 independent mma.sync of one shape on values in registers
// (0: m8n8k4, 1: m16n8k4, 2: m16n8k8, 3: m16n8k16) and writes its sums
// to out[thread], so that none is dropped.
template <int kShape>
__global__ void __launch_bounds__(256) mma_rate_kernel(long long iters,
                                                       double* out) {
  const double v = 1.0 + 1e-9 * threadIdx.x;
  double d[4][4] = {};
  for (long long it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if constexpr (kShape == 0) {
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
            : "+d"(d[u][0]), "+d"(d[u][1])
            : "d"(v), "d"(v));
      } else if constexpr (kShape == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+d"(d[u][0]), "+d"(d[u][1]), "+d"(d[u][2]), "+d"(d[u][3])
            : "d"(v), "d"(v), "d"(v));
      } else if constexpr (kShape == 2) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+d"(d[u][0]), "+d"(d[u][1]), "+d"(d[u][2]), "+d"(d[u][3])
            : "d"(v), "d"(v), "d"(v), "d"(v), "d"(v), "d"(v));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
            "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
            : "+d"(d[u][0]), "+d"(d[u][1]), "+d"(d[u][2]), "+d"(d[u][3])
            : "d"(v), "d"(v), "d"(v), "d"(v), "d"(v), "d"(v), "d"(v),
              "d"(v), "d"(v), "d"(v), "d"(v), "d"(v));
      }
    }
  }
  double s = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s += d[u][e];
  }
  out[static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// One launch on `stream`; returns cudaGetLastError() (0 = ok).  x: hp2
// [rows, t_len]; hist (nullable = zeros): [rows, 1472], the history's last
// samples; w: the packed weights (ops/cuda_fir.py::packed_weight); re, im:
// [rows, 40, t_len / 32]; tiles and strip_rows from ops/cuda_fir.py::
// launch_grid; table: the host plan for its parts (ops/cuda_fir.py::
// kernel_table).
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

// mma_rate_kernel<shape> on `blocks` blocks of 256 threads; out: [blocks
// x 256] doubles.
int peaq_fir_mma_rate(int shape, long long iters, int blocks, void* out,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<double*>(out);
  switch (shape) {
    case 0: mma_rate_kernel<0><<<blocks, 256, 0, s>>>(iters, o); break;
    case 1: mma_rate_kernel<1><<<blocks, 256, 0, s>>>(iters, o); break;
    case 2: mma_rate_kernel<2><<<blocks, 256, 0, s>>>(iters, o); break;
    case 3: mma_rate_kernel<3><<<blocks, 256, 0, s>>>(iters, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
