// The FB ear's backward masking, internal noise and forward-masking drive,
// for Hopper (sm_90a): W1 mask_frames.  BS.1387 / src/fbearmodel.c:371-395.
//
// W1 is not a TPU kernel.  The JAX package leaves these frame sums to XLA
// (gstpeaq_tpu/ops/fb_ear.py:593 back_and_forward_masking_t, a two-output
// fusion; :698 _back_mask_from_pmajor, GEMMs on the phase-split e0); the
// port ran them as eager passes over e0 (two products with the frame taps,
// each as large as e0, two sums over 6 instants, a cat for the one-frame
// shift, two adds and the drive's product).  Per row of e0 [rows, 6 F] (a
// row is one lead's band z) and frame f:
//   sb[f] = sum_r Wb[r] e0[6 f + r],  sa[f] = sum_r Wa[r] e0[6 f + r]
//           (r = 0..5, Wa[0] = 0: ops/fb_ear.py back_mask_blocks)
//   e1[f] = sb[f] + sa[f - 1], where sa[-1] = sum_{r=1..5} Wa[r] tail[r - 1]
//           (the carried state's instants 5..9) or 0 without a state
//   unsmeared[f] = e1[f] + noise[z]
//   drive[f]     = (1 - ear_a[z]) unsmeared[f]
// The drive goes on to K1, the forward masking's recurrence.
//
// What bounds it on the H100: bytes.  It must read e0 once and write two
// values a frame: in one advanced float64 microbatch e0 [2, 32, 2, 40,
// 15360] is 629 MB and unsmeared and the drive 105 MB each, 839 MB, 0.250
// ms at 3.35 TB/s (0.125 ms in float); its operations, 26 a frame, take
// ~1% of that.
//
// Design.  The frames of all rows are one flat sequence g = row F + f, so
// the instants of any run of frames are contiguous in e0, whatever F and
// the row count.  A block of kThreads threads takes a span of kSpan<T>
// consecutive frames, kFrames<T> a thread (the last block fewer), and
// stages their 6 kSpan instants in shared memory in 16-byte loads that
// stream past the caches (an even span keeps its first instant on a
// 16-byte boundary in both types; a ragged end of float instants takes
// single loads), and the frame before its span at kLead - 6 .. kLead - 1.
// Thread t then forms its frames: sb and sa of each from its six staged
// instants; sa[f - 1] of its first frame from the thread before it by a
// shuffle (lane 0 forms it from the staged frame before its own), of a
// second frame its own; at f = 0 from the carried tail or as 0; and
// writes unsmeared and the drive, each once and coalesced.  A block stages
// 12 KB in either type (a float thread takes two frames, so that a float
// block keeps as many bytes in flight as a double one), so 8 blocks of
// 256 threads reside on an SM and keep ~98 KB of e0 in flight there,
// where Little's law asks 3.35 TB/s x ~1 us / 132 SMs = ~25 KB.
// The taps, the noise and the decay are read from the constants' own
// device tensors through the read-only cache: passing them by value would
// copy them to the host, a synchronisation, in every call.  Plain
// multiplies and adds of the working type, no fast-math intrinsic.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kInstants = 6;    // instants a frame
constexpr int kThreads = 256;   // threads a block
constexpr int kLead = 8;        // staged values before the span
constexpr int kTailTaps = 5;    // carried instants a row's first frame reads
constexpr int kWarp = 32;
// frames a thread and a block
template <typename T>
constexpr int kFrames = sizeof(T) == 4 ? 2 : 1;
template <typename T>
constexpr int kSpan = kThreads * kFrames<T>;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_frames_kernel(const T* __restrict__ e0, const T* __restrict__ w,
                   const T* __restrict__ noise, const T* __restrict__ ear_a,
                   const T* __restrict__ tail, T* __restrict__ uns,
                   T* __restrict__ drive, long long frames,
                   long long n_frames, int z) {
  using V = typename Vec<T>::type;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int P = kFrames<T>;
  constexpr int kS = kSpan<T>;
  __shared__ __align__(16) T s[kLead + kInstants * kS];
  const int t = threadIdx.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * kS;
  const long long left = frames - g0;
  const int n = left < kS ? static_cast<int>(left) : kS;
  const T* src = e0 + g0 * kInstants;
  const int values = n * kInstants;
  const int vectors = values / kPer;
  for (int i = t; i < vectors; i += kThreads) {
    *reinterpret_cast<V*>(s + kLead + i * kPer) =
        __ldcs(reinterpret_cast<const V*>(src) + i);
  }
  for (int i = vectors * kPer + t; i < values; i += kThreads) {
    s[kLead + i] = __ldcs(src + i);
  }
  if (g0 > 0 && t < kInstants) {
    // the frame before the span, which the block before also reads
    s[kLead - kInstants + t] = __ldg(src - kInstants + t);
  }
  T wa[kInstants], wb[kInstants];
#pragma unroll
  for (int r = 0; r < kInstants; ++r) {
    wa[r] = __ldg(w + r);
    wb[r] = __ldg(w + kInstants + r);
  }
  __syncthreads();
  // threads past the last frame form values from unstaged shared memory
  // that nothing reads: they only take part in the shuffle
  const T* x = s + kLead + t * P * kInstants;
  T sb[P], sa[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const T* y = x + p * kInstants;
    sb[p] = wb[0] * y[0];
    sa[p] = wa[0] * y[0];
#pragma unroll
    for (int r = 1; r < kInstants; ++r) {
      sb[p] += wb[r] * y[r];
      sa[p] += wa[r] * y[r];
    }
  }
  T before = __shfl_up_sync(0xffffffffu, sa[P - 1], 1);
  if (t % kWarp == 0) {
    const T* y = x - kInstants;
    before = wa[0] * y[0];
#pragma unroll
    for (int r = 1; r < kInstants; ++r) before += wa[r] * y[r];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = t * P + p;
    if (j >= n) return;
    const long long g = g0 + j;
    const long long row = g / n_frames;
    T prev = p == 0 ? before : sa[p - 1];
    if (g == row * n_frames) {
      prev = T(0);
      if (tail != nullptr) {
        const T* q = tail + row * kTailTaps;
        prev = wa[1] * __ldg(q);
#pragma unroll
        for (int r = 2; r <= kTailTaps; ++r) {
          prev += wa[r] * __ldg(q + r - 1);
        }
      }
    }
    const int band = static_cast<int>(row % z);
    const T u = (sb[p] + prev) + __ldg(noise + band);
    uns[g] = u;
    drive[g] = (T(1) - __ldg(ear_a + band)) * u;
  }
}

template <typename T>
int launch_mask(const void* e0, const void* w, const void* noise,
                const void* ear_a, const void* tail, void* uns, void* drive,
                long long frames, long long n_frames, int z, long long blocks,
                void* stream) {
  if (frames < 1 || n_frames < 1 || z < 1 || frames % n_frames != 0 ||
      (frames / n_frames) % z != 0 ||
      reinterpret_cast<std::uintptr_t>(e0) % 16 != 0 ||
      blocks != (frames + kSpan<T> - 1) / kSpan<T> || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mask_frames_kernel<T>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(e0), static_cast<const T*>(w),
          static_cast<const T*>(noise), static_cast<const T*>(ear_a),
          static_cast<const T*>(tail), static_cast<T*>(uns),
          static_cast<T*>(drive), frames, n_frames, z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// e0: [frames / n_frames rows, 6 n_frames], 16-byte aligned, a row's band
// its index mod z; w: [2, 6] (Wa, Wb); noise, ear_a: [z]; tail (nullable =
// no state): [rows, 5], the carried instants 5..9; uns, drive: [rows,
// n_frames], each frame written once; blocks: ops/cuda_fb.py mask_grid,
// ceil(frames / kSpan<T>).
int peaq_mask_frames_f32(const void* e0, const void* w, const void* noise,
                         const void* ear_a, const void* tail, void* uns,
                         void* drive, long long frames, long long n_frames,
                         int z, long long blocks, void* stream) {
  return launch_mask<float>(e0, w, noise, ear_a, tail, uns, drive, frames,
                            n_frames, z, blocks, stream);
}

int peaq_mask_frames_f64(const void* e0, const void* w, const void* noise,
                         const void* ear_a, const void* tail, void* uns,
                         void* drive, long long frames, long long n_frames,
                         int z, long long blocks, void* stream) {
  return launch_mask<double>(e0, w, noise, ear_a, tail, uns, drive, frames,
                             n_frames, z, blocks, stream);
}

}  // extern "C"
