// The data-boundary gate, for Hopper (sm_90a): G1 frame_gate.
// BS.1387 / src/gstpeaq.c:1080-1099.
//
// G1 is not a TPU kernel.  The JAX package leaves the gate to XLA, which
// fuses it under jit (gstpeaq_tpu/ops/framing.py:92 above_threshold_signal);
// the port ran it as eager passes over the whole signal (|x|, four shifted
// adds, a max over channels, a cat and two block maxima), after a cast of
// the signal to the spectrum type T.  Per pair (its channels c, hop blocks
// h of `step` samples, a(j) = |x_c(j)| in T):
//   w_c(j) = (((a(j) + a(j-1)) + a(j-2)) + a(j-3)) + a(j-4),   j >= 4
//   G(j)   = max over c of w_c(j), and 0 for j < 4
//   tail(h) = max G over offsets 5..step-1 of hop h >= threshold
//   full(h) = max G over all offsets of hop h       >= threshold
//   frame f = tail(f) | full(f + 1)   (FFT: frame 2048, hop 1024)
//   frame f = tail(f)                 (FB: frame = hop = 192)
// A window ends at frame-local i >= 5 exactly when it lies inside its frame,
// so the frames are never cut out of the signal.
//
// What bounds it on the H100: bytes.  It must read each sample once, in
// its input type (float or double), and write one bool a frame: the
// basic batch [64, 2, 525312] of float is 269 MB, 80 us at 3.35 TB/s; the
// operations (5 a sample and channel) are far below it.  Design: one block
// of 256 threads a (pair, tile of whole hops of at most 16 KB of T: 4,096
// float samples, 4 FFT or 21 FB hops; 2,048 double, 2 or 10).  Channel by
// channel, the block stages |x| of its tile in T in shared memory, with a
// 4-sample halo before it (which the tile before reads too: 4 samples in
// 2,048 or more), each warp reading contiguous samples, 8 loads in flight
// a thread; each thread then forms the window sums at its 16 (float) or 8
// (double) positions, 256 apart, and keeps their running maximum over
// channels in registers.  The maxima go to shared memory, and a warp a hop
// reduces its tail and full maxima.  So every sample is read once,
// converted to T on the fly (no cast of the signal first), and nothing but
// the frame bits reaches device memory.  Frame f's two hops can lie in two tiles: each
// block sets out[f] = 1 where its hop's bit is set and writes nothing
// else, on an output the host zeroes, so no block waits for another.
// The window sum is rounded op for op as the plain version rounds it
// (__fadd_rn / __dadd_rn, in that order, never contracted), the maxima are
// exact, and a NaN wins every maximum as in torch.amax (NaN >= threshold
// is false), so the bits equal the plain version's in both types.
// Offsets are 64-bit.

#include <climits>

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;       // a tile's bytes of T, at most
constexpr int kHalo = 4;                // a window's samples before its end
constexpr int kTailFrom = 5;            // the frame-local i >= 5 rule
constexpr int kLoads = 8;               // a thread's loads in flight

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// torch.amax's max: a NaN on either side wins
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_max_nan(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// The samples of a tile of T, at most
template <typename T>
__host__ __device__ constexpr int tile_of() {
  return kTileBytes / static_cast<int>(sizeof(T));
}

// One block a (pair p, tile of hops); blocks in pair-major order.  sig
// holds pair p's channel c at sig + p pair_stride + c ch_stride, its
// samples contiguous; out is [pairs][n_frames], zeroed by the host.
template <typename In, typename T>
__global__ void __launch_bounds__(kThreads)
frame_gate_kernel(const In* __restrict__ sig, long long pair_stride,
                  long long ch_stride, int channels, int step,
                  int tile_hops, long long n_hops, int tiles,
                  long long n_frames, int fft_form, T threshold,
                  bool* __restrict__ out) {
  constexpr int kTile = tile_of<T>();
  constexpr int kPer = kTile / kThreads;  // positions a thread
  __shared__ T s_a[kHalo + kTile];
  // 32-bit: the host keeps the grid within INT_MAX blocks
  const int p = static_cast<int>(blockIdx.x) / tiles;
  const int tile = static_cast<int>(blockIdx.x) - p * tiles;
  const long long h0 = static_cast<long long>(tile) * tile_hops;
  const int hops = static_cast<int>(
      n_hops - h0 < tile_hops ? n_hops - h0 : tile_hops);
  const int len = hops * step;
  const long long j0 = h0 * step;            // the tile's first sample
  T m[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) m[q] = -static_cast<T>(INFINITY);
  for (int c = 0; c < channels; ++c) {
    const In* x = sig + p * pair_stride + c * ch_stride + j0;
    if (threadIdx.x < kHalo) {
      const int i = static_cast<int>(threadIdx.x) - kHalo;
      s_a[threadIdx.x] =
          j0 + i >= 0 ? abs_t(static_cast<T>(x[i])) : T(0);
    }
    // kLoads loads in flight a thread before their stores
#pragma unroll
    for (int q0 = 0; q0 < kPer; q0 += kLoads) {
      In v[kLoads];
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int i = (q0 + q) * kThreads + threadIdx.x;
        v[q] = i < len ? x[i] : In(0);
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        s_a[kHalo + (q0 + q) * kThreads + threadIdx.x] =
            abs_t(static_cast<T>(v[q]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = q * kThreads + threadIdx.x;
      const T* a = s_a + kHalo + i;
      T w = T(0);
      if (j0 + i >= kHalo) {
        w = add_rn(add_rn(add_rn(add_rn(a[0], a[-1]), a[-2]), a[-3]), a[-4]);
      }
      m[q] = max_nan(m[q], w);
    }
    __syncthreads();   // every window is formed before the next channel
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) s_a[q * kThreads + threadIdx.x] = m[q];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int hl = threadIdx.x / 32; hl < hops; hl += kWarps) {
    const T* g = s_a + hl * step;
    T tail = -static_cast<T>(INFINITY), full = tail;
    for (int o = lane; o < step; o += 32) {
      full = max_nan(full, g[o]);
      if (o >= kTailFrom) tail = max_nan(tail, g[o]);
    }
    tail = warp_max_nan(tail);
    full = warp_max_nan(full);
    if (lane == 0) {
      const long long h = h0 + hl;
      bool* row = out + static_cast<long long>(p) * n_frames;
      if (tail >= threshold && h < n_frames) row[h] = true;
      if (fft_form && full >= threshold && h >= 1 && h - 1 < n_frames) {
        row[h - 1] = true;
      }
    }
  }
}

template <typename T>
int launch_frame_gate(const void* sig, int in_double, long long pairs,
                      int channels, long long pair_stride,
                      long long ch_stride, long long n_frames, int step,
                      int fft_form, double threshold, void* out,
                      void* stream) {
  if (pairs < 0 || channels < 1 || n_frames < 0 || step < kTailFrom + 1 ||
      step > tile_of<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_hops = n_frames + (fft_form ? 1 : 0);
  const int tile_hops = tile_of<T>() / step;
  const long long tiles = (n_hops + tile_hops - 1) / tile_hops;
  if (n_frames > 0 && pairs > INT_MAX / tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs > 0 && n_frames > 0) {
    const auto blocks = static_cast<unsigned>(pairs * tiles);
    const int t = static_cast<int>(tiles);
    const auto s = static_cast<cudaStream_t>(stream);
    const T th = static_cast<T>(threshold);
    if (in_double) {
      frame_gate_kernel<double, T><<<blocks, kThreads, 0, s>>>(
          static_cast<const double*>(sig), pair_stride, ch_stride, channels,
          step, tile_hops, n_hops, t, n_frames, fft_form, th,
          static_cast<bool*>(out));
    } else {
      frame_gate_kernel<float, T><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(sig), pair_stride, ch_stride, channels,
          step, tile_hops, n_hops, t, n_frames, fft_form, th,
          static_cast<bool*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The suffix names the spectrum type T the samples are converted to.
// frame_gate: sig of float (in_double = 0) or double (1), pair p's channel
// c at p pair_stride + c ch_stride elements, its (n_frames + fft_form)
// step samples contiguous; fft_form 1: frame 2 step, hop step; 0: frame =
// hop = step; out [pairs][n_frames] bool, zeroed before the launch.
int peaq_frame_gate_f32(const void* sig, int in_double, long long pairs,
                        int channels, long long pair_stride,
                        long long ch_stride, long long n_frames, int step,
                        int fft_form, double threshold, void* out,
                        void* stream) {
  return launch_frame_gate<float>(sig, in_double, pairs, channels,
                                  pair_stride, ch_stride, n_frames, step,
                                  fft_form, threshold, out, stream);
}

int peaq_frame_gate_f64(const void* sig, int in_double, long long pairs,
                        int channels, long long pair_stride,
                        long long ch_stride, long long n_frames, int step,
                        int fft_form, double threshold, void* out,
                        void* stream) {
  return launch_frame_gate<double>(sig, in_double, pairs, channels,
                                   pair_stride, ch_stride, n_frames, step,
                                   fft_form, threshold, out, stream);
}

}  // extern "C"
