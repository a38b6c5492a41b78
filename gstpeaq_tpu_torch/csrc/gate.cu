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
// so the frames are never cut out of the signal.  No frame reads full(0),
// the one maximum over windows that end at j < 4.
//
// What bounds it on the H100: bytes.  It must read each sample once, in
// its input type In (float or double), and write one bool a frame: the
// basic batch [64, 2, 525312] of float is 269 MB, 80 us at 3.35 TB/s; the
// operations (5 a sample and channel) are far below it.
//
// Design.  A persistent grid: the host planner (ops/cuda_gate.py
// gate_plan) cuts each pair's frames into `spans` spans of `span` frames,
// about kResident blocks an SM in all and no span under one tile, and one
// block of kThreads threads walks one span.  A block owns the frames of
// its span and writes each of them once, so the output needs no fill: in
// the FFT form it reads one hop past its span, since its last frame's
// full maximum lies there (at the batch shapes spans of 43 frames or more
// keep that hop under ~3% of the bytes).  The span's hops are cut into
// tiles of tile_hops whole hops of at most kTileBytes of the input type In
// (4,096 float samples, 2,048 double: a float64-tier block moves as many
// bytes as a float32 one), and each channel of a tile is one item of a
// ring of kStages stages in shared memory, in the input type: a tile's
// samples and the kHalo samples before it, converted to T only when a
// window is formed.  At the batch shapes a resident SM keeps
//   kResident x (kStages - 1) x (4,096 + 4) x 4 B = 3 x 3 x 16,400 B
// = 148 KB of samples in flight, where Little's law asks 3.35 TB/s x ~1 us
// / 132 SMs = ~25 KB.  An item whose source and size are 16-byte aligned
// is one cp.async.bulk (TMA 1-D) that completes on its stage's mbarrier;
// an item that is not (a row one sample off, a hop of an odd length)
// takes cp.async copies of 4 or 8 bytes by every thread, one commit group
// an item.  Each thread forms the windows at a contiguous run of `run`
// positions inside one hop (16 at the FFT form's 1,024-sample hops and
// the FB form's 192 in float samples: 64 and 12 threads a hop; 8 in
// double), reading its run and the 4 samples before it from the stage in
// 16-byte loads where the hop allows, and keeps in registers, over the
// tile's channels, the largest window at offsets >= kTailFrom and below
// it (in float samples with the sums of |x| that say where a NaN window
// lies).  After a
// tile's last channel a segmented reduction combines the threads of each
// hop: shuffles within each warp, then one shared partial for each warp a
// hop touches (the 12-thread hops of the FB form share warps), which a
// lane of warp 0 a hop combines into the hop's bits; lane h then writes
// frame h - 1 of the FFT form (the tile's previous hop's tail bit by
// shuffle, the tile before's in a register) or frame h of the FB form.
// The window sum is rounded op for op as the plain version rounds it
// (__fadd_rn / __dadd_rn, in that order, never contracted), the maxima are
// exact in any order, and a NaN wins every maximum as in torch.amax (NaN
// >= threshold is false), so the bits equal the plain version's in both
// types.  Offsets are 64-bit.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kResident = 3;            // blocks an SM the planner fills
constexpr int kStages = 4;              // the ring's stages
constexpr int kTileBytes = 16384;       // a tile's bytes of In, whole hops
constexpr int kMaxTileHops = 32;        // a tile's hops: lanes of warp 0
constexpr int kMaxStep = 4096;          // a hop's samples, at most
constexpr int kHalo = 4;                // a window's samples before its end
constexpr int kTailFrom = 5;            // the frame-local i >= 5 rule
constexpr int kNoHop = 1 << 30;         // the hop of a thread with no run

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

// The larger of m and w, exact where neither is NaN; run_windows counts
// the NaNs apart, so a NaN w may lose here.
__device__ __forceinline__ float max_num(float m, float w) {
  return fmaxf(m, w);
}
__device__ __forceinline__ double max_num(double m, double w) {
  return w > m ? w : m;
}

__device__ __forceinline__ unsigned smem_of(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_of(bar)));
}

// the stage's one arrival, expecting `bytes` from the copy it starts
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
  // the stage was last read, or written by cp.async, in the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_of(dst)),
      "l"(src), "r"(bytes), "r"(smem_of(bar))
      : "memory");
}

template <typename In>
__device__ __forceinline__ void copy_async(In* dst, const In* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_of(dst)),
               "l"(src), "n"(sizeof(In))
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// V samples from a stage: one 16-byte load where V > 1
template <int V, typename In>
__device__ __forceinline__ void load_vec(const In* a, In* x) {
  if constexpr (V == 1) {
    x[0] = a[0];
  } else if constexpr (sizeof(In) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(a);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(a);
    x[0] = q.x;
    x[1] = q.y;
  }
}

// The windows ending at a run's `len` positions a[0 .. len) (hop offsets
// off0 ..; a[0] is sample j of the signal): their maximum at offsets >=
// kTailFrom into `tail` and below it into `head`.  The samples before the
// signal's first count as 0.
//
// Float samples (the shipped kind) leave the NaNs to sums of |x| in
// float, nan_tail and nan_head, which are NaN exactly where a window is (a
// sum of |x| is NaN only where an x is), and keep the numbers' maxima
// (max_num): a tail window (offsets 5 .. step - 1) reads the hop's samples
// at offsets 1 .. step - 1, a head window (0 .. 4) those at -4 .. 4, and a
// run counts its own samples, those before the hop from its halo.
// Offsets below 5 lie in a run's first kPeel positions: those take both
// sides by predicate, so that a warp's threads never part ways, the rest
// the tail alone.  Double samples have no sum to spare (each is an FP64
// add, the pipe that bounds them): their windows take max_nan, each side
// by predicate.
template <int V, typename In, typename T>
__device__ __forceinline__ void run_windows(const In* a, int len, int off0,
                                            long long j, T& tail, T& head,
                                            In& nan_tail, In& nan_head) {
  constexpr int kPeel = 8;
  In r[kHalo];
#pragma unroll
  for (int u = 0; u < kHalo; u += V) load_vec<V>(a - kHalo + u, r + u);
#pragma unroll
  for (int u = 0; u < kHalo; ++u) {
    if (j - kHalo + u < 0) r[u] = In(0);
  }
  T a4 = abs_t(static_cast<T>(r[0])), a3 = abs_t(static_cast<T>(r[1]));
  T a2 = abs_t(static_cast<T>(r[2])), a1 = abs_t(static_cast<T>(r[3]));
  if constexpr (sizeof(In) == 8) {
    for (int e0 = 0; e0 < len; e0 += V) {
      In x[V];
      load_vec<V>(a + e0, x);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const T a0 = abs_t(static_cast<T>(x[u]));
        const T w = add_rn(add_rn(add_rn(add_rn(a0, a1), a2), a3), a4);
        if (off0 + e0 + u >= kTailFrom) {
          tail = max_nan(w, tail);
        } else {
          head = max_nan(w, head);
        }
        a4 = a3;
        a3 = a2;
        a2 = a1;
        a1 = a0;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kHalo; ++u) {
      if (off0 - kHalo + u < 0) nan_head += abs_t(r[u]);
    }
    const T none = -static_cast<T>(INFINITY);
    const int peel = len < kPeel ? len : kPeel;
    int e0 = 0;
    for (; e0 < peel; e0 += V) {
      In x[V];
      load_vec<V>(a + e0, x);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int o = off0 + e0 + u;
        const T a0 = abs_t(static_cast<T>(x[u]));
        const T w = add_rn(add_rn(add_rn(add_rn(a0, a1), a2), a3), a4);
        tail = max_num(tail, o >= kTailFrom ? w : none);
        head = max_num(head, o >= kTailFrom ? none : w);
        nan_tail += o >= 1 ? abs_t(x[u]) : In(0);
        nan_head += o < kTailFrom ? abs_t(x[u]) : In(0);
        a4 = a3;
        a3 = a2;
        a2 = a1;
        a1 = a0;
      }
    }
    for (; e0 < len; e0 += V) {
      In x[V];
      load_vec<V>(a + e0, x);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const T a0 = abs_t(static_cast<T>(x[u]));
        tail = max_num(tail,
                       add_rn(add_rn(add_rn(add_rn(a0, a1), a2), a3), a4));
        nan_tail += abs_t(x[u]);
        a4 = a3;
        a3 = a2;
        a2 = a1;
        a1 = a0;
      }
    }
  }
}

struct Plan {
  const void* sig;
  long long pair_stride, ch_stride, n_frames, span;
  int channels, step, fft_form, tile_hops, run, runs_per_hop, spans, stage;
  bool* out;
};

// Item (tile, c) of a span: channel c of its tile-th tile.  The stage
// takes the tile's samples at kHalo and the kHalo samples before them (none
// before the signal's first sample).
template <typename In>
struct Item {
  const In* src;
  int at;          // the stage slot of src[0]
  int n;           // the samples copied
  long long h0;    // the tile's first hop
  int hops;        // the tile's hops
  bool bulk;       // one TMA copy: 16-byte aligned source and size

  __device__ Item(const Plan& q, int p, long long f0, long long h_end,
                  int tile, int c) {
    h0 = f0 + static_cast<long long>(tile) * q.tile_hops;
    hops = static_cast<int>(h_end - h0 < q.tile_hops ? h_end - h0
                                                      : q.tile_hops);
    const long long j0 = h0 * q.step;
    const int lead = j0 > 0 ? kHalo : 0;
    src = static_cast<const In*>(q.sig) + p * q.pair_stride +
          c * q.ch_stride + j0 - lead;
    at = kHalo - lead;
    n = hops * q.step + lead;
    bulk = ((reinterpret_cast<uintptr_t>(src) |
             static_cast<uintptr_t>(n * sizeof(In))) & 15) == 0;
  }
};

// One block a span: pair blockIdx.x / spans, frames [f0, f1).  out is
// [pairs][n_frames], every frame written by the block that owns it.
// Shared memory: kStages stages of q.stage samples of In, then two buffers
// (by tile parity) of the warps' partial tail and full maxima, then the
// stages' mbarriers.
template <typename In, typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kResident)
frame_gate_kernel(const Plan q, T threshold) {
  constexpr int V = kVec ? 16 / static_cast<int>(sizeof(In)) : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  In* ring = reinterpret_cast<In*>(smem);
  T* part = reinterpret_cast<T*>(smem + sizeof(In) * kStages * q.stage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(part + 4 * kThreads);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // 32-bit: the host keeps the grid within INT_MAX blocks and a span's
  // items within INT_MAX
  const int p = static_cast<int>(blockIdx.x) / q.spans;
  const long long f0 =
      static_cast<long long>(static_cast<int>(blockIdx.x) - p * q.spans) *
      q.span;
  const long long f1 = f0 + q.span < q.n_frames ? f0 + q.span : q.n_frames;
  const long long h_end = f1 + q.fft_form;   // the FFT form's one more hop
  const int items = static_cast<int>(
      (h_end - f0 + q.tile_hops - 1) / q.tile_hops) * q.channels;
  // this thread's run in every tile: hop hl of the tile, offsets off0 ..
  // off0 + len - 1 of it
  const int hl = tid / q.runs_per_hop;
  const int off0 = (tid - hl * q.runs_per_hop) * q.run;
  const int len = q.run < q.step - off0 ? q.run : q.step - off0;
  const int pos = hl * q.step + off0;
  // the barriers' init reaches the copies through the proxy fence thread 0
  // takes before each bulk copy
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&bars[s]);
  }
  __syncthreads();

  // every thread queues an item (and one commit group, empty where the
  // copy is a TMA one's or there is no item), so that wait_group
  // <kStages - 1> finds item i landed at its turn; items go channel by
  // channel, tile by tile
  int next = 0, next_tile = 0, next_c = 0;
  auto issue = [&]() {
    if (next < items) {
      const Item<In> it(q, p, f0, h_end, next_tile, next_c);
      const int s = next % kStages;
      In* dst = ring + s * q.stage + it.at;
      if (it.bulk) {
        if (tid == 0) {
          const unsigned bytes = it.n * sizeof(In);
          bar_expect(&bars[s], bytes);
          bulk_copy(dst, it.src, bytes, &bars[s]);
        }
      } else {
        for (int e = tid; e < it.n; e += kThreads) {
          copy_async(dst + e, it.src + e);
        }
      }
    }
    copy_commit();
    ++next;
    if (++next_c == q.channels) {
      next_c = 0;
      ++next_tile;
    }
  };
  for (int s = 0; s < kStages; ++s) issue();

  unsigned parity = 0;           // bit s: the phase of stage s's mbarrier
  bool carry = false;            // warp 0: the tile before's last tail bit
  T tail = -static_cast<T>(INFINITY), head = tail;
  In nan_tail = 0, nan_head = 0;
  bool* row = q.out + static_cast<long long>(p) * q.n_frames;
  int tile = 0, c = 0;
  for (int i = 0; i < items; ++i) {
    const int s = i % kStages;
    const Item<In> it(q, p, f0, h_end, tile, c);
    if (it.bulk) {
      bar_wait(&bars[s], (parity >> s) & 1u);
      parity ^= 1u << s;
    } else {
      copy_wait<kStages - 1>();
      __syncthreads();
    }
    const bool mine = hl < it.hops;
    if (mine) {
      run_windows<V>(ring + s * q.stage + kHalo + pos, len, off0,
                     it.h0 * q.step + pos, tail, head, nan_tail, nan_head);
    }
    const bool last = c == q.channels - 1;
    T* buf = part + (tile & 1) * 2 * kThreads;
    if (last) {
      // segmented over the warp's hops: lane l ends with the maximum of
      // lanes l .. 31 of its hop, so a hop's first lane in the warp holds
      // the warp's part of it
      const int id = mine ? hl : kNoHop;
      if (nan_tail != nan_tail) tail = static_cast<T>(nan_tail);
      if (nan_head != nan_head) head = static_cast<T>(nan_head);
      T full = max_nan(tail, head);
      // every lane shuffles: lane 0 too, though it is always first
      const int before = __shfl_up_sync(~0u, id, 1);
      const bool first = lane == 0 || before != id;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const T t2 = __shfl_down_sync(~0u, tail, off);
        const T f2 = __shfl_down_sync(~0u, full, off);
        if (__shfl_down_sync(~0u, id, off) == id) {
          tail = max_nan(t2, tail);
          full = max_nan(f2, full);
        }
      }
      if (first && mine) {
        buf[tid] = tail;
        buf[kThreads + tid] = full;
      }
    }
    __syncthreads();             // stage s read, the partials written
    issue();
    if (last) {
      tail = head = -static_cast<T>(INFINITY);
      nan_tail = nan_head = 0;
      if (tid < 32) {
        // lane h: hop h0 + h, from its first run's partial and one at each
        // warp its runs enter
        bool tb = false, fb = false;
        if (lane < it.hops) {
          T t = -static_cast<T>(INFINITY), f = t;
          const int r1 = (lane + 1) * q.runs_per_hop;
          for (int r = lane * q.runs_per_hop; r < r1; r = (r & ~31) + 32) {
            t = max_nan(buf[r], t);
            f = max_nan(buf[kThreads + r], f);
          }
          tb = t >= threshold;
          fb = f >= threshold;
        }
        const long long h = it.h0 + lane;
        if (q.fft_form) {
          bool prev = __shfl_up_sync(~0u, static_cast<int>(tb), 1);
          if (lane == 0) prev = carry;
          if (lane < it.hops && h - 1 >= f0) row[h - 1] = prev || fb;
          carry = __shfl_sync(~0u, static_cast<int>(tb), it.hops - 1);
        } else if (lane < it.hops) {
          row[h] = tb;
        }
      }
      c = 0;
      ++tile;
    } else {
      ++c;
    }
  }
}

template <typename In, typename T, bool kVec>
int launch_kernel(const Plan& q, int shared, T threshold, long long grid,
                  cudaStream_t stream) {
  auto kernel = frame_gate_kernel<In, T, kVec>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(grid), kThreads, shared, stream>>>(
      q, threshold);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename T>
int launch_in(const Plan& q, int shared, T threshold, long long grid,
              cudaStream_t stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(In));
  if ((q.step * static_cast<int>(sizeof(In))) % 16 == 0 && q.run % V == 0) {
    return launch_kernel<In, T, true>(q, shared, threshold, grid, stream);
  }
  return launch_kernel<In, T, false>(q, shared, threshold, grid, stream);
}

template <typename T>
int launch_frame_gate(const void* sig, int in_double, long long pairs,
                      int channels, long long pair_stride,
                      long long ch_stride, long long n_frames, int step,
                      int fft_form, double threshold, int tile_hops, int run,
                      int runs_per_hop, long long span, int spans, int stage,
                      int shared, void* out, void* stream) {
  const int in_size = in_double ? 8 : 4;
  const long long need = 1LL * in_size * kStages * stage +
                         4LL * kThreads * static_cast<int>(sizeof(T)) +
                         8LL * kStages;
  if (pairs < 0 || channels < 1 || n_frames < 0 || step < kTailFrom + 1 ||
      step > kMaxStep || (fft_form != 0 && fft_form != 1) ||
      tile_hops < 1 || tile_hops > kMaxTileHops ||
      (tile_hops > 1 && tile_hops * step * in_size > kTileBytes) || run < 1 ||
      runs_per_hop < 1 || 1LL * (runs_per_hop - 1) * run >= step ||
      1LL * runs_per_hop * run < step ||
      tile_hops * runs_per_hop > kThreads ||
      stage < tile_hops * step + kHalo || (stage * in_size) % 16 != 0 ||
      shared < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs == 0 || n_frames == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  // every frame in exactly one span, no span empty; a span's items
  // (channels of at most span + 1 tiles) within INT_MAX
  if (span < 1 || spans < 1 || span * spans < n_frames ||
      span * (spans - 1) >= n_frames || pairs > INT_MAX / spans ||
      span >= INT_MAX / channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan q{sig, pair_stride, ch_stride, n_frames, span, channels, step,
               fft_form, tile_hops, run, runs_per_hop, spans, stage,
               static_cast<bool*>(out)};
  const T th = static_cast<T>(threshold);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long grid = pairs * spans;
  return in_double ? launch_in<double, T>(q, shared, th, grid, s)
                   : launch_in<float, T>(q, shared, th, grid, s);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The suffix names the spectrum type T the samples are converted to.
// frame_gate: sig of float (in_double = 0) or double (1), pair p's channel
// c at p pair_stride + c ch_stride elements, its (n_frames + fft_form)
// step samples contiguous; fft_form 1: frame 2 step, hop step; 0: frame =
// hop = step; the plan from ops/cuda_gate.py gate_plan (tile_hops, run,
// runs_per_hop, span, spans: each pair's frames in spans of span; stage:
// a stage's samples; shared: the block's bytes of shared memory); out
// [pairs][n_frames] bool, each frame written once (no fill needed).
int peaq_frame_gate_f32(const void* sig, int in_double, long long pairs,
                        int channels, long long pair_stride,
                        long long ch_stride, long long n_frames, int step,
                        int fft_form, double threshold, int tile_hops,
                        int run, int runs_per_hop, long long span, int spans,
                        int stage, int shared, void* out, void* stream) {
  return launch_frame_gate<float>(sig, in_double, pairs, channels,
                                  pair_stride, ch_stride, n_frames, step,
                                  fft_form, threshold, tile_hops, run,
                                  runs_per_hop, span, spans, stage, shared,
                                  out, stream);
}

int peaq_frame_gate_f64(const void* sig, int in_double, long long pairs,
                        int channels, long long pair_stride,
                        long long ch_stride, long long n_frames, int step,
                        int fft_form, double threshold, int tile_hops,
                        int run, int runs_per_hop, long long span, int spans,
                        int stage, int shared, void* out, void* stream) {
  return launch_frame_gate<double>(sig, in_double, pairs, channels,
                                   pair_stride, ch_stride, n_frames, step,
                                   fft_form, threshold, tile_hops, run,
                                   runs_per_hop, span, spans, stage, shared,
                                   out, stream);
}

}  // extern "C"
