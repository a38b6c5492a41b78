#!/usr/bin/env python3
"""Long-form streaming benchmark: an hour-scale stereo program in O(1)
memory, on one device (the port of tools/longform_bench.py, BASELINE
config 4).

The program goes through PeaqStream (PeaqStreamAdvanced with --advanced)
in 10 s host pieces, chunk steps of --chunk FFT frames with the state
carried on the device.  With --streams N > 1 the same program length runs
as N lockstep streams through PeaqStreamPool, one chunk step for all of
them; the reported throughput is the aggregate.  Run from anywhere:

  python3 gstpeaq_tpu_torch/tools/longform_bench.py [--minutes 60]
      [--advanced] [--chunk 1024] [--streams N] [--pcm16]
      [--device-source] [--precision TIER]

Prints a progress line to stderr every 300 s of audio, then the rate and
the final ODG (and DI, or the pool's median, min and max).  The device is
CUDA unless GSTPEAQ_PLATFORM names another (`cpu`); without CUDA and
without that variable the tool exits 1.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gstpeaq_tpu_torch import api  # noqa: E402
from gstpeaq_tpu_torch.parallel.batch import to_pcm16  # noqa: E402
from gstpeaq_tpu_torch.parallel.stream import (  # noqa: E402
    PeaqStream, PeaqStreamAdvanced, PeaqStreamPool)
from gstpeaq_tpu_torch.utils.checkpoint import tree_flatten  # noqa: E402

FEED = 48000 * 10       # 10 s host pieces
BASE = 48000 * 30       # the base program's length


def base_program() -> tuple[np.ndarray, np.ndarray]:
    """The 30 s base (ref, test), float32 [BASE], which tiles with
    continuous phase: f0 = 331 Hz and the 4 Hz AM both complete integer
    cycles in 30 s.  Harmonic-rich to ~15 kHz, since the BandwidthRef MOV
    only accumulates frames whose reference bandwidth exceeds bin 346
    (~8.1 kHz, src/movs.c:775-809): over a band-limited tone the ODG is
    NaN (the reference's 0/0).  The test is the same stack low-passed at
    10 kHz, codec-like."""
    tt = np.arange(BASE) / 48000.0
    f0 = 331.0
    ref_b = np.zeros(BASE)
    test_b = np.zeros(BASE)
    k = 1
    while k * f0 < 15000.0:
        tone = np.sin(2 * np.pi * k * f0 * tt + 0.3 * k) / k
        ref_b += tone
        if k * f0 < 10000.0:
            test_b += tone
        k += 1
    am = 1.0 + 0.3 * np.sin(2 * np.pi * 4.0 * tt)
    return ((0.5 * ref_b * am).astype(np.float32),
            (0.485 * test_b * am).astype(np.float32))


def feeds(ref_b, test_b, total: int, streams: int = 1, pcm16: bool = False):
    """The program's host pieces (ref, test) in order, FEED samples each
    (the last may be shorter) up to `total`: slices of the base with fresh
    1e-4 white noise on the test from default_rng(0).  One stream: [T, 2]
    each, both channels alike; a pool: [N, T, 2], the same ref for every
    stream and each stream's test with a noise floor of its own.  int16
    PCM with `pcm16`."""
    rng = np.random.default_rng(0)
    done = 0
    while done < total:
        n = min(FEED, total - done)
        off = done % BASE          # FEED divides BASE: no wrap
        ref1 = ref_b[off:off + n]
        test1 = test_b[off:off + n] + (1e-4 * rng.standard_normal(n)
                                       ).astype(np.float32)
        if streams > 1:
            noise = (1e-4 * rng.standard_normal((streams - 1, n))
                     ).astype(np.float32)
            tests1 = np.concatenate(
                [test1[None], test_b[off:off + n][None] + noise])
            ref = np.broadcast_to(ref1[None, :, None], (streams, n, 2))
            test = np.repeat(tests1[:, :, None], 2, axis=2)
        else:
            ref = np.stack([ref1, ref1], 1)
            test = np.stack([test1, test1], 1)
        if pcm16:
            ref, test = to_pcm16(ref), to_pcm16(test)
        yield ref, test
        done += n


def device_source_bench(pool, args, ref_b, test_b, total) -> int:
    """Carried-state device streaming rate: stage ONE chunk pair per path
    (FFT / FB) on the device, then run the pool's chunk steps back to back
    with the state carried on the device, FFT:FB at 3:1.  The repeated
    chunk makes the running ODG meaningless as a quality number but runs
    exactly the production sequence of steps."""
    if not isinstance(pool, PeaqStreamPool):
        raise SystemExit("--device-source needs --streams>1")
    ns = args.streams
    paths, states = pool.chunk_steps()
    rng = np.random.default_rng(1)

    def chunk(steps):
        """Each part's staged (ref, test) [streams, CH, need] on its
        device."""
        n_samp = steps[0].need
        reps = -(-n_samp // ref_b.shape[0])
        r1 = np.tile(ref_b, reps)[:n_samp]
        t1 = (np.tile(test_b, reps)[:n_samp]
              + (1e-4 * rng.standard_normal(n_samp)).astype(np.float32))
        out = []
        for step in steps:
            r, t = (np.broadcast_to(x, (step.streams, 2, n_samp))
                    for x in (r1, t1))
            if args.pcm16:
                r, t = to_pcm16(r), to_pcm16(t)
            out.append(tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
                step.device) for x in (r, t)))
        return out

    fft_stride = paths[0][0].take
    fft_op = (paths[0], chunk(paths[0]))
    ops = [fft_op]
    if args.advanced:
        # the FB path takes 3x the FFT stride per step (192 * 16 vs 1024
        # samples per "chunk frame"): 3 FFT steps per FB step keep both
        # paths at the same audio clock, as the real drain does
        assert paths[1][0].take == 3 * fft_stride
        ops = [fft_op, fft_op, fft_op, (paths[1], chunk(paths[1]))]

    def advance(states):
        for steps, staged in ops:
            states = [step.run(state, r, t) for step, state, (r, t)
                      in zip(steps, states, staged)]
        return states

    def sync(states):
        for state in states:
            tree_flatten(state)[0].cpu()

    # warm (cuFFT plans, the kernels' first launch) outside the clock
    states = advance(states)
    sync(states)
    stride = fft_stride * (3 if args.advanced else 1)
    t0 = time.time()
    done = 0
    while done < total:
        states = advance(states)
        done += stride
    sync(states)  # host sync
    dt = time.time() - t0
    agg = ns * done / 48000
    print(f"device-source: {agg:.0f} audio-sec in {dt:.1f}s "
          f"({agg/dt:.0f} audio-sec/s aggregate, {ns} streams, "
          f"carried state, transfers excluded)")
    return 0


def main(argv=None, observe=None) -> int:
    """The tool; `observe(done, stream)`, if given, is called after each
    feed with the samples fed per stream so far (chip_smoke.py reads the
    device memory and the final result through it)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--minutes", type=float, default=60.0)
    parser.add_argument("--advanced", action="store_true")
    parser.add_argument("--chunk", type=int, default=1024,
                        help="chunk size in FFT frames (bigger chunks = "
                        "fewer chunk steps, each with more work)")
    parser.add_argument("--streams", type=int, default=1,
                        help="concurrent lockstep streams (PeaqStreamPool)")
    parser.add_argument("--pcm16", action="store_true",
                        help="feed int16 PCM (dequantized on the device): "
                        "halves the per-chunk transfer")
    parser.add_argument("--device-source", action="store_true",
                        help="stage ONE chunk pair on the device and drive "
                        "the chunk steps directly: measures the carried-"
                        "state device streaming rate with host->device "
                        "transfers excluded")
    parser.add_argument("--precision", choices=sorted(api.DTYPES),
                        default=None,
                        help=f"precision tier (default {api.DEFAULT_DTYPE})")
    args = parser.parse_args(argv)

    device = api.platform_device("longform_bench")
    if device is None:
        return 1

    ns = args.streams
    if ns > 1:
        stream = PeaqStreamPool(ns, channels=2, chunk_frames=args.chunk,
                                dtype=args.precision, advanced=args.advanced,
                                device=device)
    else:
        cls = PeaqStreamAdvanced if args.advanced else PeaqStream
        stream = cls(channels=2, chunk_frames=args.chunk,
                     dtype=args.precision, device=device)

    total = int(args.minutes * 60 * 48000)
    ref_b, test_b = base_program()
    if args.device_source:
        return device_source_bench(stream, args, ref_b, test_b, total)

    t0 = time.time()
    done = 0
    for ref, test in feeds(ref_b, test_b, total, ns, args.pcm16):
        stream.feed(ref, test)
        done += ref.shape[-2]
        if observe is not None:
            observe(done, stream)
        if done % (FEED * 30) == 0:
            cur = stream.current()
            odg = cur.odg if ns == 1 else float(np.median(cur.odg))
            el = time.time() - t0
            print(f"# {done/48000:.0f}s fed, "
                  f"{ns * done/48000/el:.1f}x realtime aggregate, "
                  f"running ODG {odg:.3f}", file=sys.stderr, flush=True)
    res = stream.finalize()
    dt = time.time() - t0
    agg = ns * total / 48000
    print(f"processed {agg:.0f} audio-sec in {dt:.1f}s "
          f"({agg/dt:.1f}x realtime aggregate = {agg/dt:.0f} audio-sec/s, "
          f"{ns} stream{'s' if ns > 1 else ''})")
    if ns > 1:
        print(f"ODG median {np.median(res.odg):.3f} "
              f"min {res.odg.min():.3f} max {res.odg.max():.3f}")
    else:
        print(f"ODG {res.odg:.3f}  DI {res.di:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
