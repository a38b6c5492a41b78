"""Batched PEAQ over many pairs on one device: length buckets and
microbatches (gstpeaq_tpu/parallel/batch.py).

Pairs are zero-padded to a shared frame count per bucket, and each pair's
own frame counts (`valid`) mask the frames past its own flush frame, so
padding changes no pair's result.  Bucket frame counts are rounded up to a
coarse grid, so that batches of similar lengths share shapes.

The pipelines take the batch as a real leading axis: the hand kernels take
raw pointers through ctypes, so torch.func.vmap cannot carry them, and each
kernel runs once per microbatch at batch shapes.  The layout is the JAX
package's pair-outermost ship: signals [2(ref, test), B, CH, T], the band
domain [2, B, CH, Z, F], the accumulators [F, B, CH].
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from .. import constants as C
from ..ops import framing


def bucket_frames(n_frames: int, granularity: int = 64) -> int:
    """Round a frame count up to the bucket grid."""
    return max(granularity,
               -(-n_frames // granularity) * granularity)


def compute_buckets(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
                    advanced: bool = False, granularity: int = 64):
    """Shared bucket frame counts (n_fft[, n_fb]) for a set of pairs."""
    n_fft = max(framing.num_frames(r.shape[0], t.shape[0],
                                   C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
                for r, t in zip(refs, tests))
    n_fft = bucket_frames(n_fft, granularity)
    if not advanced:
        return (n_fft,)
    n_fb = max(framing.num_frames(r.shape[0], t.shape[0],
                                  C.FB_FRAMESIZE, C.FB_FRAMESIZE)
               for r, t in zip(refs, tests))
    # the JAX package's FB grid: granularity * 6, rounded up to a multiple
    # of 256 from granularity 32 on (its fused spread's tile), kept so that
    # both packages put the same pairs in the same buckets
    g_fb = granularity * 6
    if granularity >= 32 and g_fb % 256:
        g_fb = -(-g_fb // 256) * 256
    return (n_fft, bucket_frames(n_fb, g_fb))


def as_2d_ship(x):
    """[T]/[T, C] -> [T, C], keeping int16 sources int16 (the PCM16 ship:
    raw transfer, dequantized on the device by framing.dequantize, half the
    host-to-device bytes); everything else converts to float32."""
    if getattr(x, "dtype", None) == np.int16:
        return x if x.ndim == 2 else x[:, None]
    from .. import api
    return api._as_2d_f32(x)


def to_pcm16(x: np.ndarray) -> np.ndarray:
    """int16 PCM of a float source in [-1, 1) (x * 32768, rounded and
    clipped), the ship form of a sweep or a stream fed `--pcm16`; int16
    sources pass through untouched."""
    if x.dtype == np.int16:
        return x
    return np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)


def _ship_dtype(refs, tests):
    """int16 when EVERY source is int16, else float32."""
    if all(s.dtype == np.int16 for s in refs) and \
            all(s.dtype == np.int16 for s in tests):
        return np.int16
    return np.float32


def _pad_pairwise(refs, tests, buckets, out: np.ndarray) -> np.ndarray:
    """Write each pair's signals channel-major into out [2, B, CH, T] (zero)
    and return the pairs' own frame counts, [paths, B] int64.  Basic: each
    pair is truncated at its own flush-frame boundary (audio past the flush
    frame is dropped by the reference, src/gstpeaq.c:715-745).  Advanced
    (the unified input): at T, since both paths read prefixes of the same
    array; the valid counts mask what lies past each path's own frames."""
    sizes = ((C.FFT_FRAMESIZE, C.FFT_STEPSIZE),
             (C.FB_FRAMESIZE, C.FB_FRAMESIZE))[:len(buckets)]
    valid = np.empty((len(buckets), len(refs)), dtype=np.int64)
    for i, (r, t) in enumerate(zip(refs, tests)):
        valid[:, i] = [framing.num_frames(r.shape[0], t.shape[0], size, step)
                       for size, step in sizes]
        keep = out.shape[-1] if len(buckets) > 1 else framing.padded_length(
            int(valid[0, i]), C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
        for j, sig in enumerate((r, t)):
            take = min(keep, sig.shape[0])
            out[j, i, :, :take] = sig[:take].T
    return valid


def prepare_chunk(refs, tests, buckets, pin: bool = False):
    """Pad one chunk of [T, C] pairs to the shared `buckets` frame counts.

    Returns (sig [2(ref, test), B, CH, T], valid [paths, B] int64), CPU
    tensors, page-locked with `pin` (so that their copies to the card run
    asynchronously).  Basic (buckets (n_fft,)): T = (n_fft + 1) * 1024.
    Advanced (buckets (n_fft, n_fb)): ONE raw array for both paths,
    T = max((n_fft + 1) * 1024, 192 n_fb), each path reading its prefix
    (AdvancedPipeline.unified_input)."""
    ch = refs[0].shape[1]
    if any(s.shape[1] != ch for s in (*refs, *tests)):
        raise ValueError("every signal of a batch needs the same channel "
                         "count")
    length = framing.padded_length(buckets[0], C.FFT_FRAMESIZE,
                                   C.FFT_STEPSIZE)
    if len(buckets) > 1:
        length = max(length, buckets[1] * C.FB_FRAMESIZE)
    dtype = torch.int16 if _ship_dtype(refs, tests) == np.int16 \
        else torch.float32
    sig = torch.zeros((2, len(refs), ch, length), dtype=dtype,
                      pin_memory=pin)
    valid = torch.from_numpy(_pad_pairwise(refs, tests, buckets, sig.numpy()))
    return sig, valid.pin_memory() if pin else valid


def prepare_batch(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
                  advanced: bool = False, granularity: int = 64):
    """Pad a list of [T, C] pairs into one chunk: prepare_chunk at the
    pairs' compute_buckets."""
    return prepare_chunk(
        refs, tests, compute_buckets(refs, tests, advanced, granularity))


def stage(chunk, device) -> list[torch.Tensor]:
    """A prepared chunk's tensors on `device`, copied without waiting (from
    page-locked memory the copies overlap the host's work)."""
    return [a.to(device, non_blocking=True) for a in chunk]


def dispatch(pipe, buckets, sig: torch.Tensor,
             valid: torch.Tensor | None = None):
    """Score one chunk, on the pipeline's device: sig [2, B, CH, T] and
    valid [paths, B] from prepare_chunk (valid None: every pair fills its
    bucket).  Returns the pipeline's outputs without waiting for them."""
    valid = (None,) * len(buckets) if valid is None else tuple(valid)
    if len(buckets) == 1:
        return pipe(sig[0], sig[1], valid[0])
    return pipe.unified_input(sig, *buckets, *valid)


def results(out) -> torch.Tensor:
    """A pipeline's outputs as one float64 tensor [B, 2 + M]: ODG, DI, then
    the MOVs (one copy to the host per chunk)."""
    return torch.cat([out.odg[:, None], out.di[:, None], out.movs],
                     -1).to(torch.float64)


def batch_pipeline(advanced: bool, playback_level: float,
                   settings: C.Settings, dtype: str, device: torch.device):
    """The cached pipeline of one mode and precision tier on `device`."""
    from .. import api
    if dtype not in api.DTYPES:
        raise ValueError(f"dtype must be one of {sorted(api.DTYPES)}")
    if advanced:
        return api.advanced_pipeline(float(playback_level), settings, dtype,
                                     device)
    return api.pipeline(C.BASIC_BAND_COUNT, float(playback_level), settings,
                        dtype, device)


def submit(pipe, refs, tests, buckets, device: torch.device,
           microbatch: int = 8, prefetch_gb: float = 6.0,
           timings: dict | None = None) -> list:
    """Score [T, C] pairs (as_2d_ship'd) in `buckets` on `device` without
    reading any result: pad each microbatch on the host into page-locked
    memory, copy it with non_blocking copies and dispatch it.  When the
    padded pairs fit `prefetch_gb`, every chunk is staged before the first
    dispatch; more stage, dispatch and pad their chunks in turn.  The last
    chunk is padded with duplicates.  Returns [(results on the device,
    pairs to keep)] per chunk, for `collect`; fills timings' 'stage' and
    'dispatch'."""
    n = len(refs)
    mb = min(microbatch, n) if microbatch else n
    pin = device.type == "cuda"

    def chunks():
        for start in range(0, n, mb):
            # host padding happens PER MICROBATCH: a sweep-sized batch
            # would otherwise hold a second, padded copy of the corpus
            r_chunk = refs[start:start + mb]
            t_chunk = tests[start:start + mb]
            pad = mb - len(r_chunk)
            if pad:
                r_chunk = list(r_chunk) + [r_chunk[-1]] * pad
                t_chunk = list(t_chunk) + [t_chunk[-1]] * pad
            yield prepare_chunk(r_chunk, t_chunk, buckets, pin), mb - pad

    length = framing.padded_length(buckets[0], C.FFT_FRAMESIZE,
                                   C.FFT_STEPSIZE)
    if len(buckets) > 1:
        length = max(length, buckets[1] * C.FB_FRAMESIZE)
    bytes_per_pair = (np.dtype(_ship_dtype(refs, tests)).itemsize * 2
                      * refs[0].shape[1] * length)
    prefetch = -(-n // mb) * mb * bytes_per_pair <= prefetch_gb * 1e9

    from .. import api
    pending = []
    with api.full_precision_matmuls(), torch.inference_mode():
        t0 = time.perf_counter()
        if prefetch:
            staged = [(stage(chunk, device), take)
                      for chunk, take in chunks()]
            t1 = time.perf_counter()
            for chunk, take in staged:
                pending.append((results(dispatch(pipe, buckets, *chunk)),
                                take))
        else:
            t1 = t0
            for chunk, take in chunks():
                pending.append((results(dispatch(
                    pipe, buckets, *stage(chunk, device))), take))
        t2 = time.perf_counter()
    if timings is not None:
        timings.update(stage=t1 - t0, dispatch=t2 - t1)
    return pending


def collect(pending: list, timings: dict | None = None) -> np.ndarray:
    """`submit`'s results on the host, [B, 2 + M] float64: ODG, DI, then
    the MOVs; fills timings' 'first_sync' (the first chunk) and 'drain'
    (the rest)."""
    t0 = time.perf_counter()
    host = [pending[0][0].cpu()]
    t1 = time.perf_counter()
    host += [out.cpu() for out, _ in pending[1:]]
    values = np.concatenate([out[:take].numpy() for out, (_, take) in
                             zip(host, pending)])
    if timings is not None:
        timings.update(first_sync=t1 - t0,
                       drain=time.perf_counter() - t1)
    return values


def as_result(values: np.ndarray) -> dict:
    """collect's [B, 2 + M] as peaq_batch's dict."""
    return {"odg": values[:, 0], "di": values[:, 1], "movs": values[:, 2:]}


def peaq_batch(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
               advanced: bool = False, playback_level: float = 92.0,
               settings: C.Settings = C.DEFAULT_SETTINGS,
               dtype: str | None = None, granularity: int = 64,
               microbatch: int = 8, prefetch_gb: float = 6.0,
               timings: dict | None = None, device=None):
    """Compute ODG/DI/MOVs for a batch of pairs on one device.

    refs/tests: sequences of [T] or [T, C] arrays (48 kHz), float or int16
    (int16 only if every source is: PCM16 ships raw).  dtype: a precision
    tier of api.DTYPES, "float64" by default.  device: a torch device; None
    means "cuda" and raises when CUDA is absent.  The batch runs in
    `microbatch`-sized chunks, which bound the device memory (activations
    scale with pairs x frames); the last chunk is padded with duplicates,
    which are discarded.

    Each chunk is padded on the host into page-locked memory and copied
    with non_blocking copies.  When the padded batch fits `prefetch_gb`,
    every chunk is staged before the first dispatch; a larger batch stages,
    dispatches and pads its chunks in turn.  Every chunk is dispatched
    before any result is read, and the results are read once at the end
    (`submit`, then `collect`).  Returns a dict with 'odg' [B], 'di' [B],
    'movs' [B, M] float64 numpy arrays.

    `timings`, if given, is filled with wall seconds: 'stage' (host padding
    and copies to the device), 'dispatch' (every chunk's pipeline call),
    'first_sync' (the first chunk's results on the host) and 'drain' (the
    rest).
    """
    from .. import api
    dev = api.resolve_device(device)
    dtype = dtype or api.DEFAULT_DTYPE
    pipe = batch_pipeline(advanced, playback_level, settings, dtype, dev)
    refs = [as_2d_ship(r) for r in refs]
    tests = [as_2d_ship(t) for t in tests]
    if not refs or len(refs) != len(tests):
        raise ValueError("peaq_batch needs as many tests as refs, at least "
                         "one")
    buckets = compute_buckets(refs, tests, advanced, granularity)
    pending = submit(pipe, refs, tests, buckets, dev, microbatch,
                     prefetch_gb, timings)
    return as_result(collect(pending, timings))
