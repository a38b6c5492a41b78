"""The least time an ear could take for one microbatch, from the
specification's shapes at the cell's sizes, over NVIDIA's published H100
SXM peaks (the pattern of the repository's `chip_smoke.py` `bound`,
`ops_of` and `fir_bound`, counted here per ear and not per kernel).

An ear's work, whatever kernels implement it:
- the samples it reads, each read once (float32, as the cell holds them);
- the band-domain patterns and per-frame MOV inputs it hands on, each
  written once in the cell's precision;
- for the FB ear, also the FIR bank's operations: a multiply-add (2) for
  each tap inside a channel's window of nonzero taps, at every subsampled
  instant.
The least time is the larger of the bytes over the memory rate and the
operations over the peak rate.  The FIR bank's operations count against the
FP64 tensor-core peak (67 TFLOP/s), the rate at which the card can run them
in double; against the 34 TFLOP/s outside the tensor cores a kernel that
uses them could read above 100%.
"""

from __future__ import annotations

import numpy as np

from .reference import constants as C
from .reference import earparams as EP
from .reference.torch_ref import frame_count

MEMORY_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
TENSOR_OPS_PER_S = {"float32": 67e12, "float64": 67e12}
ITEM = {"float32": 4, "float64": 8}
SAMPLE_BYTES = 4            # the cell's items are float32 on the card


def fir_window_taps() -> int:
    """Taps inside the nonzero window of each of the FIR bank's 80 real
    channels (40 bands, real and imaginary parts), summed: each band's
    filter length, the aliased lag-1456 tap of band 0 folded into lag 0
    (numpy_spec.fb_process_signal)."""
    p = EP.fb_ear_params()
    n = C.FB_BUFFER_LENGTH
    total = 0
    for h in (p.h_re, p.h_im):
        folded = h[:, :n].copy()
        folded[:, 0] += h[:, n]
        for row in folded:
            nz = np.nonzero(row)[0]
            total += int(nz[-1] - nz[0] + 1) if nz.size else 0
    return total


def least_ms(moved_bytes: float, ops: float, peak: float) -> tuple:
    """(least time in ms, what sets it)."""
    by_bytes = moved_bytes / MEMORY_BYTES_PER_S * 1e3
    by_ops = ops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def ear_work(version: str, dtype: str, pairs: int, channels: int,
             samples: int) -> dict:
    """{ear: (least ms, bound by, bytes, operations)} for one microbatch of
    `pairs` pairs of `channels` x `samples`."""
    item = ITEM[dtype]
    read = 2 * pairs * channels * samples * SAMPLE_BYTES
    rows = 2 * pairs * channels                # signals x pairs x channels
    f_fft = frame_count(samples, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    work = {}
    if version == "basic":
        # excitation and unsmeared excitation of each signal (109 bands);
        # per frame and channel: both bandwidths, the NMR and its largest
        # band, EHS (5 values) and the two energy flags; per frame the gate
        z = C.BASIC_BAND_COUNT
        written = (rows * f_fft * 2 * z * item
                   + pairs * channels * f_fft * (5 * item + 2)
                   + pairs * f_fft)
    else:
        # the advanced FFT ear hands on only the NMR and EHS of each frame
        # and channel, the energy flags and the gate
        written = (pairs * channels * f_fft * (2 * item + 2)
                   + pairs * f_fft)
    work["fft_ear"] = (*least_ms(read + written, 0.0,
                                 PEAK_OPS_PER_S[dtype]),
                       read + written, 0.0)
    if version == "advanced":
        z = C.FB_BAND_COUNT
        f_fb = frame_count(samples, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
        instants = f_fb * C.FB_FRAMESIZE // C.FB_SUBSAMPLING
        written = rows * f_fb * 2 * z * item + pairs * f_fb
        ops = 2.0 * fir_window_taps() * instants * rows
        work["fb_ear"] = (*least_ms(read + written, ops,
                                    TENSOR_OPS_PER_S[dtype]),
                          read + written, ops)
    return work
