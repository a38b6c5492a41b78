"""Spans at the port's layer boundaries, for torch.profiler.

`span(name)` is a `torch.profiler.record_function` range named
"peaq." + name while a profiler is running, and one shared
`contextlib.nullcontext` otherwise, so that a span costs the port a flag
read when nothing records it.  The profiler is the recorder: under an
active profiler it stamps the ranges on the timeline of its device trace,
and a range's parent is the range around it.  A span synchronises nothing,
allocates nothing and launches nothing.

The spans (`parallel/batch.py`, `models/basic.py`, `models/advanced.py`):

  peaq.batch.dispatch  one microbatch's pipeline call, around the spans below
  peaq.batch.results   the outputs' concatenation and cast
  peaq.fft_ear         dequantize, the FFT path's gate and activity, framing,
                       the stateless FFT ear (S1, rDFT, S2, K3) and EHS (E1)
  peaq.fb_ear          the FB path's gate and activity and its ear (D3, F1,
                       D1, D2, W1 and forward masking's K1)
  peaq.band            time smearing, the level adapter and modulation
                       smoothers, the band epilogues (K1, K2, L1, L2, M1)
  peaq.movs            the gates, the accumulators, the cognitive model and
                       the energy totals

A span may open more than once a call; its readings add up.

The port's counters are the hand kernels' launch counters, one module-level
int a kernel in `ops/cuda_*.py` (`frame_gate_launches`, ...), which the
tests read to hold each kernel to its launches a call.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "peaq."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range "peaq." + name under a running profiler, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
