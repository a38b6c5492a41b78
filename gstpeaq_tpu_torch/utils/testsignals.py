"""Synthetic test-signal generators: the port's own copy of
gstpeaq_tpu/utils/testsignals.py.

Reproduces GStreamer audiotestsrc's sample formulas exactly (float32 output,
phase accumulator incremented before each sample, wrap at 2*pi) so that the
reference's pinned end-to-end ODGs (src/runtest-1.0.sh:16-50: sine-vs-self
0.171, saw-vs-triangle -2.007) can be replicated bit-for-bit in spirit.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2 * np.pi


def _accumulator(n: int, freq: float, rate: int,
                 start: float = 0.0) -> np.ndarray:
    """Phase accumulator: incremented by step before producing each sample,
    wrapped into [0, 2*pi)."""
    step = TWO_PI * freq / rate
    acc = start + step * np.arange(1, n + 1, dtype=np.float64)
    return np.mod(acc, TWO_PI)


def sine(n: int, freq: float = 440.0, rate: int = 48000,
         volume: float = 0.8) -> np.ndarray:
    acc = _accumulator(n, freq, rate)
    return (volume * np.sin(acc)).astype(np.float32)


def saw(n: int, freq: float = 440.0, rate: int = 48000,
        volume: float = 0.8) -> np.ndarray:
    acc = _accumulator(n, freq, rate)
    amp = volume / np.pi
    out = np.where(acc < np.pi, acc * amp, (TWO_PI - acc) * -amp)
    return out.astype(np.float32)


def triangle(n: int, freq: float = 440.0, rate: int = 48000,
             volume: float = 0.8) -> np.ndarray:
    acc = _accumulator(n, freq, rate)
    amp = volume / (np.pi / 2.0)
    out = np.where(
        acc < np.pi / 2.0, acc * amp,
        np.where(acc < 1.5 * np.pi, (np.pi - acc) * amp,
                 (acc - TWO_PI) * amp))
    return out.astype(np.float32)
