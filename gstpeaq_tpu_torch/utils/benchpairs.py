"""The throughput benchmark's pairs from a seed: the port's own copy of
bench.py::make_pairs (tests/test_torch_standalone.py holds the two equal,
array for array).

Each pair is a harmonic stack (f0 = 180 + 37 (i % 11) Hz, partials up to
15 kHz) against the same stack low-passed at 10 kHz, codec-like, plus white
noise at 1e-4, on every channel.
"""

from __future__ import annotations

import numpy as np


def make_pairs(batch: int, seconds: float, channels: int = 2,
               seed: int = 0) -> tuple[list, list]:
    """`batch` pairs of `seconds` at 48 kHz, each a [T, channels] float32
    view of channel-major storage (the batch padder's channel-major writes
    then copy contiguous rows)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 48000)
    t = np.arange(n, dtype=np.float64) / 48000.0
    # only 11 distinct harmonic stacks exist (f0 cycles i % 11)
    bases = {}
    for m in range(min(batch, 11)):
        f0 = 180.0 + 37.0 * m
        ref = np.zeros(n)
        test = np.zeros(n)
        k = 1
        while k * f0 < 15000.0:
            tone = np.sin(2 * np.pi * k * f0 * t + 0.3 * k) / k
            ref += tone
            if k * f0 < 10000.0:  # codec-like lowpass on the test signal
                test += tone
            k += 1
        bases[m] = (0.5 * ref, 0.5 * test)
    refs, tests = [], []
    for i in range(batch):
        ref, test = bases[i % 11]
        test = test + 1e-4 * rng.standard_normal(n)
        refs.append(np.stack([ref] * channels, 0).astype(np.float32).T)
        tests.append(np.stack([test] * channels, 0).astype(np.float32).T)
    return refs, tests
