"""The frozen reference: the NumPy specification at the pinned ODGs, and the
batched PyTorch reference held to the specification."""

import numpy as np
import pytest
import torch

from peaqbench.reference import numpy_spec as NS
from peaqbench.reference import torch_ref as TR

TWO_PI = 2 * np.pi


def _acc(n, freq=440.0, rate=48000):
    """GStreamer audiotestsrc's phase accumulator, incremented before each
    sample and wrapped into [0, 2 pi)."""
    return np.mod(TWO_PI * freq / rate * np.arange(1, n + 1), TWO_PI)


def sine(n, volume=0.8):
    return (volume * np.sin(_acc(n))).astype(np.float32)


def saw(n, volume=0.8):
    acc = _acc(n)
    amp = volume / np.pi
    return np.where(acc < np.pi, acc * amp,
                    (TWO_PI - acc) * -amp).astype(np.float32)


def triangle(n, volume=0.8):
    acc = _acc(n)
    amp = volume / (np.pi / 2.0)
    return np.where(acc < np.pi / 2.0, acc * amp,
                    np.where(acc < 1.5 * np.pi, (np.pi - acc) * amp,
                             (acc - TWO_PI) * amp)).astype(np.float32)


N_PINNED = 128 * 1024


def test_spec_pinned_odgs():
    """gstpeaq's pinned ODGs (src/runtest-1.0.sh): sine against itself
    0.171, saw against triangle -2.007, at 128 x 1024 samples."""
    assert round(NS.peaq_basic(sine(N_PINNED), sine(N_PINNED)).odg, 3) \
        == 0.171
    assert round(NS.peaq_basic(saw(N_PINNED), triangle(N_PINNED)).odg, 3) \
        == -2.007


def test_torch_reference_pinned_odgs():
    ref = torch.from_numpy(np.stack([sine(N_PINNED), saw(N_PINNED)]))
    test = torch.from_numpy(np.stack([sine(N_PINNED), triangle(N_PINNED)]))
    out = TR.peaq(ref[:, None], test[:, None], advanced=False).numpy()
    assert np.round(out[:, 0], 3).tolist() == [0.171, -2.007]


def _pair(n=96000, seed=1):
    """A stereo pair of harmonic stacks up to 15 kHz (so that the bandwidth
    gate opens), with noise bursts, a gain error and a noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000
    ref = np.zeros((n, 2))
    for c, f0 in enumerate((440.0, 660.0)):
        k = np.arange(1, int(15000 // f0) + 1)
        ref[:, c] = 0.3 * (np.sin(2 * np.pi * f0 * k[:, None] * t
                                  + 0.3 * k[:, None]) / k[:, None]).sum(0)
    ref += 0.02 * rng.standard_normal((n, 2)) * (t % 0.5 < 0.1)[:, None]
    test = ref * [0.99, 0.97] + 1e-4 * rng.standard_normal(ref.shape)
    return ref.astype(np.float32), test.astype(np.float32)


@pytest.mark.parametrize("advanced", [False, True])
def test_torch_reference_equals_spec(advanced):
    """Every MOV, DI and ODG of a stereo pair within 1e-9 (1 + |x|) of the
    specification's: the batched sums round otherwise than the frame loop,
    and AvgModDiff2B weighs each band by whether the test's modulation
    reaches the reference's, a decision that such rounding can turn where
    the two all but tie (2.6e-10 on this pair; every other value within
    1e-12)."""
    ref, test = _pair()
    spec = (NS.peaq_advanced if advanced else NS.peaq_basic)(ref, test)
    names = NS.C.MOV_ADVANCED_NAMES if advanced else NS.C.MOV_BASIC_NAMES
    want = np.array([spec.odg, spec.di] + [spec.movs[m] for m in names])
    got = TR.peaq(torch.from_numpy(ref.T.copy())[None],
                  torch.from_numpy(test.T.copy())[None], advanced)[0].numpy()
    assert np.all(np.isfinite(want))
    np.testing.assert_array_less(np.abs(got - want) / (1 + np.abs(want)),
                                 1e-9)


def test_torch_reference_pairs_are_independent():
    """A pair's result does not depend on the pairs beside it in a block
    (beyond the rounding of a batched product's order)."""
    ref, test = _pair(48000, 2)
    ref2, test2 = _pair(48000, 3)
    r = torch.from_numpy(np.stack([ref.T, ref2.T]))
    t = torch.from_numpy(np.stack([test.T, test2.T]))
    both = TR.peaq(r, t, False).numpy()
    alone = TR.peaq(r[1:], t[1:], False).numpy()
    np.testing.assert_allclose(both[1], alone[0], rtol=1e-13, atol=0)
