"""The port's precision tiers against the JAX package's, on the CPU.

Each tier is a pair (band dtype, spectrum dtype), as gstpeaq_tpu/api.py::
resolve_dtypes returns it.  The port's "accurate" is the float32 band chain
on float64 spectra; "mixed" is JAX's FFT-spectra tier, the same pair as the
port's "float32".

  * The port's (float32, float64) pipelines against JAX's make_pipeline
    with the same pair (x64 on, XLA on the CPU): both run a float32 band
    chain, in different summation orders, so the bars are a float32
    chain's: 1e-4 in ODG and 1e-3 (1 + |w|) per MOV (read: 3.2e-7 and
    1.6e-4, the modulation MOVs).
  * The port's "accurate" against JAX float64: within 1e-3 ODG (the
    conformance gate JAX's own "accurate" is held to) on the first items of
    drift corpus v2, cut to 2 s, and within CORPUS_BAR, which the port's
    "float32" (the control) must miss; the identical sine pair within 1e-2
    of 0.171, saw/triangle at -2.007.
  * "mixed" equals the port's "float32" bit for bit and stays within 2e-3
    ODG of JAX "mixed".
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import api as JAPI
from gstpeaq_tpu import constants as JC
from gstpeaq_tpu.models import advanced as JADV
from gstpeaq_tpu.models import basic as JBASIC
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch.models.advanced import AdvancedPipeline
from gstpeaq_tpu_torch.models.basic import BasicPipeline
from gstpeaq_tpu_torch.ops import framing
from gstpeaq_tpu_torch.utils import corpus
from gstpeaq_tpu_torch.utils import testsignals as TS

N = 40 * 1024
ODG_BAR = 1e-4        # port (f32, f64) against JAX (f32, f64)
MOV_BAR = 1e-3        # per MOV, times (1 + |w|)
# worst |dODG| against JAX float64 on the corpus items below: between the
# port's "accurate" (read: 1.9e-7 basic, 4.1e-7 advanced) and its "float32"
# (read: 3.5e-6 basic, 1.2e-4 advanced), so that a tier computing its
# spectra in float32 fails it
CORPUS_BAR = 2e-6


def noisy_pair():
    """test_torch_pipeline.py's noisy sine pair, with trailing silence."""
    rng = np.random.default_rng(7)
    n = 30 * 1024
    ref = (0.5 * TS.sine(n, 440)
           + 0.05 * rng.standard_normal(n).astype(np.float32))
    test = ref + 0.02 * rng.standard_normal(n).astype(np.float32)
    ref[-6000:] = 0
    test[-6000:] = 0
    return ref, test


def saw_triangle():
    return TS.saw(N), TS.triangle(N)


PAIRS = {"saw/tri": saw_triangle, "noisy": noisy_pair}


def padded(sig, n_frames, frame, step):
    """[T] -> the channel-major [1, T'] copy padded for n_frames frames."""
    return np.ascontiguousarray(
        framing.pad_signal(sig[:, None], n_frames, frame, step).T)


def basic_inputs(ref, test):
    n = framing.num_frames(len(ref), len(test), C.FFT_FRAMESIZE,
                           C.FFT_STEPSIZE)
    return [padded(s, n, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
            for s in (ref, test)]


def advanced_inputs(ref, test):
    n = framing.num_frames(len(ref), len(test), C.FB_FRAMESIZE,
                           C.FB_FRAMESIZE)
    fb = np.stack([padded(s, n, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
                   for s in (ref, test)])
    return basic_inputs(ref, test) + [fb]


def batch_of_one(inputs):
    """The pipelines' batched inputs for one pair: [CH, T] -> [1, CH, T],
    the FB pair [2, CH, T] -> [2, 1, CH, T]."""
    return [torch.from_numpy(x).unsqueeze(-3) for x in inputs]


def first_pair(out):
    """A batch-of-one output tuple -> that pair's values."""
    return type(out)(*(x[0] for x in out))


def assert_close(got, want, names):
    """got: the port's outputs; want: JAX's, each with odg and movs (the
    noisy pair's bandwidth MOVs, and so its ODG, are NaN in both)."""
    g, w = float(got.odg), float(want.odg)
    assert np.isnan(g) if np.isnan(w) else abs(g - w) <= ODG_BAR
    for name, g, w in zip(names, got.movs.tolist(),
                          np.asarray(want.movs).tolist()):
        if np.isnan(w):
            assert np.isnan(g), name
        else:
            assert abs(g - w) <= MOV_BAR * (1 + abs(w)), (name, g, w)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_basic_band_f32_spectrum_f64_matches_jax(pair):
    """BasicPipeline(dtype=float32, spectrum_dtype=float64) against JAX's
    make_pipeline(..., jnp.float32, jnp.float64) on the same padded pair."""
    inputs = basic_inputs(*PAIRS[pair]())
    fn, consts = JBASIC.make_pipeline(C.BASIC_BAND_COUNT, 92.0,
                                      JC.DEFAULT_SETTINGS, jnp.float32,
                                      jnp.float64)
    want = jax.jit(fn)(consts, *map(jnp.asarray, inputs))
    pipe = BasicPipeline(dtype=torch.float32, spectrum_dtype=torch.float64)
    with torch.inference_mode():
        got = first_pair(pipe(*batch_of_one(inputs)))
    assert got.movs.dtype == torch.float64
    assert_close(got, want, C.MOV_BASIC_NAMES)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_advanced_band_f32_spectrum_f64_matches_jax(pair):
    """AdvancedPipeline(dtype=float32, spectrum_dtype=float64) against JAX's
    advanced make_pipeline(..., jnp.float32, jnp.float64), which on the CPU
    takes its XLA route (its Pallas kernels run on a TPU only)."""
    inputs = advanced_inputs(*PAIRS[pair]())
    fn, consts = JADV.make_pipeline(92.0, JC.DEFAULT_SETTINGS, jnp.float32,
                                    jnp.float64)
    want = jax.jit(fn)(consts, *map(jnp.asarray, inputs))
    pipe = AdvancedPipeline(dtype=torch.float32,
                            spectrum_dtype=torch.float64)
    with torch.inference_mode():
        got = first_pair(pipe(*batch_of_one(inputs)))
    assert got.movs.dtype == torch.float64
    assert_close(got, want, C.MOV_ADVANCED_NAMES)


@functools.cache
def corpus_float64(advanced: bool):
    """The first six items of drift corpus v2 at 2 s, stereo, each with JAX
    float64's ODG."""
    refs, tests = corpus.realistic_pairs(6, 2.0)
    return [(ref, test, JAPI.peaq(ref, test, advanced=advanced,
                                  dtype="float64").odg)
            for ref, test in zip(refs, tests)]


def corpus_drift(tier: str, advanced: bool) -> list[float]:
    """|dODG| of the port's `tier` against JAX float64 per corpus item."""
    return [abs(api.peaq(ref, test, advanced=advanced, dtype=tier,
                         device="cpu").odg - want)
            for ref, test, want in corpus_float64(advanced)]


@pytest.mark.parametrize("advanced", [False, True])
def test_accurate_within_1e3_of_jax_float64_on_corpus(advanced):
    """The port's "accurate" within 1e-3 ODG of JAX float64 on each item,
    and within CORPUS_BAR."""
    drift = corpus_drift("accurate", advanced)
    assert max(drift) <= 1e-3, drift
    assert max(drift) <= CORPUS_BAR, drift


@pytest.mark.parametrize("advanced", [False, True])
def test_float32_control_misses_the_corpus_bar(advanced):
    """The port's "float32" misses CORPUS_BAR on the same items, so that the
    bar tells a float32-spectrum tier from "accurate"."""
    assert max(corpus_drift("float32", advanced)) > CORPUS_BAR


def test_accurate_pinned_odgs():
    """The identical sine pair within 1e-2 of 0.171 in "accurate" (float32
    puts it at 0.187 on the CPU: its bandwidth MOVs read the float32 rDFT's
    rounding floor), and saw/triangle at -2.007."""
    n = 128 * 1024
    s = TS.sine(n)
    sine = api.peaq(s, s, dtype="accurate", device="cpu")
    assert abs(sine.odg - 0.171) <= 1e-2
    f64 = api.peaq(s, s, dtype="float64", device="cpu")
    assert sine.movs["BandwidthRefB"] == f64.movs["BandwidthRefB"]
    saw = api.peaq(TS.saw(n), TS.triangle(n), dtype="accurate", device="cpu")
    assert f"{saw.odg:.3f}" == "-2.007"


@pytest.mark.parametrize("advanced", [False, True])
def test_mixed_is_float32_and_near_jax_mixed(advanced):
    """"mixed" runs, equals the port's "float32" bit for bit, and stays
    within 2e-3 ODG of JAX's "mixed" on saw/triangle."""
    ref, test = saw_triangle()
    mixed = api.peaq(ref, test, advanced=advanced, dtype="mixed",
                     device="cpu")
    f32 = api.peaq(ref, test, advanced=advanced, dtype="float32",
                   device="cpu")
    assert mixed.odg == f32.odg and mixed.movs == f32.movs
    want = JAPI.peaq(ref, test, advanced=advanced, dtype="mixed")
    assert abs(mixed.odg - want.odg) <= 2e-3
