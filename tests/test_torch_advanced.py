"""The ported advanced pipeline, gstpeaq_tpu_torch.api.peaq(advanced=True),
against the JAX package's advanced api.peaq in float64 on the CPU.

The bars are 1e-8 * (1 + |w|) per MOV and 1e-9 in ODG and DI: the two
packages differ in summation order (blocked against doubling scans, the FIR
bank's convolution forms), and the DC cascade's near-unit poles lift that
float64 rounding to ~1e-12 in ODG and the FB-path MOVs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gstpeaq_tpu import api as JAPI
from gstpeaq_tpu import constants as C
from gstpeaq_tpu.utils import testsignals as TS
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as PC
from gstpeaq_tpu_torch import convert
from gstpeaq_tpu_torch.models.advanced import AdvancedPipeline
from gstpeaq_tpu_torch.ops import framing

N = 40 * 1024


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


def stereo_saw_triangle():
    return (np.stack([TS.saw(N), 0.5 * TS.saw(N, 660)], 1),
            np.stack([TS.triangle(N), 0.5 * TS.triangle(N, 660)], 1))


def poisoned_tail_pair():
    """test_jax_pipeline.py::test_advanced_unified_input_poisoned_tail's
    unequal, non-frame-aligned lengths."""
    rng = np.random.default_rng(23)
    n_ref, n_test = 40 * 1024 + 777, 38 * 1024 + 123
    ref = (0.5 * TS.sine(n_ref, 440)
           + 0.05 * rng.standard_normal(n_ref).astype(np.float32))
    test = (ref[:n_test] + 0.02
            * rng.standard_normal(n_test).astype(np.float32))
    return ref, test


def leading_silence_pair():
    """0.3 s of digital silence first: FB instants with level -inf, a slope
    state of exactly 0, and frames below the data-boundary threshold."""
    rng = np.random.default_rng(31)
    ref = 0.3 * TS.saw(N, 330) + 0.02 * rng.standard_normal(N).astype(
        np.float32)
    test = ref + 0.01 * rng.standard_normal(N).astype(np.float32)
    ref[:14400] = 0
    test[:14400] = 0
    return ref, test


PAIRS = {"noisy": noisy_pair, "stereo saw/tri": stereo_saw_triangle,
         "poisoned tail": poisoned_tail_pair,
         "leading silence": leading_silence_pair}


def assert_matches(got, want):
    assert abs(got.odg - want.odg) <= 1e-9
    assert abs(got.di - want.di) <= 1e-9
    for name in C.MOV_ADVANCED_NAMES:
        w, g = want.movs[name], got.movs[name]
        assert abs(g - w) <= 1e-8 * (1 + abs(w)), (name, g, w)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_pair_matches_jax(pair):
    ref, test = PAIRS[pair]()
    want = JAPI.peaq(ref, test, advanced=True, dtype="float64",
                     return_snr=True)
    got = api.peaq(ref, test, advanced=True, dtype="float64", device="cpu",
                   return_snr=True)
    assert list(got.movs) == list(C.MOV_ADVANCED_NAMES)
    assert_matches(got, want)
    assert abs(got.total_snr_db - want.total_snr_db) < 1e-9


@pytest.mark.parametrize("flag", [
    "swap_mod_patts_for_noise_loudness_movs",
    "swap_slope_filter_coefficients",
])
def test_settings_flags_match_jax(flag):
    """tests/test_settings_flags.py's advanced flags on its saw/triangle
    pair: the port moves with JAX, and the flag moves the FB-path MOVs."""
    ref, test = TS.saw(N), TS.triangle(N)
    jsettings = dataclasses.replace(
        C.DEFAULT_SETTINGS, **{flag: not getattr(C.DEFAULT_SETTINGS, flag)})
    settings = convert.settings_from_jax(jsettings)
    assert getattr(settings, flag) != getattr(PC.DEFAULT_SETTINGS, flag)
    want = JAPI.peaq(ref, test, advanced=True, dtype="float64",
                     settings=jsettings)
    got = api.peaq(ref, test, advanced=True, dtype="float64", device="cpu",
                   settings=settings)
    assert_matches(got, want)
    base = api.peaq(ref, test, advanced=True, dtype="float64", device="cpu")
    fb_movs = ("RmsModDiffA", "RmsNoiseLoudAsymA", "AvgLinDistA")
    assert any(abs(got.movs[k] - base.movs[k]) > 1e-9 for k in fb_movs)


def test_stereo_duplicate_channels_match_mono():
    sa, tr = TS.saw(N), TS.triangle(N)
    mono = api.peaq(sa, tr, advanced=True, dtype="float64", device="cpu")
    stereo = api.peaq(np.stack([sa, sa], 1), np.stack([tr, tr], 1),
                      advanced=True, dtype="float64", device="cpu")
    assert abs(mono.odg - stereo.odg) < 1e-9
    for name in C.MOV_ADVANCED_NAMES:
        assert abs(mono.movs[name] - stereo.movs[name]) <= 1e-9 * (
            1 + abs(mono.movs[name]))


# each tier's spectrum dtype: the FFT path's spectra, the FB path's DC
# stage and FIR bank
SPECTRUM = {"float64": torch.float64, "float32": torch.float32,
            "accurate": torch.float64, "mixed": torch.float32}


@pytest.mark.parametrize("tier,dtype", [
    ("float64", torch.float64), ("float32", torch.float32),
    ("accurate", torch.float32), ("mixed", torch.float32)])
def test_tier_dtypes(tier, dtype):
    """Each tier runs both ear models' front ends in its spectrum dtype
    and their band chains in its band dtype `dtype`, and stays within 2e-3
    ODG of float64 on saw/triangle."""
    pipe = api.advanced_pipeline(92.0, PC.DEFAULT_SETTINGS, tier,
                                 torch.device("cpu"))
    assert (pipe.fft.hann.dtype == pipe.fb.fir_weight.dtype
            == pipe.fb.level_factor.dtype == pipe.ehs_window.dtype
            == SPECTRUM[tier])
    assert (pipe.fb.internal_noise.dtype == pipe.fft.internal_noise.dtype
            == pipe.fb.lower_matrix.dtype == pipe.avg_matrix.dtype == dtype)
    ref, test = TS.saw(N), TS.triangle(N)
    got = api.peaq(ref, test, advanced=True, dtype=tier, device="cpu")
    f64 = api.peaq(ref, test, advanced=True, dtype="float64", device="cpu")
    assert abs(got.odg - f64.odg) < 2e-3


def test_pipeline_outputs():
    """AdvancedPipeline's forward on host-padded inputs: five finite MOVs
    in the working dtype, and the pipeline is cached per configuration."""
    ref, test = TS.saw(N), TS.triangle(N)
    pipe = AdvancedPipeline()
    n_fft = framing.num_frames(N, N, 2048, 1024)
    n_fb = framing.num_frames(N, N, 192, 192)
    # a batch of one mono pair: [B, CH, T], the FB pair [2, B, CH, T]
    pad = lambda x, t: torch.from_numpy(                      # noqa: E731
        np.pad(x, (0, t - len(x)))[None, None])
    out = pipe(pad(ref, (n_fft + 1) * 1024), pad(test, (n_fft + 1) * 1024),
               torch.stack([pad(ref, 192 * n_fb), pad(test, 192 * n_fb)]))
    assert out.movs.shape == (1, 5) and out.movs.dtype == torch.float64
    assert torch.isfinite(out.movs).all() and torch.isfinite(out.odg)
    assert (api.advanced_pipeline(92.0, PC.DEFAULT_SETTINGS, "float64",
                                  torch.device("cpu"))
            is api.advanced_pipeline(92.0, PC.DEFAULT_SETTINGS, "float64",
                                     torch.device("cpu")))
