"""The ported basic pipeline, gstpeaq_tpu_torch.api.peaq, against the JAX
package's api.peaq in float64 on the CPU, the pinned ODGs, and the rules
that keep the port honest off the card: no fallback to the CPU, no JAX.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gstpeaq_tpu import api as JAPI
from gstpeaq_tpu import constants as C
from gstpeaq_tpu.utils import testsignals as TS
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as PC
from gstpeaq_tpu_torch.models.basic import BasicPipeline
from gstpeaq_tpu_torch.ops import cuda_dc
from gstpeaq_tpu_torch.ops import cuda_fb
from gstpeaq_tpu_torch.ops import cuda_iir
from gstpeaq_tpu_torch.ops import cuda_spread_fft

REPO = pathlib.Path(__file__).resolve().parents[1]


def noisy_pair():
    """The noisy pair of test_jax_pipeline.py::
    test_basic_pipeline_matches_spec_noisy (its bandwidth MOVs are NaN:
    the validity gate stays shut)."""
    rng = np.random.default_rng(7)
    n = 30 * 1024
    ref = (0.5 * TS.sine(n, 440)
           + 0.05 * rng.standard_normal(n).astype(np.float32))
    test = ref + 0.02 * rng.standard_normal(n).astype(np.float32)
    ref[-6000:] = 0
    test[-6000:] = 0
    return ref, test


def assert_movs_match(got, want, bar):
    for name in C.MOV_BASIC_NAMES:
        w, g = want.movs[name], got.movs[name]
        if np.isnan(w):
            assert np.isnan(g), name
        else:
            assert abs(g - w) <= bar * (1 + abs(w)), (name, g, w)


def test_noisy_pair_matches_jax():
    ref, test = noisy_pair()
    want = JAPI.peaq(ref, test, dtype="float64", return_snr=True)
    got = api.peaq(ref, test, dtype="float64", device="cpu",
                   return_snr=True)
    assert_movs_match(got, want, 1e-8)
    assert np.isnan(want.movs["BandwidthRefB"])
    assert abs(got.total_snr_db - want.total_snr_db) < 1e-9


def test_stereo_saw_triangle_matches_jax():
    n = 40 * 1024
    ref = np.stack([TS.saw(n), 0.5 * TS.saw(n, 660)], 1)
    test = np.stack([TS.triangle(n), 0.5 * TS.triangle(n, 660)], 1)
    want = JAPI.peaq(ref, test, dtype="float64")
    got = api.peaq(ref, test, dtype="float64", device="cpu")
    assert abs(got.odg - want.odg) < 1e-9
    assert abs(got.di - want.di) < 1e-9
    assert_movs_match(got, want, 1e-8)


def test_band_count_73_matches_jax():
    ref, test = noisy_pair()
    want = JAPI.peaq(ref, test, dtype="float64", band_count=73)
    got = api.peaq(ref, test, dtype="float64", device="cpu", band_count=73)
    assert_movs_match(got, want, 1e-8)
    default = api.peaq(ref, test, dtype="float64", device="cpu")
    assert got.movs["AvgModDiff1B"] != default.movs["AvgModDiff1B"]


@pytest.mark.parametrize("dtype", ["float64", "accurate", "float32"])
def test_pinned_odgs(dtype):
    """The reference's pinned ODGs at 128 x 1024 samples
    (src/runtest-1.0.sh), exactly in float64.  In "accurate" (the float32
    band chain on float64 spectra) saw/triangle keeps -2.007 and the
    identical sine pair is held within 1e-2 of 0.171; in "float32" within
    0.05: the float32 rDFT's rounding floor lifts its bandwidth MOVs
    (chip_smoke.py phase 5)."""
    n = 128 * 1024
    s = TS.sine(n)
    sine = api.peaq(s, s, dtype=dtype, device="cpu").odg
    if dtype == "float64":
        assert f"{sine:.3f}" == "0.171"
    else:
        assert abs(sine - 0.171) <= (1e-2 if dtype == "accurate" else 0.05)
    res = api.peaq(TS.saw(n), TS.triangle(n), dtype=dtype, device="cpu")
    assert f"{res.odg:.3f}" == "-2.007"


@pytest.mark.parametrize("tier,band,spectrum", [
    ("float64", torch.float64, torch.float64),
    ("float32", torch.float32, torch.float32),
    ("accurate", torch.float32, torch.float64),
    ("mixed", torch.float32, torch.float32)])
def test_tier_dtypes(tier, band, spectrum):
    """Each precision tier computes its spectra in its spectrum dtype and
    its band quantities in its band dtype (the MOVs that mix the two, and
    so the MOV vector, come out in the wider, as JAX promotes them), and
    stays within 2e-3 ODG of float64 on saw/triangle."""
    n = 40 * 1024
    ref = torch.from_numpy(np.stack([TS.saw(n + 1024)]))[None]    # [1, 1, T]
    test = torch.from_numpy(np.stack([TS.triangle(n + 1024)]))[None]
    pipe = api.pipeline(109, 92.0, PC.DEFAULT_SETTINGS, tier,
                        torch.device("cpu"))
    assert api.DTYPES[tier] == (band, spectrum)
    assert (pipe.consts.hann.dtype == pipe.consts.group_matrix.dtype
            == pipe.consts.level_factor.dtype == pipe.ehs_window.dtype
            == spectrum)
    assert (pipe.consts.internal_noise.dtype == pipe.consts.ear_a.dtype
            == pipe.avg_matrix.dtype == band)
    out = pipe(ref, test)
    wide = torch.promote_types(band, spectrum)
    assert out.odg.dtype == out.di.dtype == out.movs.dtype == wide
    assert out.total_signal_energy.dtype == spectrum
    f64 = BasicPipeline(dtype=torch.float64)(ref, test)
    assert abs(float(out.odg) - float(f64.odg)) < 2e-3


def test_stereo_duplicate_channels_match_mono():
    n = 30 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    mono = api.peaq(sa, tr, dtype="float64", device="cpu")
    stereo = api.peaq(np.stack([sa, sa], 1), np.stack([tr, tr], 1),
                      dtype="float64", device="cpu")
    assert abs(mono.odg - stereo.odg) < 1e-9


def test_cpu_run_launches_no_kernel(monkeypatch):
    """A basic and an advanced run on the CPU launch none of the six
    kernels."""
    counters = ((cuda_iir, "recurrence_banded_launches"),
                (cuda_iir, "fused_mod_smoothers_launches"),
                (cuda_spread_fft, "spread_fft_launches"),
                (cuda_fb, "slope_state_launches"),
                (cuda_fb, "spread_fb_launches"),
                (cuda_dc, "dc_chain_launches"))
    for module, name in counters:
        monkeypatch.setattr(module, name, 0)
    ref, test = noisy_pair()
    assert np.isfinite(api.peaq(ref, test, device="cpu").movs["ADBB"])
    assert np.isfinite(api.peaq(ref, test, advanced=True,
                                device="cpu").movs["RmsModDiffA"])
    assert [getattr(module, name) for module, name in counters] == [0] * 6


def test_api_argument_checks(monkeypatch):
    s = TS.sine(4096)
    with pytest.raises(ValueError, match="band_count applies to basic"):
        api.peaq(s, s, advanced=True, band_count=55, device="cpu")
    for bad in (54, 110):
        with pytest.raises(ValueError, match="band_count"):
            api.peaq(s, s, band_count=bad, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        api.peaq(s, s, dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="channel"):
        api.peaq(np.stack([s, s], 1), s, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.peaq(s, s)


def test_full_precision_matmuls_restores_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with api.full_precision_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """With no CUDA card, and alone in a directory without the port,
    chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd in (REPO, alone):
        proc = _run_chip_smoke(cwd)
        assert proc.returncode != 0, cwd
        assert '"ok"' not in proc.stdout, cwd
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                assert not json.loads(line).get("ok"), cwd
