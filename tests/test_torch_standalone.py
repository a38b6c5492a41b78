"""The port stands alone: its own copies of the JAX package's framework-free
modules equal the originals, and the NumPy spec that chip_smoke.py holds the
card to is frozen in tests/golden/torch_pair10_spec.json.

The card's machine has no JAX, and the port and chip_smoke.py import nothing
of gstpeaq_tpu (test_torch_modules.py::test_port_imports_no_jax).  So
chip_smoke.py compares the card's float64 10 s stereo pair with the frozen
spec, not with numpy_ref run there.  To write the file anew after a change
of the spec or of the pair:

    python tests/test_torch_standalone.py
"""

import dataclasses
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

import bench
import chip_smoke
from gstpeaq_tpu import constants as JC
from gstpeaq_tpu import earparams as JEP
from gstpeaq_tpu.utils import numpy_ref
from gstpeaq_tpu.utils import testsignals as JTS
from gstpeaq_tpu_torch import constants as PC
from gstpeaq_tpu_torch import earparams as PEP
from gstpeaq_tpu_torch.utils import benchpairs as PBENCH
from gstpeaq_tpu_torch.utils import corpus as PCORPUS
from gstpeaq_tpu_torch.utils import testsignals as PTS

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_pair10_spec.json"
DRIFT = pathlib.Path(__file__).resolve().parents[1] / "tools" / "tpu_drift.py"


def public(module) -> dict:
    """A module's public names, without the modules it imports."""
    return {name: value for name, value in vars(module).items()
            if not name.startswith("_") and not isinstance(
                value, type(sys)) and name != "annotations"}


def assert_same(got, want, what):
    """Equal values: arrays bit for bit with their dtype, dataclass
    instances field by field, everything else by ==."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)], what
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{what}.{f.name}")
    else:
        assert type(got) is type(want) and got == want, what


def test_constants_are_the_jax_packages():
    """Every public value of the port's constants equals the JAX
    package's, and the port has no other name."""
    want, got = public(JC), public(PC)
    assert set(got) == set(want)
    for name, value in want.items():
        if isinstance(value, type):
            continue
        assert_same(got[name], value, name)


def test_settings_are_the_jax_packages():
    """The port's own Settings: the same fields, defaults and frozenness."""
    assert PC.Settings is not JC.Settings
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(
        PC.Settings)] == [(f.name, f.type, f.default)
                          for f in dataclasses.fields(JC.Settings)]
    assert PC.Settings.__dataclass_params__.frozen
    assert_same(PC.DEFAULT_SETTINGS, PC.Settings(), "DEFAULT_SETTINGS")
    assert dataclasses.asdict(PC.DEFAULT_SETTINGS) == dataclasses.asdict(
        JC.DEFAULT_SETTINGS)


@pytest.mark.parametrize("band_count", [55, 56, 73, 100, 108, 109])
def test_fft_ear_params_are_the_jax_packages(band_count):
    assert_same(PEP.fft_ear_params(band_count),
                JEP.fft_ear_params(band_count),
                f"fft_ear_params({band_count})")


@pytest.mark.parametrize("playback_level", [92.0, 80.0])
def test_fb_ear_params_are_the_jax_packages(playback_level):
    assert_same(PEP.fb_ear_params(playback_level),
                JEP.fb_ear_params(playback_level),
                f"fb_ear_params({playback_level})")


def test_earparams_functions_are_the_jax_packages():
    """The port's earparams has the JAX package's public names, and each
    function gives the same arrays."""
    assert set(public(PEP)) == set(public(JEP))
    f = np.array([50.0, 440.0, 1000.0, 12000.0, 18000.0])
    assert_same(PEP.ear_weight(f), JEP.ear_weight(f), "ear_weight")
    assert_same(PEP.time_constants(f, 192, 0.004, 0.02),
                JEP.time_constants(f, 192, 0.004, 0.02), "time_constants")
    for centered in (False, True):
        assert_same(PEP.ehs_correlation_window(centered),
                    JEP.ehs_correlation_window(centered),
                    f"ehs_correlation_window({centered})")


def test_testsignals_are_the_jax_packages():
    assert set(public(PTS)) == set(public(JTS))
    for name in ("sine", "saw", "triangle"):
        for args in ((1000,), (4096, 660.0), (777, 100.0, 44100, 0.5)):
            assert_same(getattr(PTS, name)(*args), getattr(JTS, name)(*args),
                        f"{name}{args}")


def drift_module():
    """tools/tpu_drift.py, loaded by its path: tools/ is not a package."""
    spec = importlib.util.spec_from_file_location("tpu_drift", DRIFT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n,seconds,seed", [(20, 1.0, 3), (3, 2.5, 5)])
def test_corpus_is_tpu_drifts(n, seconds, seed):
    """The port's drift corpus v2 equals tools/tpu_drift.py's bit for bit:
    every item type (n = 20), and another length and seed."""
    want = drift_module().realistic_pairs(n, seconds, seed=seed)
    got = PCORPUS.realistic_pairs(n, seconds, seed=seed)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == n
        for k in range(n):
            assert_same(g[k], w[k], f"realistic_pairs[{i}][{k}]")


def fingerprint(pair) -> dict:
    """What identifies the 10 s pair: its shape, each channel's sum of
    squares and a few samples of each signal."""
    ref, test = pair
    picks = [0, 1, 4097, 123457, ref.shape[0] // 2, ref.shape[0] - 1]
    return {"shape": list(ref.shape),
            "sum_sq": [np.sum(np.square(s, dtype=np.float64), axis=0).tolist()
                       for s in pair],
            "picks": picks,
            "samples": [s[picks].astype(np.float64).tolist() for s in pair]}


@pytest.mark.parametrize("batch,seconds,channels,seed",
                         [(13, 0.05, 2, 0), (3, 0.1, 1, 5)])
def test_benchpairs_are_bench_make_pairs(batch, seconds, channels, seed):
    """The port's make_pairs equals bench.py's, array for array (dtype,
    shape, strides and bits), past the 11 harmonic stacks' wrap."""
    want = bench.make_pairs(batch, seconds, channels, seed)
    got = PBENCH.make_pairs(batch, seconds, channels, seed)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == batch
        for g, w in zip(g_list, w_list):
            assert g.strides == w.strides
            assert_same(g, w, "make_pairs")


def spec_record() -> dict:
    """The NumPy spec's float64 results on chip_smoke.ten_second_pair(),
    basic and advanced, with the pair's fingerprint."""
    pair = chip_smoke.ten_second_pair()
    record = {"pair": fingerprint(pair)}
    for mode, spec in (("basic", numpy_ref.peaq_basic),
                       ("advanced", numpy_ref.peaq_advanced)):
        res = spec(*pair)
        record[mode] = {"odg": float(res.odg), "di": float(res.di),
                        "movs": {n: float(v) for n, v in res.movs.items()}}
    return record


def test_frozen_spec_is_numpy_ref():
    """The frozen file equals numpy_ref on the pair today (1e-12 per value),
    and its fingerprint is the pair's, as chip_smoke.py checks it."""
    frozen = json.loads(GOLDEN.read_text())
    want = spec_record()
    assert frozen["pair"] == want["pair"]
    chip_smoke.check_fingerprint(frozen, chip_smoke.ten_second_pair())
    for mode, names in (("basic", PC.MOV_BASIC_NAMES),
                        ("advanced", PC.MOV_ADVANCED_NAMES)):
        got, ref = frozen[mode], want[mode]
        assert list(got["movs"]) == list(names)
        for key in ("odg", "di"):
            assert abs(got[key] - ref[key]) <= 1e-12 * (1 + abs(ref[key]))
        for name in names:
            w = ref["movs"][name]
            assert abs(got["movs"][name] - w) <= 1e-12 * (1 + abs(w)), name


def test_fingerprint_refuses_another_pair():
    frozen = json.loads(GOLDEN.read_text())
    ref, test = chip_smoke.ten_second_pair()
    other = test.copy()
    other[123457, 1] += 1e-3
    with pytest.raises(AssertionError, match="fingerprint"):
        chip_smoke.check_fingerprint(frozen, (ref, other))


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(spec_record(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
