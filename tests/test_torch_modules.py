"""Each ported module of gstpeaq_tpu_torch against its JAX function, in
float64 on the CPU.

The same inputs, made from a seed with numpy, go through both packages.
The bar is 1e-12 relative (max|d| / max|ref|), the order of float64
reassociation; 1e-9 where the two sides take different FFT libraries
(pocketfft inside torch, XLA's on the JAX side).  The converters must give
exactly the natively built constants.
"""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import constants as C
from gstpeaq_tpu import earparams as EP
from gstpeaq_tpu.models import accum as JACC
from gstpeaq_tpu.models import level_adapt as JLA
from gstpeaq_tpu.models import movs as JMOVS
from gstpeaq_tpu.models import nn as JNN
from gstpeaq_tpu.ops import fft_ear as JFE
from gstpeaq_tpu.ops import framing as JFR
from gstpeaq_tpu.ops import iir as JIIR
from gstpeaq_tpu_torch import convert
from gstpeaq_tpu_torch.models import accum
from gstpeaq_tpu_torch.models import level_adapt as LA
from gstpeaq_tpu_torch.models import movs as MOVS
from gstpeaq_tpu_torch.models import nn as NN
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.ops import framing
from gstpeaq_tpu_torch.ops import iir

Z = C.BASIC_BAND_COUNT


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if not ok.any():
        return 0.0
    return np.abs(got[ok] - want[ok]).max() / max(np.abs(want[ok]).max(),
                                                  1e-300)


def tt(x):
    return torch.from_numpy(np.asarray(x))


def jit(fn, *static):
    """The JAX function compiled once: op-by-op dispatch would compile
    every primitive separately."""
    return jax.jit(fn, static_argnames=static)


@pytest.fixture(scope="module")
def consts():
    params = EP.fft_ear_params(Z)
    return JFE.build_consts(params), FE.build_consts(params, torch.float64)


def test_framing_matches_jax():
    rng = np.random.default_rng(1)
    n_frames = 12
    t = JFR.padded_length(n_frames, 2048, 1024)
    sig = rng.standard_normal((2, t)) * 0.05
    sig[:, 3 * 1024:7 * 1024 + 300] *= 1e-4        # quiet frames
    sig[1, 9 * 1024:11 * 1024] = 0.0
    for frame_size in (2048, 1024):
        nf = n_frames if frame_size == 2048 else t // 1024
        want = np.asarray(jit(JFR.above_threshold_signal, "n_frames",
                                  "frame_size", "step_size")(
            jnp.asarray(sig), nf, frame_size, 1024))
        got = framing.above_threshold_signal(tt(sig), nf, frame_size, 1024)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < nf
    for n_ref, n_test in ((30000, 30000), (40 * 1024 + 7, 38 * 1024), (10, 5)):
        assert (framing.num_frames(n_ref, n_test, 2048, 1024)
                == JFR.num_frames(n_ref, n_test, 2048, 1024))
    x = rng.standard_normal((5000, 2)).astype(np.float32)
    np.testing.assert_array_equal(framing.pad_signal(x, 4, 2048, 1024),
                                  JFR.pad_signal(x, 4, 2048, 1024))
    blocks = framing.blocks_hop(tt(sig), n_frames)
    np.testing.assert_array_equal(
        blocks, JFR.blocks_hop(jnp.asarray(sig), n_frames))
    pcm = torch.tensor([-32768, 0, 16384], dtype=torch.int16)
    np.testing.assert_array_equal(framing.dequantize(pcm),
                                  np.float32([-1.0, 0.0, 0.5]))


def test_stateless_pair_hop_matches_jax(consts):
    jk, k = consts
    rng = np.random.default_rng(2)
    ref = rng.standard_normal((2, 9, 1024)) * 0.3
    test = ref + rng.standard_normal((2, 9, 1024)) * 0.01
    test[1, :4] = ref[1, :4]                       # identical frames
    want = jit(JFE.stateless_pair_hop)(jk, jnp.asarray(ref),
                                       jnp.asarray(test))
    got = FE.stateless_pair_hop(k, tt(ref), tt(test))
    for name, g, w in zip(("power", "unsmeared", "thresh", "delta"),
                          got, want):
        if name == "thresh":
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == torch.float64
            assert rel(g, w) < 1e-9, name


def test_time_smear_and_loudness_match_jax(consts):
    jk, k = consts
    rng = np.random.default_rng(3)
    uns = 10.0 ** rng.uniform(-2, 6, (2, 2, Z, 50))          # [.., Z, F]
    smear = jit(JFE.time_smear, "axis")
    loudness = jit(JFE.loudness, "axis")
    want = smear(jk, jnp.asarray(uns), axis=-1)
    got = FE.time_smear(k, tt(uns), axis=-1)
    assert rel(got, want) < 1e-12
    uns_f = np.ascontiguousarray(np.moveaxis(uns[0, 0], -1, 0))  # [F, Z]
    assert rel(FE.time_smear(k, tt(uns_f), axis=0),
               smear(jk, jnp.asarray(uns_f), axis=0)) < 1e-12
    assert rel(FE.loudness(k, tt(uns), axis=-2),
               loudness(jk, jnp.asarray(uns), axis=-2)) < 1e-12
    assert rel(FE.loudness(k, tt(uns_f), axis=-1),
               loudness(jk, jnp.asarray(uns_f), axis=-1)) < 1e-12


def test_adapt_stage2_matches_jax(consts):
    jk, k = consts
    rng = np.random.default_rng(4)
    exc = 10.0 ** rng.uniform(-1, 5, (4, 2, Z, 60))
    exc[1] *= 3.0                                   # a louder test signal
    avg = LA.sliding_average_matrix(Z)
    want = jit(JLA.adapt_stage2)(jk.adapt_a, jnp.asarray(avg),
                                 *map(jnp.asarray, exc))[:2]
    got = LA.adapt_stage2(k.adapt_a, tt(avg), *map(tt, exc))
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-12


def _band_inputs(rng, shape=(2, Z, 60)):
    mod_ref = rng.uniform(0.0, 5.0, shape)
    mod_test = mod_ref * rng.uniform(0.5, 1.5, shape)
    e_ref = 10.0 ** rng.uniform(0, 6, shape)
    e_test = e_ref * 10.0 ** rng.uniform(-0.5, 0.5, shape)
    return mod_ref, mod_test, e_ref, e_test


@pytest.mark.parametrize("rms_mode", [False, True])
def test_modulation_difference_matches_jax(consts, rms_mode):
    jk, k = consts
    mod_ref, mod_test, e_ref, _ = _band_inputs(np.random.default_rng(5))
    want = jit(JMOVS.modulation_difference, "rms_mode", "lev_wt")(
        jk.internal_noise, jnp.asarray(mod_ref), jnp.asarray(mod_test),
        jnp.asarray(e_ref), rms_mode=rms_mode, lev_wt=100.0)
    got = MOVS.modulation_difference(k.internal_noise, tt(mod_ref),
                                     tt(mod_test), tt(e_ref),
                                     rms_mode=rms_mode, lev_wt=100.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert rel(g, w) < 1e-12


def test_noise_loudness_matches_jax(consts):
    jk, k = consts
    args = _band_inputs(np.random.default_rng(6))
    for nl_min in (0.0, 0.1):
        want = jit(JMOVS.noise_loudness)(
            jk.internal_noise, 1.5, 0.15, 0.5, nl_min,
            *map(jnp.asarray, args))
        got = MOVS.noise_loudness(k.internal_noise, 1.5, 0.15, 0.5, nl_min,
                                  *map(tt, args))
        assert rel(got, want) < 1e-12


def _spectra(rng, shape=(2, 30, 1025)):
    """Power spectra with a falling envelope and a noise floor, the test
    a perturbed copy; delta = ref - test as stateless_pair_hop gives it."""
    env = 10.0 ** (8.0 - 10.0 * np.arange(shape[-1]) / shape[-1])
    ref = env * rng.uniform(0.1, 1.0, shape) + rng.uniform(0, 1e-2, shape)
    test = ref * rng.uniform(0.3, 1.7, shape)
    test[0, :5] = ref[0, :5]                       # identical frames
    test[1, 5:8, 100:300] = 0.0                    # removed content
    return ref, test, ref - test


def test_bandwidth_matches_jax():
    ref, test, _ = _spectra(np.random.default_rng(7))
    ref[:, 3, 400:] = 1e-6                         # a narrow frame
    want = jit(JMOVS.bandwidth)(jnp.asarray(ref), jnp.asarray(test))
    got = MOVS.bandwidth(tt(ref), tt(test))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == torch.float64 and got[2].dtype == torch.bool


def test_nmr_matches_jax(consts):
    jk, k = consts
    rng = np.random.default_rng(8)
    ref, test, delta = _spectra(rng)
    hi = k.group_bin_hi
    assert hi == jk.group_bin_hi
    exc = 10.0 ** rng.uniform(2, 7, (2, 30, Z))
    want = jit(JMOVS.nmr)(jk.group_matrix[:hi], jk.masking_difference,
                     jnp.asarray(ref[..., :hi]), jnp.asarray(test[..., :hi]),
                     jnp.asarray(exc), delta_weighted=jnp.asarray(
                         delta[..., :hi]))
    got = MOVS.nmr(k.group_matrix[:hi], k.masking_difference,
                   tt(ref[..., :hi]), tt(test[..., :hi]), tt(exc),
                   tt(delta[..., :hi]))
    assert rel(got[0], want[0]) < 1e-12
    np.testing.assert_array_equal(got[1], want[1])
    assert 0 < float(got[1].sum()) < got[1].numel()


@pytest.mark.parametrize("use_floor", [False, True])
def test_prob_detect_matches_jax(use_floor):
    rng = np.random.default_rng(9)
    _, _, e_ref, e_test = _band_inputs(rng, (2, Z, 40))
    e_test[:, :, :5] = e_ref[:, :, :5]
    e_test[:, :10, 20:] = 10.0 ** rng.uniform(-2, 0, (2, 10, 20))  # l < 0
    want = jit(JMOVS.prob_detect, "use_floor")(
        jnp.asarray(e_ref), jnp.asarray(e_test), use_floor)
    got = MOVS.prob_detect(tt(e_ref), tt(e_test), use_floor)
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-12


@pytest.mark.parametrize("subtract_dc", [True, False])
def test_ehs_matches_jax(consts, subtract_dc):
    jk, k = consts
    rng = np.random.default_rng(10)
    ref, test, delta = _spectra(rng)
    thresh_r = rng.uniform(size=(2, 30)) > 0.3
    thresh_t = rng.uniform(size=(2, 30)) > 0.3
    jsettings = C.Settings(ehs_subtract_dc_before_window=subtract_dc)
    settings = convert.settings_from_jax(jsettings)
    window = EP.ehs_correlation_window(settings.center_ehs_correlation_window)
    want = jit(JMOVS.ehs, "settings", "dtype")(
        jnp.asarray(ref), jnp.asarray(test), jnp.asarray(thresh_r),
        jnp.asarray(thresh_t), jsettings, jnp.float64,
        delta_weighted=jnp.asarray(delta), ehs_zero=jk.ehs_zero)
    got = MOVS.ehs(tt(ref), tt(test), tt(thresh_r), tt(thresh_t), settings,
                   tt(window), tt(delta), k.ehs_zero)
    assert rel(got[0], want[0]) < 1e-9
    np.testing.assert_array_equal(got[1], want[1])


def test_accumulators_match_jax():
    rng = np.random.default_rng(11)
    f = 64
    above = rng.uniform(size=f) > 0.3
    above[:5] = False
    above[-7:] = False
    has, active, committed = accum.activity(tt(above))
    for g, w in zip((has, active, committed),
                    jit(JACC.activity)(jnp.asarray(above))):
        np.testing.assert_array_equal(g, w)
    v = rng.uniform(0.1, 3.0, (f, 2))
    w = rng.uniform(0.1, 1.0, (f, 2))
    mask = rng.uniform(size=(f, 2)) > 0.4
    j = lambda *xs: [jnp.asarray(x) for x in xs]    # noqa: E731
    t = lambda *xs: [tt(x) for x in xs]             # noqa: E731
    for name in ("avg", "avg_log", "rms", "rms_asym"):
        assert rel(getattr(accum, name)(*t(v, w, mask)),
                   jit(getattr(JACC, name))(*j(v, w, mask))) < 1e-12, name
    steps = rng.uniform(0, 3, f)
    for m in (mask[:, 0], np.zeros(f, bool)):
        assert rel(accum.adb(*t(steps, m)),
                   jit(JACC.adb)(*j(steps, m))) < 1e-12
    assert float(accum.adb(*t(np.zeros(f), mask[:, 0]))) == -0.5
    called = np.zeros(f, bool)
    called[24:] = True
    act, com = np.asarray(active), np.asarray(committed)
    assert rel(accum.filtered_max(*t(v[:, 0], act, com)),
               jit(JACC.filtered_max)(*j(v[:, 0], act, com))) < 1e-12
    for c in (called[:, None], (called & (np.arange(f) % 9 > 0))[:, None]):
        assert rel(accum.avg_window(*t(v, c & act[:, None], com[:, None])),
                   jit(JACC.avg_window)(*j(v, c & act[:, None],
                                           com[:, None]))
                   ) < 1e-12


def test_linear_recurrence_and_running_max():
    rng = np.random.default_rng(12)
    a = rng.uniform(0.5, 1.0, (37, 3))
    b = rng.standard_normal((37, 3))
    y0 = rng.standard_normal(3)
    for axis, (aa, bb) in ((0, (a, b)), (1, (a.T, b.T))):
        want = jit(JIIR.linear_recurrence, "axis")(
            jnp.asarray(aa), jnp.asarray(bb), axis=axis, y0=jnp.asarray(y0))
        got = iir.linear_recurrence(tt(aa), tt(bb), axis=axis, y0=tt(y0))
        assert rel(got, want) < 1e-12
        assert rel(iir.running_max(tt(bb), axis),
                   jit(JIIR.running_max, "axis")(jnp.asarray(bb),
                                                 axis=axis)) == 0.0


def test_cognitive_model_matches_jax():
    rng = np.random.default_rng(13)
    lo, hi = C.NN_AMIN_BASIC, C.NN_AMAX_BASIC
    movs = lo + (hi - lo) * rng.uniform(-0.2, 1.2, (7, 11))
    for clamp in (False, True):
        want = jit(JNN.di_basic, "clamp")(jnp.asarray(movs), clamp=clamp)
        assert rel(NN.di_basic(tt(movs), clamp), want) < 1e-12
        model = NN.CognitiveModel.standard(False)
        assert rel(model(tt(movs), clamp), want) < 1e-12
        assert rel(NN.odg(NN.di_basic(tt(movs), clamp)),
                   JNN.odg(want)) < 1e-12
    lo, hi = C.NN_AMIN_ADVANCED, C.NN_AMAX_ADVANCED
    movs = lo + (hi - lo) * rng.uniform(0.0, 1.0, (5, 5))
    assert rel(NN.di_advanced(tt(movs)),
               JNN.di_advanced(jnp.asarray(movs))) < 1e-12


@pytest.mark.parametrize("band_count,dtype", [
    (109, jnp.float64), (109, jnp.float32), (73, jnp.float64)])
def test_fft_consts_from_jax_equal_native(band_count, dtype):
    params = EP.fft_ear_params(band_count)
    jk = JFE.build_consts(params, dtype=dtype)
    leaves = {f: np.asarray(getattr(jk, f)) for f in FE.CONST_FIELDS}
    got = convert.fft_consts_from_jax(leaves)
    want = FE.build_consts(params, getattr(torch, np.dtype(dtype).name))
    assert got.band_count == want.band_count == band_count
    assert got.group_bin_hi == want.group_bin_hi == jk.group_bin_hi
    assert got.dz02 == want.dz02 == float(0.2 * np.asarray(jk.delta_z))
    for name in FE.CONST_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("advanced", [False, True])
def test_cognitive_from_jax_equals_native(advanced):
    params = {k: np.asarray(v)
              for k, v in JNN.init_cognitive_params(advanced).items()}
    got = convert.cognitive_from_jax(params)
    want = NN.CognitiveModel.standard(advanced)
    for name in NN.WEIGHT_NAMES:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without pulling
    in JAX or any module of the JAX package gstpeaq_tpu; no source line of
    either imports gstpeaq_tpu."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import gstpeaq_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'gstpeaq_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "import gstpeaq_tpu_torch.tools.bench\n"
        "import gstpeaq_tpu_torch.tools.codec_sweep\n"
        "import gstpeaq_tpu_torch.tools.longform_bench\n"
        "import gstpeaq_tpu_torch.tools.optimize_settings\n"
        "import gstpeaq_tpu_torch.tools.stream_step_ab\n"
        "assert P.PeaqStream is P.parallel.stream.PeaqStream\n"
        "assert len(names) >= 29, names\n"
        "for n in ('models.advanced', 'ops.fb_ear', 'ops.cuda_fb',\n"
        "          'ops.cuda_dc', 'constants', 'earparams',\n"
        "          'utils.testsignals', 'utils.corpus', 'parallel.batch',\n"
        "          'utils.benchpairs', 'parallel.stream',\n"
        "          'models.modulation', 'utils.checkpoint'):\n"
        "    assert 'gstpeaq_tpu_torch.' + n in names, n\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'gstpeaq_tpu' or m.startswith('gstpeaq_tpu.')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    imports = re.compile(r"^\s*(from\s+gstpeaq_tpu[\s.]|import\s+gstpeaq_tpu"
                         r"(\s|\.|,|$))", re.M)
    for path in [root / "chip_smoke.py",
                 *(root / "gstpeaq_tpu_torch").rglob("*.py")]:
        assert not imports.search(path.read_text()), path
