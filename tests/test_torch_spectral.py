"""S1 `pair_frames` and S2 `spectral_movs` (ops/cuda_spectral.py) on the CPU,
where the wrappers take their plain versions.

The plain `fft_ear.stateless_pair_movs` is held bit for bit to the
composition it replaced (stateless_pair_hop, then bandwidth, nmr and ehs)
in float64 and float32, and its quantities to the JAX package's
fft_ear.stateless_pair_hop and movs.bandwidth / nmr / ehs: the bars of
tests/test_torch_modules.py, 1e-9 relative where the two sides' rDFTs are
different FFT libraries (MKL inside torch, XLA's on the JAX side) and the
indices and gate bits equal.  The inputs, made with numpy from a seed,
take every branch of the stage: silent frames, identical frames, a test
that removes a bin (EHS's log regime), the DC bin under ehs_zero, rows of
bandwidth 0 and of bandwidth above 346.  The compact group table S2 reads
is held to the grouping matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import constants as JC
from gstpeaq_tpu import earparams as JEP
from gstpeaq_tpu.models import movs as JMOVS
from gstpeaq_tpu.ops import fft_ear as JFE
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch import convert
from gstpeaq_tpu_torch import earparams as EP
from gstpeaq_tpu_torch.models import movs as MOVS
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_spectral
from gstpeaq_tpu_torch.ops import fft_ear as FE

FRAMES = 24
# (band count, spread_ref_only, bandwidth): basic, advanced, the advanced
# FFT chunk step (both signals, no bandwidth), a non-default band count
MODES = [(C.BASIC_BAND_COUNT, False, True),
         (C.ADVANCED_FFT_BAND_COUNT, True, False),
         (C.ADVANCED_FFT_BAND_COUNT, False, False),
         (77, False, True)]


def tt(x):
    return torch.from_numpy(np.array(x))


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_array_equal(got[~ok], want[~ok])
    if not ok.any():
        return 0.0
    return np.abs(got[ok] - want[ok]).max() / max(np.abs(want[ok]).max(),
                                                  1e-300)


def branch_blocks(seed: int = 3):
    """Hop blocks [2 ch, FRAMES + 1, 1024] of (ref, test) that take every
    branch of the stage.  Channel 0: noise below 16 kHz, so bandwidth
    passes 346, with a 2,343.75 Hz tone (bin 100) that the test removes
    (EHS's log regime) and small noise added to the test; blocks 0-4
    silent in both (pr = pt = 0, bandwidth 0), blocks 5-9 identical (d
    exactly 0).  Channel 1: white noise at its own level, the test with
    loud noise above 921 bins (zt so large that bandwidth is 0)."""
    rng = np.random.default_rng(seed)
    n = (FRAMES + 1) * 1024
    spec = np.fft.rfft(rng.standard_normal((2, n)), axis=-1)
    spec[0, 16000 * n // 48000:] = 0.0
    ref = np.fft.irfft(spec, n=n, axis=-1) * 0.05
    ref[1] = rng.standard_normal(n) * 0.01
    tone = 0.3 * np.sin(2 * np.pi * 100 / 2048 * np.arange(n))
    ref[0] += tone
    test = ref.copy()
    test[0] += -tone + 0.001 * rng.standard_normal(n)
    hiss = np.fft.rfft(rng.standard_normal(n))
    hiss[:int(22000 * n / 48000)] = 0.0
    test[1] += np.fft.irfft(hiss, n=n) * 5.0
    for x in (ref, test):
        x[:, :5 * 1024] = 0.0
    test[:, 5 * 1024:10 * 1024] = ref[:, 5 * 1024:10 * 1024]
    return (ref.reshape(2, FRAMES + 1, 1024),
            test.reshape(2, FRAMES + 1, 1024))


def composition(k, ref, test, spread_ref_only, exc, settings, window):
    """The bin-domain stage as the port composed it before S1 and S2:
    stateless_pair_hop, then bandwidth, nmr and ehs on its spectra."""
    hi = k.group_bin_hi
    power, uns, thresh, delta = FE.stateless_pair_hop(k, ref, test,
                                                      spread_ref_only)
    bw = MOVS.bandwidth(power[0], power[1])
    nmr = MOVS.nmr(k.group_matrix[:hi], k.masking_difference,
                   power[0][..., :hi], power[1][..., :hi], exc, delta)
    ehs = MOVS.ehs(power[0], power[1], thresh[0], thresh[1], settings,
                   window, delta, k.ehs_zero)
    return uns, thresh, bw, nmr, ehs


def split(k, ear, exc, settings, window):
    """The same from stateless_pair_movs and the band-domain halves."""
    nmr = MOVS.nmr_from_bands(k.masking_difference, ear.noise_in_bands, exc)
    ehs = MOVS.ehs_from_difference(ear.ehs_difference, ear.threshold[0],
                                   ear.threshold[1], settings, window)
    return nmr, ehs


def excitation(k, seed=4):
    z = k.band_count
    return tt(10.0 ** np.random.default_rng(seed).uniform(2, 7, (2, FRAMES,
                                                                 z))).to(
        k.internal_noise.dtype)


@pytest.mark.parametrize("band_count,ref_only,bandwidth", MODES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_movs_equal_the_composition(band_count, ref_only, bandwidth,
                                         dtype):
    """The plain stateless_pair_movs and the halves of nmr and ehs give
    the composition's results bit for bit."""
    k = FE.build_consts(EP.fft_ear_params(band_count), dtype)
    ref, test = (tt(x) for x in branch_blocks())
    settings = C.DEFAULT_SETTINGS
    window = tt(EP.ehs_correlation_window(
        settings.center_ehs_correlation_window)).to(dtype)
    exc = excitation(k)
    ear = FE.stateless_pair_movs(k, ref, test, ref_only, bandwidth)
    uns, thresh, bw, nmr, ehs = composition(k, ref, test, ref_only, exc,
                                            settings, window)
    assert torch.equal(ear.unsmeared, uns)
    assert torch.equal(ear.threshold, thresh)
    if bandwidth:
        for g, w in zip(ear.bandwidth, bw):
            assert torch.equal(g, w)
    else:
        assert ear.bandwidth is None
    got_nmr, got_ehs = split(k, ear, exc, settings, window)
    for g, w in zip((*got_nmr, *got_ehs), (*nmr, *ehs)):
        assert torch.equal(g, w)
    assert ear.noise_in_bands.dtype == ear.ehs_difference.dtype == dtype


def test_inputs_take_every_branch():
    """branch_blocks' rows reach each branch, in float64."""
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT))
    ref, test = (tt(x) for x in branch_blocks())
    power, _, thresh, delta = FE.stateless_pair_hop(k, ref, test)
    d = MOVS.ehs_log_difference(power[0], power[1], delta, k.ehs_zero)
    bw_ref, _, valid = MOVS.bandwidth(power[0], power[1])
    rw, tw = power[0][..., :512], power[1][..., :512]
    silent = (rw == 0) & (tw == 0)
    assert silent[:, :4].all() and not silent[:, 10:].any()
    assert (d[:, 5:9] == 0).all()                  # identical frames
    ratio = (delta[..., :512] / rw).abs()
    assert ((ratio > 0.5) & (tw > 0))[0, 10:, 100].all()   # log regime
    assert (d[..., 0] == 0).all() and k.ehs_zero[0]         # the DC bin
    assert (bw_ref[0, :4] == 0).all() and (bw_ref[1, 10:] == 0).all()
    assert valid[0, 10:].all()
    assert thresh[:, :, 10:].all() and not thresh[:, :, :4].any()


def jax_stage(band_count, ref_only):
    """The JAX package's stateless_pair_hop on branch_blocks, its consts
    and the port's."""
    jk = JFE.build_consts(JEP.fft_ear_params(band_count),
                          truncate_spectrum=ref_only)
    k = FE.build_consts(EP.fft_ear_params(band_count))
    assert k.group_bin_hi == jk.group_bin_hi
    ref, test = branch_blocks()
    out = jax.jit(JFE.stateless_pair_hop, static_argnames="spread_ref_only")(
        jk, jnp.asarray(ref), jnp.asarray(test), spread_ref_only=ref_only)
    return jk, k, ref, test, out


def jax_nmr_ehs(jk, k, out, exc, subtract_dc):
    """JAX movs.nmr and movs.ehs on stateless_pair_hop's outputs."""
    hi = k.group_bin_hi
    power, _, thresh, delta = out
    nmr = jax.jit(JMOVS.nmr)(jk.group_matrix[:hi], jk.masking_difference,
                             power[0][..., :hi], power[1][..., :hi],
                             jnp.asarray(exc.numpy()), delta_weighted=delta)
    settings = JC.Settings(ehs_subtract_dc_before_window=subtract_dc)
    ehs = jax.jit(JMOVS.ehs, static_argnames=("settings", "dtype"))(
        power[0], power[1], thresh[0], thresh[1], settings, jnp.float64,
        delta_weighted=delta, ehs_zero=jk.ehs_zero)
    return nmr, ehs, convert.settings_from_jax(settings)


@pytest.mark.parametrize("band_count,ref_only,bandwidth", MODES)
def test_pair_movs_match_jax(band_count, ref_only, bandwidth):
    """stateless_pair_movs, float64, against JAX stateless_pair_hop,
    bandwidth and nmr through each package's own rDFT: the unsmeared
    excitation and NMR within 1e-9 (two FFT libraries), bandwidth and the
    gate bits equal.  EHS's value is held on one rDFT in
    test_spectral_stage_matches_jax: its normalised autocorrelation lifts
    the libraries' ~1e-12 difference in d to ~1e-8."""
    jk, k, ref, test, out = jax_stage(band_count, ref_only)
    power, uns, thresh, _ = out
    ear = FE.stateless_pair_movs(k, tt(ref), tt(test), ref_only, bandwidth)
    assert rel(ear.unsmeared, uns) < 1e-9
    np.testing.assert_array_equal(ear.threshold, thresh)
    if bandwidth:
        for g, w in zip(ear.bandwidth,
                        jax.jit(JMOVS.bandwidth)(power[0], power[1])):
            np.testing.assert_array_equal(g, w)
    exc = excitation(k)
    nmr, ehs, _ = jax_nmr_ehs(jk, k, out, exc, False)
    got = MOVS.nmr_from_bands(k.masking_difference, ear.noise_in_bands, exc)
    assert rel(got[0], nmr[0]) < 1e-9
    np.testing.assert_array_equal(got[1], nmr[1])
    np.testing.assert_array_equal(
        torch.any(ear.threshold[0] | ear.threshold[1], dim=-2), ehs[1])


@pytest.mark.parametrize("band_count,ref_only,bandwidth", MODES)
@pytest.mark.parametrize("subtract_dc", [False, True])
def test_spectral_stage_matches_jax(band_count, ref_only, bandwidth,
                                    subtract_dc):
    """S1 and S2's plain versions, float64, on the rDFT that JAX's
    stateless_pair_hop takes on the CPU (jnp.fft.rfft of the windowed
    frames), against JAX: the band powers (power @ group_matrix), NMR and
    EHS within 1e-12, bandwidth equal."""
    jk, k, ref, test, out = jax_stage(band_count, ref_only)
    power = out[0]
    frames, _ = cuda_spectral.pair_frames_plain(tt(ref), tt(test), k.hann)
    spectra = torch.view_as_real(tt(np.array(jnp.fft.rfft(
        jnp.asarray(frames.numpy()), axis=-1))))
    s = cuda_spectral.spectral_movs_plain(
        spectra, k.level_factor, k.group_matrix, k.group_bin_hi, k.ehs_zero,
        ref_only, bandwidth)
    band = jnp.maximum(jnp.dot(power[0] if ref_only else power,
                               jk.group_matrix,
                               precision=jax.lax.Precision.HIGHEST), 1e-12)
    assert rel(s.band_power, band) < 1e-12
    if bandwidth:
        for g, w in zip(s.bandwidth,
                        jax.jit(JMOVS.bandwidth)(power[0], power[1])):
            np.testing.assert_array_equal(g, w)
    exc = excitation(k)
    nmr, ehs, settings = jax_nmr_ehs(jk, k, out, exc, subtract_dc)
    got = MOVS.nmr_from_bands(k.masking_difference, s.noise_in_bands, exc)
    assert rel(got[0], nmr[0]) < 1e-12
    np.testing.assert_array_equal(got[1], nmr[1])
    window = tt(EP.ehs_correlation_window(
        settings.center_ehs_correlation_window))
    thresh = tt(np.array(out[2]))
    got = MOVS.ehs_from_difference(s.ehs_difference, thresh[0], thresh[1],
                                   settings, window)
    assert rel(got[0], ehs[0]) < 1e-12
    np.testing.assert_array_equal(got[1], ehs[1])


@pytest.mark.parametrize("band_count", [C.BASIC_BAND_COUNT,
                                        C.ADVANCED_FFT_BAND_COUNT, 77, 20])
def test_group_table_is_the_matrix(band_count):
    """group_table holds each band's weights as one run: the matrix
    rebuilt from it equals group_matrix bit for bit, and the runs summed
    in bin order (S2's order) equal spectrum @ group_matrix within 1e-15
    (max|d| / max|ref|)."""
    k = FE.build_consts(EP.fft_ear_params(band_count))
    gm = k.group_matrix.numpy()
    span, weights = k.group_span.numpy(), k.group_weights.numpy()
    assert span.shape == (3, band_count) and span.dtype == np.int32
    rebuilt = np.zeros_like(gm)
    for b, (first, count, off) in enumerate(span.T):
        rebuilt[first:first + count, b] = weights[off:off + count]
        assert count > 0 and gm[first, b] != 0 and gm[first + count - 1, b]
    np.testing.assert_array_equal(rebuilt, gm)
    assert (span[0] + span[1]).max() <= k.group_bin_hi
    p = 10.0 ** np.random.default_rng(5).uniform(-3, 8, (40, gm.shape[0]))
    want = p @ gm
    got = np.zeros_like(want)
    for b, (first, count, off) in enumerate(span.T):
        for i in range(count):
            got[:, b] += p[:, first + i] * weights[off + i]
    assert rel(got, want) < 1e-15


def test_split_halves_compose_to_nmr_and_ehs():
    """nmr_noise_bands + nmr_from_bands and ehs_log_difference +
    ehs_from_difference give nmr and ehs bit for bit on random spectra."""
    rng = np.random.default_rng(8)
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT))
    hi = k.group_bin_hi
    env = 10.0 ** (8.0 - 10.0 * np.arange(1025) / 1025)
    ref = tt(env * rng.uniform(0.1, 1.0, (2, 30, 1025)))
    test = ref * tt(rng.uniform(0.3, 1.7, (2, 30, 1025)))
    delta = ref - test
    exc = tt(10.0 ** rng.uniform(2, 7, (2, 30, k.band_count)))
    thr = tt(rng.uniform(size=(2, 2, 30)) > 0.3)
    window = tt(EP.ehs_correlation_window(False))
    want = MOVS.nmr(k.group_matrix[:hi], k.masking_difference,
                    ref[..., :hi], test[..., :hi], exc, delta[..., :hi])
    got = MOVS.nmr_from_bands(k.masking_difference, MOVS.nmr_noise_bands(
        k.group_matrix[:hi], ref[..., :hi], test[..., :hi],
        delta[..., :hi]), exc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for settings in (C.DEFAULT_SETTINGS,
                     C.Settings(ehs_subtract_dc_before_window=True)):
        want = MOVS.ehs(ref, test, thr[0], thr[1], settings, window, delta,
                        k.ehs_zero)
        got = MOVS.ehs_from_difference(
            MOVS.ehs_log_difference(ref, test, delta, k.ehs_zero), thr[0],
            thr[1], settings, window)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """Without nvcc the module imports and a CPU tensor runs the plain
    versions, launching nothing; the frames and spectra are contiguous."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(cuda_spectral, "pair_frames_launches", 0)
    monkeypatch.setattr(cuda_spectral, "spectral_movs_launches", 0)
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT))
    ref, test = (tt(x) for x in branch_blocks())
    frames, energy = cuda_spectral.pair_frames(ref, test, k.hann)
    want = cuda_spectral.pair_frames_plain(ref, test, k.hann)
    assert torch.equal(frames, want[0]) and torch.equal(energy, want[1])
    assert frames.shape == (2, 2, FRAMES, 2048) and frames.is_contiguous()
    spectra = torch.view_as_real(torch.fft.rfft(frames, dim=-1))
    got = cuda_spectral.spectral_movs(
        spectra, k.level_factor, k.group_matrix, k.group_bin_hi,
        k.group_span, k.group_weights, k.ehs_zero)
    want = cuda_spectral.spectral_movs_plain(
        spectra, k.level_factor, k.group_matrix, k.group_bin_hi, k.ehs_zero)
    assert got.band_power.shape == (2, 2, FRAMES, C.BASIC_BAND_COUNT)
    assert got.ehs_difference.shape == (2, FRAMES, 512)
    for g, w in zip((*got[:3], *got.bandwidth), (*want[:3], *want.bandwidth)):
        assert torch.equal(g, w)
    assert (cuda_spectral.pair_frames_launches,
            cuda_spectral.spectral_movs_launches) == (0, 0)


def test_other_devices_raise_without_fallback():
    """A tensor on neither the CPU nor a CUDA card is refused before any
    build, as are shapes the kernels do not take."""
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT)).to("meta")
    blocks = torch.ones(2, 5, 1024, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_spectral.pair_frames(blocks, blocks, k.hann)
    with pytest.raises(ValueError, match="expected"):
        cuda_spectral.pair_frames(blocks[..., :512], blocks[..., :512],
                                  k.hann)
    spectra = torch.ones(2, 2, 4, 1025, 2, device="meta",
                         dtype=torch.float64)
    args = (k.level_factor, k.group_matrix, k.group_bin_hi, k.group_span,
            k.group_weights, k.ehs_zero)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_spectral.spectral_movs(spectra, *args)
    with pytest.raises(ValueError, match="expected"):
        cuda_spectral.spectral_movs(spectra[..., :1024, :], *args)


def test_spectral_entries_are_bound():
    """The C entries of csrc/spectral.cu have their ctypes signatures, and
    the flags are the source's."""
    text = (_build.CSRC / "spectral.cu").read_text()
    for name in ("pair_frames", "spectral_movs"):
        for suffix in ("f32", "f64"):
            assert f"peaq_{name}_{suffix}" in _build.SIGNATURES
            assert f"int peaq_{name}_{suffix}(" in text
    assert f"constexpr int kRefOnly = {cuda_spectral.REF_ONLY};" in text
    assert f"constexpr int kBandwidth = {cuda_spectral.BANDWIDTH};" in text
    assert f"constexpr int kEhsBins = {cuda_spectral.EHS_BINS};" in text
