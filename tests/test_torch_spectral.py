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
is held to the grouping matrix.  S2's walk (csrc/spectral.cu) is
re-enacted in numpy from the source's constants and held to the plain
version; the bins from group_bin_hi up are shown unneeded without the
bandwidth flag; the host planner (cuda_spectral.movs_plan) is held at
every shape the main path gives S2, with each row's bulk copies in bounds
and on 16-byte boundaries.
"""

import pathlib
import re
import threading

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
from gstpeaq_tpu_torch.ops import exact
from gstpeaq_tpu_torch.ops import fft_ear as FE

ROOT = pathlib.Path(__file__).resolve().parents[1]
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
    frames, _, _ = cuda_spectral.pair_frames_plain(tt(ref), tt(test),
                                                   k.hann)
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
    frames, energy, halves = cuda_spectral.pair_frames(ref, test, k.hann)
    want = cuda_spectral.pair_frames_plain(ref, test, k.hann)
    assert torch.equal(frames, want[0]) and torch.equal(energy, want[1])
    assert torch.equal(halves, want[2])
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
    k = source_constants()
    assert (k["kMovsThreads"], k["kReduceWarps"], k["kZtEnd"]) == (
        cuda_spectral.MOVS_THREADS, cuda_spectral.REDUCE_WARPS,
        cuda_spectral.ZT_END)
    assert (k["kResidentFloat"], k["kResidentDouble"]) == (
        cuda_spectral.MOVS_RESIDENT[torch.float32],
        cuda_spectral.MOVS_RESIDENT[torch.float64])
    assert (k["kRowThreads"], k["kRowResidentFloat"],
            k["kRowResidentDouble"]) == (
        cuda_spectral.ROW_THREADS, cuda_spectral.ROW_RESIDENT[torch.float32],
        cuda_spectral.ROW_RESIDENT[torch.float64])
    assert ("constexpr int kMovsResident = sizeof(T) == 8 ? kResidentDouble "
            ": kResidentFloat;") in text
    assert "__launch_bounds__(kMovsThreads, kMovsResident<T>)" in text
    assert ("    sizeof(T) == 8 ? kRowResidentDouble : kRowResidentFloat;"
            in text)
    assert "__launch_bounds__(kRowThreads, kRowResident<T>)" in text
    # each launch's form and reduction threads: the ring's form threads
    # and reduction warps fill its block, a row block's warps do both
    assert "reduce_row<T, kReduceWarps>(" in text
    assert "form_row<T, kFormThreads>(" in text
    assert "reduce_row<T, kRowWarps>(" in text
    assert k["kFormThreads"] + 32 * k["kReduceWarps"] == k["kMovsThreads"]
    assert 32 * k["kRowWarps"] == k["kRowThreads"]


def offset_copy(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x copied into a fresh buffer `offset` elements past its start."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def pair_movs_values(k, ref, test) -> list:
    ear = FE.stateless_pair_movs(k, ref, test)
    return [ear.unsmeared, ear.threshold, ear.noise_in_bands,
            ear.ehs_difference, *ear.bandwidth]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_route_is_steady_across_buffers_and_threads(dtype):
    """The plain stateless_pair_movs gives the same bits for the same
    inputs copied to buffers 1, 3 and 7 elements off their start, at 1, 3
    and 8 intra-op threads, and on a fresh Python thread (ROADMAP.md queue
    C, C5: EHS's log on a worker thread's first call)."""
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT), dtype)
    ref, test = (tt(x) for x in branch_blocks())
    want = pair_movs_values(k, ref, test)
    threads = torch.get_num_threads()
    got = []
    try:
        for offset, n in ((1, 1), (3, 3), (7, 8)):
            torch.set_num_threads(n)
            got.append(pair_movs_values(k, offset_copy(ref, offset),
                                        offset_copy(test, offset)))
        worker = threading.Thread(target=lambda: got.append(
            pair_movs_values(k, offset_copy(ref, 5), offset_copy(test, 5))))
        worker.start()
        worker.join()
    finally:
        torch.set_num_threads(threads)
    assert len(got) == 4
    for values in got:
        for g, w in zip(values, want):
            assert torch.equal(g, w)


def test_band_sum_is_the_span_sum(monkeypatch):
    """exact.band_sum on the CPU is each band's run (group_table, the
    table FFTEarConsts holds for S2) summed from 0 in ascending bins, bit
    for bit, for group_matrix and its [:group_bin_hi] rows; the table is
    built once per matrix view, and again only after the matrix changes
    (C5)."""
    k = FE.build_consts(EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT))
    hi = k.group_bin_hi
    rng = np.random.default_rng(12)
    x = tt(10.0 ** rng.uniform(-3, 8, (3, 5, k.group_matrix.shape[0])))
    span, weights = k.group_span.numpy(), k.group_weights.numpy()
    want = np.zeros((3, 5, span.shape[1]))
    for m in range(span[1].max()):
        inside = m < span[1]
        row = np.where(inside, span[0] + m, 0)
        w = np.where(inside, weights[np.where(inside, span[2] + m, 0)], 0.0)
        want = want + x.numpy()[..., row] * w
    built = []
    group_table = exact.group_table

    def counted(gm):
        built.append(gm.shape)
        return group_table(gm)

    monkeypatch.setattr(exact, "group_table", counted)
    matrix = k.group_matrix.clone()
    for _ in range(2):
        np.testing.assert_array_equal(exact.band_sum(x, matrix).numpy(), want)
        np.testing.assert_array_equal(
            exact.band_sum(x[..., :hi], matrix[:hi]).numpy(), want)
    assert len(built) == 2
    matrix.mul_(2.0)
    np.testing.assert_array_equal(exact.band_sum(x, matrix).numpy(),
                                  2.0 * want)
    assert len(built) == 3


def test_port_takes_every_log_from_exact():
    """No module of the port calls torch.log but ops/exact.py."""
    root = ROOT / "gstpeaq_tpu_torch"
    calls = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if "torch.log(" in p.read_text() and p.name != "exact.py"]
    assert calls == []


def test_port_takes_every_log10_and_exp_from_exact():
    """No module of the port calls torch.log10 or torch.exp but
    ops/exact.py, save models/nn.py's sigmoid, whose autograd training
    needs (ROADMAP.md queue C, C6)."""
    root = ROOT / "gstpeaq_tpu_torch"
    calls = {str(p.relative_to(root)): text.count("torch.log10(")
             + text.count("torch.exp(")
             for p in root.rglob("*.py") if p.name != "exact.py"
             for text in [p.read_text()]}
    assert {name: n for name, n in calls.items() if n} == {
        "models/nn.py": 1}
    assert "return 1.0 / (1.0 + torch.exp(-x))" in (
        root / "models" / "nn.py").read_text()


# csrc/spectral.cu's constants that S2's walk and launch follow
SOURCE = ("kMovsThreads", "kResidentFloat", "kResidentDouble",
          "kMaxStages", "kReduceWarps", "kMaxBandLanesFloat",
          "kMaxBandLanesDouble", "kFormThreads",
          "kRowThreads", "kRowWarps", "kRowResidentFloat",
          "kRowResidentDouble", "kBwBins", "kZtEnd",
          "kBwValid", "kEhsBins", "kBins")
# the bandwidth's 5 dB factor (spectral.cu kFiveDbPower, src/movs.c:41)
FIVE_DB = 3.16227766016838


def source_constants() -> dict:
    """SOURCE's values, each `constexpr int` of the source evaluated in
    order on those before it (kBins = kHop + 1), the one of a type's size
    left out."""
    text = (_build.CSRC / "spectral.cu").read_text()
    known = {}
    for name, value in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                  re.M):
        if "sizeof" not in value:               # kMovsResident<T>
            known[name] = int(eval(value, {}, dict(known)))
    return {name: known[name] for name in SOURCE}


def spectra_of(k, ref, test) -> torch.Tensor:
    """S2's input for hop blocks ref/test: [2, ..., F, 1025, 2]."""
    frames = cuda_spectral.pair_frames_plain(ref, test, k.hann)[0]
    return torch.view_as_real(torch.fft.rfft(frames, dim=-1)).contiguous()


def walk_noise(pr, pt, dp):
    """The kernel's noise spectrum, (dp / (sqrt pr + sqrt pt))^2, a zero
    denominator taken as 1."""
    with np.errstate(all="ignore"):
        denom = np.sqrt(pr) + np.sqrt(pt)
        ratio = dp / np.where(denom > 0, denom, 1)
    return ratio * ratio


def walk_scan(values, limit: int, hit) -> int:
    """The bandwidth warp's top-down scan: 32 bins a step from the step
    holding bin limit - 1 down, a ballot of `hit` over i < limit; the
    highest hit bin + 1 at the first step with one, else 0."""
    base = (limit - 1) & ~31
    while base >= 0:
        i = base + np.arange(32)
        ok = i < limit
        mask = np.zeros(32, bool)
        mask[ok] = hit(values[i[ok]])
        if mask.any():
            return base + 32 - (31 - int(np.nonzero(mask)[0].max()))
        base -= 32
    return 0


# S2's launches as the walk takes them: (form threads, reduction warps)
# of the ring and of a row block
LAUNCHES = {"ring": ("kFormThreads", "kReduceWarps"),
            "row": ("kRowThreads", "kRowWarps")}


def band_lanes(z: int, bandwidth: bool, warps: int, double: bool) -> int:
    """The threads a band of spectral.cu's reduce_row on `warps` warps:
    the summing threads (the warps, less the last with the bandwidth
    flag) give each of the z bands the most lanes, a power of two up to
    kMaxBandLanes of the type (kMaxBandLanesDouble, kMaxBandLanesFloat)."""
    c = source_constants()
    most = c["kMaxBandLanesDouble" if double else "kMaxBandLanesFloat"]
    summing = 32 * (warps - 1 if bandwidth else warps)
    lanes = 1
    while lanes < most and 2 * lanes * z <= summing:
        lanes *= 2
    return lanes


def kernel_walk(k, spectra: np.ndarray, ref_only: bool, bandwidth: bool,
                launch: str):
    """S2 as csrc/spectral.cu walks a row in `launch` (LAUNCHES), in
    numpy in the spectra's dtype, on spectra [2, rows, 1025, 2]: only the
    bins the call reads (bins_read), each formed by its form thread's pass
    (the bins f, f + form threads, ...: pr, pt, dp rounded as the plain
    version, the noise below group_bin_hi, d below 512); each band sum
    over band_lanes lanes of the launch's reduction warps, lane l adding the run's bins l, l + lanes, ...
    in order from 0, then a butterfly over the lanes (xor lanes / 2, ...,
    1); zt a max over pt[921..1023] and the bandwidth by the top-down
    scan.
    Returns (band, noise, d, (bw_ref, bw_test, valid)), each over the
    rows."""
    c = source_constants()
    ft = spectra.dtype.type
    hi = k.group_bin_hi
    bins = cuda_spectral.bins_read(hi, bandwidth)
    level = ft(k.level_factor.item())
    form, warps = (c[name] for name in LAUNCHES[launch])
    # the bins of each form thread's passes, every bin read once
    passes = (np.arange(form)[:, None]
              + form * np.arange(-(-c["kBins"] // form)))
    formed = np.sort(passes[passes < bins])
    np.testing.assert_array_equal(formed, np.arange(bins))
    x = spectra[:, :, formed]
    re_, im_, dre, dim = x[0, ..., 0], x[0, ..., 1], x[1, ..., 0], x[1, ..., 1]
    t_re, t_im = re_ - dre, im_ - dim
    pr = (re_ * re_ + im_ * im_) * level
    pt = (t_re * t_re + t_im * t_im) * level
    n = max(hi, c["kEhsBins"])
    dp = (dre[:, :n] * (re_[:, :n] + t_re[:, :n])
          + dim[:, :n] * (im_[:, :n] + t_im[:, :n])) * level
    q = walk_noise(pr[:, :hi], pt[:, :hi], dp[:, :hi])
    e = c["kEhsBins"]
    with np.errstate(all="ignore"):
        ratio = dp[:, :e] / pr[:, :e]
        d = np.where(np.abs(ratio) <= 0.5, np.log1p(-ratio),
                     np.where(pt[:, :e] > 0, np.log(pt[:, :e] / pr[:, :e]),
                              -np.inf)).astype(ft)
    d[(pr[:, :e] == 0) & (pt[:, :e] == 0)] = 0
    d[:, k.ehs_zero.numpy()] = 0
    span, weights = k.group_span.numpy(), k.group_weights.numpy()
    z = span.shape[1]
    lanes = band_lanes(z, bandwidth, warps, ft is np.float64)
    sums = np.zeros((3, pr.shape[0], z), ft)
    for b, (first, count, off) in enumerate(span.T):
        assert first + count <= hi
        part = np.zeros((3, pr.shape[0], lanes), ft)
        for lane in range(lanes):
            for m in range(lane, count, lanes):
                w = ft(weights[off + m])
                for j, src in enumerate((pr, pt, q)):
                    part[j, :, lane] = part[j, :, lane] + src[:, first + m] * w
        flip = lanes // 2
        while flip:
            part = part + part[..., np.arange(lanes) ^ flip]
            flip //= 2
        sums[..., b] = part[..., 0]
    sums = np.maximum(sums, ft(1e-12))
    band = sums[0] if ref_only else sums[:2]
    bw = None
    if bandwidth:
        rows = pr.shape[0]
        out = np.zeros((3, rows), ft)
        for r in range(rows):
            zt = np.max(pt[r, c["kBwBins"]:c["kZtEnd"]])
            ten, five = ft(10) * zt, ft(FIVE_DB) * zt
            ref = walk_scan(pr[r], c["kBwBins"], lambda v: v > ten)
            out[0, r] = ref
            out[1, r] = walk_scan(pt[r], ref, lambda v: v >= five)
            out[2, r] = ref > c["kBwValid"]
        bw = (out[0], out[1], out[2].astype(bool))
    return band, sums[2], d, bw


def walk_against_plain(k, spectra, ref_only, bandwidth, dtype,
                       launch="ring"):
    """The walk in `launch` on spectra [2, ..., F, 1025, 2] against the plain
    version: band powers, noise and d within 1e-12 (float64) / 1e-5
    (float32), the bandwidth indices and validity equal."""
    bar = 1e-12 if dtype == torch.float64 else 1e-5
    want = cuda_spectral.spectral_movs_plain(
        spectra, k.level_factor, k.group_matrix, k.group_bin_hi, k.ehs_zero,
        ref_only, bandwidth)
    flat = spectra.reshape(2, -1, cuda_spectral.BINS, 2).numpy()
    band, noise, d, bw = kernel_walk(k, flat, ref_only, bandwidth, launch)
    lead = spectra.shape[1:-2]
    z = k.band_count
    got_band = band.reshape(((*lead, z) if ref_only else (2, *lead, z)))
    assert rel(got_band, want.band_power) < bar
    assert rel(noise.reshape(*lead, z), want.noise_in_bands) < bar
    assert rel(d.reshape(*lead, 512), want.ehs_difference) < bar
    if bandwidth:
        for g, w in zip(bw, want.bandwidth):
            np.testing.assert_array_equal(g.reshape(lead), w.numpy())
    else:
        assert bw is None and want.bandwidth is None
    return band, noise, d, bw


@pytest.mark.parametrize("launch", list(LAUNCHES))
@pytest.mark.parametrize("band_count,ref_only,bandwidth", MODES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_walk_equals_the_plain_version(band_count, ref_only,
                                              bandwidth, dtype, launch):
    """S2's walk in each launch, re-enacted in numpy, on branch_blocks'
    rows (silent, identical, a removed bin, bandwidth 0 and above 346) and
    on the same rows scaled by 1e-6 and 1e+3: within 1e-12 / 1e-5 of the
    plain version, the bandwidth indices equal."""
    k = FE.build_consts(EP.fft_ear_params(band_count), dtype)
    ref, test = (tt(x) for x in branch_blocks())
    spectra = spectra_of(k, ref, test)
    for scale in (1.0, 1e-6, 1e3):
        walk_against_plain(k, spectra * scale, ref_only, bandwidth, dtype,
                           launch)


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("launch,band_count,bandwidth,lanes",
                         [("ring", C.BASIC_BAND_COUNT, True, 1),
                          ("ring", C.ADVANCED_FFT_BAND_COUNT, False, 2),
                          ("row", C.BASIC_BAND_COUNT, True, 2),
                          ("row", C.ADVANCED_FFT_BAND_COUNT, False, 4),
                          ("ring", C.BASIC_BAND_COUNT, False, 1),
                          ("row", C.ADVANCED_FFT_BAND_COUNT, True, 4)])
def test_band_lanes_at_the_configurations(launch, band_count, bandwidth,
                                          lanes, double):
    """The threads a band of reduce_row: in double, in a row block (8
    warps) 2 at the basic call's 109 bands with the bandwidth flag (its
    warp scanning alone), 4 at the advanced sites' 55 without, in the ring
    (4 warps) 1 and 2, kMaxBandLanesDouble reached; in float one thread a
    band; each band's lanes inside one warp; the ring's basic bands in two
    turns of its three summing warps."""
    c = source_constants()
    warps = c[LAUNCHES[launch][1]]
    got = band_lanes(band_count, bandwidth, warps, double)
    assert got == (lanes if double else 1)
    assert c["kMaxBandLanesFloat"] == 1
    summing = 32 * (warps - 1 if bandwidth else warps)
    assert 32 % got == 0
    turns = -(-got * band_count // summing)
    assert turns == (2 if (launch, band_count, bandwidth) == (
        "ring", C.BASIC_BAND_COUNT, True) else 1)
    assert max(band_lanes(C.BASIC_BAND_COUNT, True, c["kRowWarps"], True),
               band_lanes(C.ADVANCED_FFT_BAND_COUNT, False, c["kRowWarps"],
                          True)) == c["kMaxBandLanesDouble"]


@pytest.mark.parametrize("ref_only", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bins_from_group_bin_hi_are_not_needed(ref_only, dtype):
    """At both flag sets without the bandwidth (the advanced call, the
    advanced FFT chunk step), spectra whose bins from group_bin_hi up hold
    other finite values give the plain outputs bit for bit, and so does
    the walk, which reads bins below bins_read (= group_bin_hi) alone."""
    k = FE.build_consts(EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT), dtype)
    hi = k.group_bin_hi
    assert cuda_spectral.bins_read(hi, False) == hi
    assert (k.group_matrix[hi:] == 0).all()
    ref, test = (tt(x) for x in branch_blocks())
    spectra = spectra_of(k, ref, test)
    changed = spectra.clone()
    rng = np.random.default_rng(14)
    changed[..., hi:, :] = tt(1e3 * rng.standard_normal(
        changed[..., hi:, :].shape)).to(dtype)
    assert not torch.equal(changed, spectra)
    args = (k.level_factor, k.group_matrix, hi, k.ehs_zero, ref_only, False)
    want = cuda_spectral.spectral_movs_plain(spectra, *args)
    got = cuda_spectral.spectral_movs_plain(changed, *args)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert got.bandwidth is None
    a = walk_against_plain(k, spectra, ref_only, False, dtype)
    b = walk_against_plain(k, changed, ref_only, False, dtype)
    for g, w in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(g, w)


# every S2 shape of chip_smoke.py, (rows, flags): per pair basic and
# advanced [2, 1, 2, 468]; bench's basic [64, 2, 512] and advanced
# [32, 2, 512] batches; the basic and advanced FFT chunk steps at 64 and
# 1,024 frames, one stream and 16
PLAN_SHAPES = [(936, True), (936, False), (65536, True), (32768, False),
               (128, True), (128, False), (2048, True), (2048, False),
               (32768, True)]


@pytest.mark.parametrize("rows,bandwidth", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_movs_plan_at_the_main_path_shapes(rows, bandwidth, dtype):
    """movs_plan on an H100 (132 SMs) at each S2 shape: the ring where it
    gives each row a block of its own (the one-stream chunk-64 step) and
    in double from BATCH_ROWS rows without the bandwidth flag (the
    advanced batch and chunk-1,024 step), MOVS_RESIDENT[dtype] blocks an
    SM (3 float, 2 double) where the rows fill them, every block with a
    row, RING_STAGES (3) stages held to the rows of a block; else a row
    a block, its stage its shared memory, ROW_RESIDENT[dtype] of them an
    SM, prefetching its row into L2 from BATCH_ROWS rows with the
    bandwidth flag (the basic batch and chunk-1,024 step); a forced depth
    held to the rows and the memory; the regions hold the bins read and a
    lead slot in whole lines, and the resident blocks fit an SM's shared
    memory."""
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT))
    hi, z, n_weights = (k.group_bin_hi, k.band_count,
                        k.group_weights.numel())
    args = (rows, hi, bandwidth, dtype, 132, z, n_weights)
    plan = cuda_spectral.movs_plan(*args)
    slot = 16 if dtype == torch.float64 else 8
    resident, row_resident = {torch.float64: (2, 4),
                              torch.float32: (3, 8)}[dtype]
    assert cuda_spectral.MOVS_RESIDENT[dtype] == resident
    assert cuda_spectral.ROW_RESIDENT[dtype] == row_resident
    assert plan.bins == (1024 if bandwidth else hi)
    assert plan.region >= plan.bins + 2
    assert plan.region * slot % 128 == 0
    assert plan.region * slot < (plan.bins + 2) * slot + 128
    stage = 2 * plan.region * slot
    batch = rows >= cuda_spectral.BATCH_ROWS
    assert batch == (rows >= 32768)
    ring_rows = rows <= resident * 132 or (
        dtype == torch.float64 and batch and not bandwidth)
    assert plan.rowwise == (not ring_rows)
    assert plan.prefetch == (plan.rowwise and batch)
    for prefetch in (False, True):
        row = cuda_spectral.movs_plan(*args, rowwise=True,
                                      prefetch=prefetch)
        assert (row.rowwise, row.prefetch, row.stages, row.blocks,
                row.shared) == (True, prefetch, 1, rows, stage)
        assert row_resident * (row.shared + 1024) <= 233472
    ring = cuda_spectral.movs_plan(*args, rowwise=False)
    assert not ring.prefetch
    assert plan == (cuda_spectral.movs_plan(*args, rowwise=True)
                    if plan.rowwise else ring)
    assert ring.blocks == min(rows, resident * 132)
    per_block = -(-rows // ring.blocks)
    stage += 16                             # a ring stage's two mbarriers
    tables = n_weights * slot // 2 + 12 * z + 512
    fit = (233472 // resident - 1024 - tables) // stage
    deepest = cuda_spectral.movs_plan(*args, stages=1 << 20,
                                      rowwise=False).stages
    assert deepest == min(per_block, fit)
    assert ring.stages == min(3, deepest)
    for forced in range(1, deepest + 1):
        got = cuda_spectral.movs_plan(*args, stages=forced, rowwise=False)
        assert got.stages == forced
        assert got.shared == forced * stage + tables
        assert resident * (got.shared + 1024) <= 233472


def row_copy(g: int, bins: int, dtype) -> tuple[int, int]:
    """spectral.cu's row_lead and row_bytes: a spectrum row g's copy as
    (first bin, bytes)."""
    if dtype == torch.float64:
        return 0, 16 * bins
    lead = g & 1
    return -lead, 8 * ((bins + lead + 1) & ~1)


@pytest.mark.parametrize("bins", [512, 769, 1024, 1025])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_row_copies_are_aligned_and_in_bounds(bins, dtype):
    """Each row's bulk copy in the ring, and its L2 prefetch in a row
    block (both spectra: rows g and rows + g of the [2 x rows] of 1,025
    bins), starts on a 16-byte boundary, moves a multiple of 16 bytes,
    covers the bins read, stays inside the tensor and fits its region of
    the stage from its lead slot on."""
    text = (_build.CSRC / "spectral.cu").read_text()
    assert "return sizeof(T) == 4 ? static_cast<int>(g & 1) : 0;" in text
    assert "return sizeof(T) == 8 ? 16u * bins : 8u * ((bins + lead + 1) & ~1);" \
        in text
    slot = 16 if dtype == torch.float64 else 8
    region = cuda_spectral.movs_plan(1, bins, False, dtype, 1, 1, 1).region
    for rows in (1, 2, 3, 936):
        total = 2 * rows * 1025 * slot
        for g in range(2 * rows):
            first, size = row_copy(g, bins, dtype)
            start = (g * 1025 + first) * slot
            assert start % 16 == 0 and size % 16 == 0
            assert 0 <= start and start + size <= total
            assert first + size // slot >= bins
            assert -first + size // slot <= region
