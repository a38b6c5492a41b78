"""Precomputed ear-model parameter bundles (pure NumPy, float64): the
benchmark's frozen copy, read only by its plain references.

Everything the reference computes in its GObject constructors / property
setters is evaluated here once, host-side, and handed to the device pipeline
as constant arrays:

* critical-band tables + grouping weights   (src/fftearmodel.c:692-788)
* outer/middle-ear weights                  (src/fftearmodel.c:246-257)
* internal noise / thresholds / loudness    (src/earmodel.c:278-323)
* per-band IIR time constants               (src/earmodel.c:626-635)
* frequency-spreading helper tables + norm  (src/fftearmodel.c:636-676,778-781)
* filter-bank impulse responses and delays  (src/fbearmodel.c:188-225)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import constants as C


def ear_weight(frequency: np.ndarray) -> np.ndarray:
    """Outer+middle ear weight W(f); src/earmodel.c:701-709."""
    f_khz = np.asarray(frequency, dtype=np.float64) / 1000.0
    with np.errstate(divide="ignore"):
        w_db = (-0.6 * 3.64 * f_khz ** -0.8
                + 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
                - 1e-3 * f_khz ** 3.6)
    return 10.0 ** (w_db / 20.0)


def _c_round(x: np.ndarray) -> np.ndarray:
    """C round(): half away from zero (inputs here are positive)."""
    return np.floor(x + 0.5)


def _band_constants(fc: np.ndarray, loudness_scale: float):
    """Per-band constants of the abstract ear model; src/earmodel.c:300-319."""
    internal_noise = 10.0 ** (0.4 * 0.364 * (fc / 1000.0) ** -0.8)
    excitation_threshold = 10.0 ** (0.364 * (fc / 1000.0) ** -0.8)
    threshold = 10.0 ** (0.1 * (-2.0 - 2.05 * np.arctan(fc / 4000.0)
                                - 0.75 * np.arctan((fc / 1600.0) ** 2)))
    loudness_factor = loudness_scale * (
        excitation_threshold / (1e4 * threshold)) ** 0.23
    return internal_noise, excitation_threshold, threshold, loudness_factor


def time_constants(fc: np.ndarray, step_size: int, tau_min: float,
                   tau_100: float) -> np.ndarray:
    """First-order smoothing coefficients a; src/earmodel.c:626-635."""
    tau = tau_min + 100.0 / fc * (tau_100 - tau_min)
    return np.exp(step_size / (-48000.0 * tau))


@dataclasses.dataclass(frozen=True)
class FFTEarParams:
    """All constants of the FFT-based ear model for a given band count."""

    band_count: int
    delta_z: float
    fc: np.ndarray                   # [Z] band center frequencies
    internal_noise: np.ndarray       # [Z]
    excitation_threshold: np.ndarray  # [Z]
    threshold: np.ndarray            # [Z]
    loudness_factor: np.ndarray      # [Z]
    ear_time_constants: np.ndarray   # [Z] smearing IIR coefficient a
    adapt_time_constants: np.ndarray  # [Z] level-adapter/modproc coefficient
    hann_window: np.ndarray          # [2048]
    outer_middle_ear_weight: np.ndarray  # [1025] (power-domain, squared)
    level_factor: float
    group_matrix: np.ndarray         # [1025, Z] sparse-as-dense grouping weights
    lower_spreading: float           # aL
    lower_spreading_exponentiated: float  # aL**0.4
    a_uc: np.ndarray                 # [Z]
    g_il: np.ndarray                 # [Z]
    spreading_normalization: np.ndarray  # [Z]
    masking_difference: np.ndarray   # [Z]
    loudness_scale: float = C.FFT_LOUDNESS_SCALE
    frame_size: int = C.FFT_FRAMESIZE
    step_size: int = C.FFT_STEPSIZE


def _spread_reference(params_auc, g_il, aLe, delta_z, band_count, pitch_power,
                      normalization):
    """Frequency spreading, direct NumPy transcription of the recurrences in
    src/fftearmodel.c:636-676 (used for the normalization bootstrap and as the
    numerical spec for tests)."""
    Pp = np.asarray(pitch_power, dtype=np.float64)
    Z = band_count
    a_uce = params_auc * Pp ** (0.2 * delta_z)
    g_iu = (1.0 - a_uce ** (Z - np.arange(Z))) / (1.0 - a_uce)
    En = Pp / (g_il + g_iu - 1.0)
    a_ucee = a_uce ** 0.4
    Ene = En ** 0.4
    E2 = np.empty(Z)
    E2[Z - 1] = Ene[Z - 1]
    for i in range(Z - 1, 0, -1):
        E2[i - 1] = aLe * E2[i] + Ene[i - 1]
    for i in range(Z - 1):
        r = Ene[i]
        for j in range(i + 1, Z):
            r *= a_ucee[i]
            E2[j] += r
    return E2 ** (1.0 / 0.4) / normalization


@functools.lru_cache(maxsize=4)
def fft_ear_params(band_count: int = C.BASIC_BAND_COUNT,
                   playback_level: float = 92.0) -> FFTEarParams:
    """Build the FFT ear-model constant bundle; src/fftearmodel.c:692-788."""
    N = C.FFT_FRAMESIZE
    fs = float(C.SAMPLING_RATE)
    delta_z = 27.0 / (band_count - 1)
    zL = 7.0 * np.arcsinh(80.0 / 650.0)
    zU = 7.0 * np.arcsinh(18000.0 / 650.0)
    band = np.arange(band_count, dtype=np.float64)
    zl = zL + band * delta_z
    zu = np.minimum(zU, zL + (band + 1) * delta_z)
    zc = (zu + zl) / 2.0
    fc = 650.0 * np.sinh(zc / 7.0)
    fl = 650.0 * np.sinh(zl / 7.0)
    fu = 650.0 * np.sinh(zu / 7.0)

    lower_end = _c_round(fl / fs * N).astype(np.int64)
    upper_end = _c_round(fu / fs * N).astype(np.int64)
    upper_freq = np.minimum((2 * lower_end + 1) / 2.0 * fs / N, fu)
    lower_weight = (upper_freq - fl) * N / fs
    lower_freq_of_upper = (2 * upper_end - 1) / 2.0 * fs / N
    upper_weight = np.where(lower_end == upper_end, 0.0,
                            (fu - lower_freq_of_upper) * N / fs)

    # Dense [bins, Z] grouping matrix equivalent to
    # peaq_fftearmodel_group_into_bands (src/fftearmodel.c:603-620):
    # full weight for interior bins, fractional weights at the edges.
    bins = np.arange(N // 2 + 1)
    gm = ((bins[:, None] > lower_end[None, :])
          & (bins[:, None] < upper_end[None, :])).astype(np.float64)
    gm[lower_end, np.arange(band_count)] += lower_weight
    gm[upper_end, np.arange(band_count)] += upper_weight

    lower_spreading = 10.0 ** (-2.7 * delta_z)
    aLe = lower_spreading ** 0.4
    a_uc = 10.0 ** ((-2.4 - 23.0 / fc) * delta_z)
    g_il = (1.0 - lower_spreading ** (band + 1)) / (1.0 - lower_spreading)

    masking_difference = 10.0 ** (
        np.where(band * delta_z <= 12.0, 3.0, 0.25 * band * delta_z) / 10.0)

    spreading_normalization = _spread_reference(
        a_uc, g_il, aLe, delta_z, band_count, np.ones(band_count),
        np.ones(band_count))

    k = np.arange(N)
    hann = np.sqrt(8.0 / 3.0) * 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (N - 1)))

    freqs = np.arange(N // 2 + 1) * fs / N
    om_weight = ear_weight(freqs) ** 2

    level_factor = 10.0 ** (playback_level / 10.0) / (
        8.0 / 3.0 * (C.GAMMA / 4 * (N - 1)) * (C.GAMMA / 4 * (N - 1)))

    internal_noise, exc_thres, thres, loud_fac = _band_constants(
        fc, C.FFT_LOUDNESS_SCALE)

    return FFTEarParams(
        band_count=band_count,
        delta_z=delta_z,
        fc=fc,
        internal_noise=internal_noise,
        excitation_threshold=exc_thres,
        threshold=thres,
        loudness_factor=loud_fac,
        ear_time_constants=time_constants(
            fc, C.FFT_STEPSIZE, C.FFT_TAU_MIN, C.FFT_TAU_100),
        adapt_time_constants=time_constants(
            fc, C.FFT_STEPSIZE, C.ADAPT_TAU_MIN, C.ADAPT_TAU_100),
        hann_window=hann,
        outer_middle_ear_weight=om_weight,
        level_factor=level_factor,
        group_matrix=gm,
        lower_spreading=lower_spreading,
        lower_spreading_exponentiated=aLe,
        a_uc=a_uc,
        g_il=g_il,
        spreading_normalization=spreading_normalization,
        masking_difference=masking_difference,
    )


@dataclasses.dataclass(frozen=True)
class FBEarParams:
    """All constants of the filter-bank ear model (advanced version)."""

    band_count: int
    fc: np.ndarray                    # [40]
    internal_noise: np.ndarray        # [40]
    excitation_threshold: np.ndarray  # [40]
    threshold: np.ndarray             # [40]
    loudness_factor: np.ndarray       # [40]
    ear_time_constants: np.ndarray    # [40] forward-masking IIR a (step 192)
    adapt_time_constants: np.ndarray  # [40] level adapter/modproc a (step 192)
    filter_length: np.ndarray         # [40] int
    delay: np.ndarray                 # [40] int, D = 1+(1456-N)/2
    # Complex impulse responses laid out on a common lag axis:
    # fb(t)[band] = sum_lag h[band, lag] * x[t - lag], lag in [0, 1456].
    h_re: np.ndarray                  # [40, 1457]
    h_im: np.ndarray                  # [40, 1457]
    back_mask: np.ndarray             # [11] backward-masking FIR
    level_factor: float
    loudness_scale: float = C.FB_LOUDNESS_SCALE
    frame_size: int = C.FB_FRAMESIZE
    step_size: int = C.FB_FRAMESIZE


@functools.lru_cache(maxsize=2)
def fb_ear_params(playback_level: float = 92.0) -> FBEarParams:
    """Build the filter-bank ear-model constants; src/fbearmodel.c:150-225."""
    Z = C.FB_BAND_COUNT
    band = np.arange(Z, dtype=np.float64)
    asinh_lo = np.arcsinh(50.0 / 650.0)
    asinh_hi = np.arcsinh(18000.0 / 650.0)
    fc = 650.0 * np.sinh(asinh_lo + band * (asinh_hi - asinh_lo) / 39.0)

    lengths = C.FB_FILTER_LENGTH
    delays = 1 + (lengths[0] - lengths) // 2
    max_lag = int(delays[0] + lengths[0])  # = 1457
    h_re = np.zeros((Z, max_lag))
    h_im = np.zeros((Z, max_lag))
    for b in range(Z):
        N = int(lengths[b])
        n = np.arange(N, dtype=np.float64)
        wt = ear_weight(fc[b])
        win = 4.0 / N * np.sin(np.pi * n / N) ** 2 * wt
        phase = 2.0 * np.pi * fc[b] * (n - N / 2.0) / 48000.0
        D = int(delays[b])
        h_re[b, D:D + N] = win * np.cos(phase)
        h_im[b, D:D + N] = win * np.sin(phase)

    i = np.arange(11, dtype=np.float64)
    back_mask = np.cos(np.pi * (i - 5.0) / 12.0) ** 2 * 0.9761 / 6.0

    internal_noise, exc_thres, thres, loud_fac = _band_constants(
        fc, C.FB_LOUDNESS_SCALE)

    return FBEarParams(
        band_count=Z,
        fc=fc,
        internal_noise=internal_noise,
        excitation_threshold=exc_thres,
        threshold=thres,
        loudness_factor=loud_fac,
        ear_time_constants=time_constants(
            fc, C.FB_FRAMESIZE, C.FB_TAU_MIN, C.FB_TAU_100),
        adapt_time_constants=time_constants(
            fc, C.FB_FRAMESIZE, C.ADAPT_TAU_MIN, C.ADAPT_TAU_100),
        filter_length=lengths.copy(),
        delay=delays,
        h_re=h_re,
        h_im=h_im,
        back_mask=back_mask,
        level_factor=10.0 ** (playback_level / 20.0),
    )


def ehs_correlation_window(centered: bool = False) -> np.ndarray:
    """EHS correlation window; src/movs.c:1360-1368."""
    i = np.arange(C.MAXLAG, dtype=np.float64)
    if centered:
        return (0.81649658092773
                * (1 + np.cos(2 * np.pi * i / (2 * C.MAXLAG - 1))) / C.MAXLAG)
    return (0.81649658092773
            * (1 - np.cos(2 * np.pi * i / (C.MAXLAG - 1))) / C.MAXLAG)
