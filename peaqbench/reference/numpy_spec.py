"""Serial NumPy reference implementation of PEAQ (BS.1387-1, gstpeaq
flavor): the benchmark's frozen copy of the numerical specification.

A direct, frame-by-frame, float64 implementation of the algorithms in
gstpeaq's C sources (src/, cited per function).  It is deliberately slow
and simple.  The benchmark's batched reference (`torch_ref.py`) is held to
it by the CPU tests in peaqbench/tests/.  It imports NumPy and SciPy only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import constants as C
from . import earparams as EP

# ---------------------------------------------------------------------------
# FFT ear model (src/fftearmodel.c:432-515)
# ---------------------------------------------------------------------------


class FFTEarState:
    def __init__(self, band_count: int):
        self.filtered_excitation = np.zeros(band_count)
        self.unsmeared_excitation = np.zeros(band_count)
        self.excitation = np.zeros(band_count)
        self.power_spectrum = np.zeros(C.FFT_FRAMESIZE // 2 + 1)
        self.weighted_power_spectrum = np.zeros(C.FFT_FRAMESIZE // 2 + 1)
        self.energy_threshold_reached = False


def fft_ear_spread(p: EP.FFTEarParams, pitch_power: np.ndarray) -> np.ndarray:
    """Frequency spreading; src/fftearmodel.c:636-676."""
    return EP._spread_reference(
        p.a_uc, p.g_il, p.lower_spreading_exponentiated, p.delta_z,
        p.band_count, pitch_power, p.spreading_normalization)


def group_into_bands(p: EP.FFTEarParams, spectrum: np.ndarray) -> np.ndarray:
    """Critical-band grouping with 1e-12 floor; src/fftearmodel.c:603-620."""
    band_power = spectrum @ p.group_matrix
    return np.maximum(band_power, 1e-12)


def fft_ear_process_block(p: EP.FFTEarParams, state: FFTEarState,
                          samples: np.ndarray) -> None:
    """One 2048-sample frame; src/fftearmodel.c:432-515."""
    windowed = p.hann_window * samples.astype(np.float64)
    spec = np.fft.rfft(windowed)
    state.power_spectrum = (spec.real ** 2 + spec.imag ** 2) * p.level_factor
    state.weighted_power_spectrum = (
        state.power_spectrum * p.outer_middle_ear_weight)
    band_power = group_into_bands(p, state.weighted_power_spectrum)
    noisy_band_power = band_power + p.internal_noise
    state.unsmeared_excitation = fft_ear_spread(p, noisy_band_power)
    a = p.ear_time_constants
    state.filtered_excitation = (
        a * state.filtered_excitation + (1.0 - a) * state.unsmeared_excitation)
    state.excitation = np.maximum(state.filtered_excitation,
                                  state.unsmeared_excitation)
    energy = float(np.sum(
        samples[C.FFT_FRAMESIZE // 2:].astype(np.float64) ** 2))
    state.energy_threshold_reached = energy >= C.EHS_ENERGY_THRESHOLD


def calc_loudness(internal_params, excitation: np.ndarray) -> float:
    """Overall loudness; src/earmodel.c:890-907."""
    p = internal_params
    loudness = p.loudness_factor * (
        (1.0 - p.threshold
         + p.threshold * excitation / p.excitation_threshold) ** 0.23 - 1.0)
    return float(np.sum(np.maximum(loudness, 0.0)) * 24.0 / p.band_count)


# ---------------------------------------------------------------------------
# Filter-bank ear model (src/fbearmodel.c:275-435)
# ---------------------------------------------------------------------------


class FBEarState:
    def __init__(self):
        self.hp1_x1 = self.hp1_x2 = 0.0
        self.hp1_y1 = self.hp1_y2 = 0.0
        self.hp2_y1 = self.hp2_y2 = 0.0
        self.fb_buf = np.zeros(C.FB_BUFFER_LENGTH)  # fb_buf[j] = x[t - j]
        self.cu = np.zeros(C.FB_BAND_COUNT)
        self.e0_buf = np.zeros((C.FB_BAND_COUNT, 11))  # [:,0] newest
        self.excitation = np.zeros(C.FB_BAND_COUNT)
        self.unsmeared_excitation = np.zeros(C.FB_BAND_COUNT)


def fb_apply_filter_bank(p: EP.FBEarParams, buf: np.ndarray):
    """Complex FIR filter bank on the lag buffer; src/fbearmodel.c:398-435.

    buf[j] holds x[t - j] for j = 0..1455 (newest first).  The output is
    sum_lag h[band, lag] * x[t - lag] for lag = 0..1456, where the lag-1456
    tap reads the *newest* sample again: the reference's doubled ring buffer
    (src/fbearmodel.c:307-313) wraps the read at index offset+1456 around to
    the cell just written, so x[t - 1456] is aliased to x[t].  Only band 0
    has a (tiny, ~1e-8) coefficient at that lag.
    """
    x_lag = np.concatenate((buf, buf[:1]))  # lag 0..1455, then aliased 1456
    re = p.h_re @ x_lag
    im = p.h_im @ x_lag
    return re, im


def fb_ear_process_block(p: EP.FBEarParams, state: FBEarState,
                         samples: np.ndarray,
                         swap_slope: bool = False) -> None:
    """One 192-sample frame; src/fbearmodel.c:275-396.  `swap_slope` is
    SWAP_SLOPE_FILTER_COEFFICIENTS (settings.h:97)."""
    for k in range(C.FB_FRAMESIZE):
        scaled = float(samples[k]) * p.level_factor
        hp1 = (scaled - 2.0 * state.hp1_x1 + state.hp1_x2
               + C.HP1_A[0] * state.hp1_y1 + C.HP1_A[1] * state.hp1_y2)
        hp2 = (hp1 - 2.0 * state.hp1_y1 + state.hp1_y2
               + C.HP2_A[0] * state.hp2_y1 + C.HP2_A[1] * state.hp2_y2)
        state.hp1_x2, state.hp1_x1 = state.hp1_x1, scaled
        state.hp1_y2, state.hp1_y1 = state.hp1_y1, hp1
        state.hp2_y2, state.hp2_y1 = state.hp2_y1, hp2
        # push newest sample to the front of the lag buffer
        state.fb_buf = np.concatenate(([hp2], state.fb_buf[:-1]))
        if k % C.FB_SUBSAMPLING == 0:
            fb_re, fb_im = fb_apply_filter_bank(p, state.fb_buf)
            a_re = fb_re.copy()
            a_im = fb_im.copy()
            # level-dependent upper spreading; src/fbearmodel.c:326-349
            level = 10.0 * np.log10(fb_re ** 2 + fb_im ** 2)
            s = np.maximum(4.0, 24.0 + 230.0 / p.fc - 0.2 * level)
            dist_s = C.DIST ** s
            if swap_slope:  # src/fbearmodel.c:335-339
                state.cu = dist_s + C.SLOPE_FILTER_A * (state.cu - dist_s)
            else:
                state.cu = state.cu + C.SLOPE_FILTER_A * (dist_s - state.cu)
            for band in range(C.FB_BAND_COUNT):
                d1 = fb_re[band]
                d2 = fb_im[band]
                for j in range(band + 1, C.FB_BAND_COUNT):
                    d1 *= state.cu[band]
                    d2 *= state.cu[band]
                    a_re[j] += d1
                    a_im[j] += d2
            # constant lower spreading; src/fbearmodel.c:351-354
            for band in range(C.FB_BAND_COUNT - 1, 0, -1):
                a_re[band - 1] += C.CL * a_re[band]
                a_im[band - 1] += C.CL * a_im[band]
            e0 = a_re ** 2 + a_im ** 2
            state.e0_buf = np.concatenate(
                [e0[:, None], state.e0_buf[:, :-1]], axis=1)
    # backward masking FIR over the last 11 subsampled instants;
    # src/fbearmodel.c:371-383
    e1 = state.e0_buf @ p.back_mask
    state.unsmeared_excitation = e1 + p.internal_noise
    a = p.ear_time_constants
    state.excitation = (a * state.excitation
                        + (1.0 - a) * state.unsmeared_excitation)


def dc_reject(x: np.ndarray) -> np.ndarray:
    """Two cascaded DC-rejection high-pass stages; src/fbearmodel.c:291-303.

    Stage n: y[t] = x[t] - 2 x[t-1] + x[t-2] + a1 y[t-1] + a2 y[t-2].
    """
    from scipy.signal import lfilter
    b = [1.0, -2.0, 1.0]
    y1 = lfilter(b, [1.0, -C.HP1_A[0], -C.HP1_A[1]], x)
    return lfilter(b, [1.0, -C.HP2_A[0], -C.HP2_A[1]], y1)


def fb_process_signal(p: EP.FBEarParams, signal: np.ndarray,
                      swap_slope: bool = False):
    """Whole-signal filter-bank ear model (vectorized NumPy).

    Semantically identical to repeated fb_ear_process_block calls on
    consecutive 192-sample frames (signal length must be a multiple of 192).
    `swap_slope` is SWAP_SLOPE_FILTER_COEFFICIENTS (settings.h:97).
    Returns (excitation[F, 40], unsmeared_excitation[F, 40]).
    """
    n = signal.shape[0]
    assert n % C.FB_FRAMESIZE == 0
    frames = n // C.FB_FRAMESIZE
    sub = C.FB_SUBSAMPLING
    hp2 = dc_reject(signal.astype(np.float64) * p.level_factor)
    # windows of the 1456 most recent samples at each subsampled instant;
    # the aliased lag-1456 tap (see fb_apply_filter_bank) is folded into the
    # lag-0 column of the coefficient matrix.
    padded = np.concatenate([np.zeros(C.FB_BUFFER_LENGTH - 1), hp2])
    t_inst = np.arange(0, n, sub)
    win = np.lib.stride_tricks.sliding_window_view(
        padded, C.FB_BUFFER_LENGTH)[t_inst]
    # win[i, j] = x[t_i - 1455 + j]  ->  reverse to lag order x[t - lag]
    x_lag = win[:, ::-1]
    h_re = p.h_re[:, :C.FB_BUFFER_LENGTH].copy()
    h_im = p.h_im[:, :C.FB_BUFFER_LENGTH].copy()
    h_re[:, 0] += p.h_re[:, C.FB_BUFFER_LENGTH]
    h_im[:, 0] += p.h_im[:, C.FB_BUFFER_LENGTH]
    fb_re = x_lag @ h_re.T  # [I, 40]
    fb_im = x_lag @ h_im.T
    # level-dependent upper-slope state; src/fbearmodel.c:326-349
    with np.errstate(divide="ignore"):
        level = 10.0 * np.log10(fb_re ** 2 + fb_im ** 2)
    s = np.maximum(4.0, 24.0 + 230.0 / p.fc - 0.2 * level)
    dist_s = C.DIST ** s
    cu = np.empty_like(dist_s)
    prev = np.zeros(C.FB_BAND_COUNT)
    for i in range(dist_s.shape[0]):
        if swap_slope:  # src/fbearmodel.c:335-339
            prev = dist_s[i] + C.SLOPE_FILTER_A * (prev - dist_s[i])
        else:
            prev = prev + C.SLOPE_FILTER_A * (dist_s[i] - prev)
        cu[i] = prev
    # upper spreading: A_up[j] = fb[j] + sum_{i<j} fb[i] cu[i]^(j-i)
    Z = C.FB_BAND_COUNT
    ii = np.arange(Z)
    expo = ii[None, :] - ii[:, None]  # [i, j] -> j - i
    with np.errstate(invalid="ignore"):
        M = np.where(expo > 0, cu[:, :, None] ** np.maximum(expo, 1)[None], 0.0)
    M = M + np.eye(Z)[None]
    a_re = np.einsum("ti,tij->tj", fb_re, M)
    a_im = np.einsum("ti,tij->tj", fb_im, M)
    # constant lower spreading: final[k] = sum_{j>=k} CL^(j-k) A_up[j]
    L = np.where(expo <= 0, C.CL ** np.maximum(-expo, 0), 0.0)  # [j->row? ]
    # L[i, j] with i=source row j=dest col: contribution of A_up[i] to
    # final[j] is CL^(i-j) for i >= j  <=>  expo = j - i <= 0
    a_re = a_re @ L
    a_im = a_im @ L
    e0 = a_re ** 2 + a_im ** 2  # [I, 40]
    # backward-masking FIR sampled at each frame's last instant;
    # src/fbearmodel.c:371-383.  E1[f] = sum_i h[i] * E0[6f+5-i]
    inst_per_frame = C.FB_FRAMESIZE // sub
    e0_padded = np.concatenate([np.zeros((10, Z)), e0], axis=0)
    last = inst_per_frame * np.arange(frames) + (inst_per_frame - 1)
    e1 = np.zeros((frames, Z))
    for i in range(11):
        e1 += p.back_mask[i] * e0_padded[last + 10 - i]
    unsmeared = e1 + p.internal_noise
    # forward masking IIR over frames; src/fbearmodel.c:388-395
    a = p.ear_time_constants
    excitation = np.empty_like(unsmeared)
    exc = np.zeros(Z)
    for f in range(frames):
        exc = a * exc + (1.0 - a) * unsmeared[f]
        excitation[f] = exc
    return excitation, unsmeared


# ---------------------------------------------------------------------------
# Level adapter (src/leveladapter.c:242-340)
# ---------------------------------------------------------------------------


class LevelAdapterState:
    def __init__(self, band_count: int, adapt_time_constants: np.ndarray):
        self.a = adapt_time_constants
        self.band_count = band_count
        self.ref_filtered = np.zeros(band_count)
        self.test_filtered = np.zeros(band_count)
        self.filtered_num = np.zeros(band_count)
        self.filtered_den = np.zeros(band_count)
        self.pattcorr_ref = np.zeros(band_count)
        self.pattcorr_test = np.zeros(band_count)
        self.adapted_ref = np.zeros(band_count)
        self.adapted_test = np.zeros(band_count)

    def process(self, ref_excitation: np.ndarray,
                test_excitation: np.ndarray) -> None:
        a = self.a
        bc = self.band_count
        self.ref_filtered = a * self.ref_filtered + (1 - a) * ref_excitation
        self.test_filtered = a * self.test_filtered + (1 - a) * test_excitation
        num = float(np.sum(np.sqrt(self.ref_filtered * self.test_filtered)))
        den = float(np.sum(self.test_filtered))
        lev_corr = num * num / (den * den)
        if lev_corr > 1:
            levcorr_ref = ref_excitation / lev_corr
            levcorr_test = test_excitation
        else:
            levcorr_ref = ref_excitation
            levcorr_test = test_excitation * lev_corr
        # note: no (1-a) factor on the input terms; src/leveladapter.c:291-298
        self.filtered_num = a * self.filtered_num + levcorr_test * levcorr_ref
        self.filtered_den = a * self.filtered_den + levcorr_ref * levcorr_ref
        pattadapt_ref = np.where(self.filtered_num >= self.filtered_den,
                                 1.0, self.filtered_num / self.filtered_den)
        pattadapt_test = np.where(self.filtered_num >= self.filtered_den,
                                  self.filtered_den / self.filtered_num, 1.0)
        m1_const = bc // 36
        m2_const = bc // 25
        ra_ref = np.empty(bc)
        ra_test = np.empty(bc)
        for k in range(bc):
            m1 = min(k, m1_const)
            m2 = min(bc - k - 1, m2_const)
            sl = slice(k - m1, k + m2 + 1)
            ra_ref[k] = pattadapt_ref[sl].sum() / (m1 + m2 + 1)
            ra_test[k] = pattadapt_test[sl].sum() / (m1 + m2 + 1)
        self.pattcorr_ref = a * self.pattcorr_ref + (1 - a) * ra_ref
        self.pattcorr_test = a * self.pattcorr_test + (1 - a) * ra_test
        self.adapted_ref = levcorr_ref * self.pattcorr_ref
        self.adapted_test = levcorr_test * self.pattcorr_test


# ---------------------------------------------------------------------------
# Modulation processor (src/modpatt.c:222-251)
# ---------------------------------------------------------------------------


class ModulationState:
    def __init__(self, band_count: int, adapt_time_constants: np.ndarray,
                 step_size: int):
        self.a = adapt_time_constants
        self.derivative_factor = C.SAMPLING_RATE / step_size
        self.previous_loudness = np.zeros(band_count)
        self.filtered_loudness = np.zeros(band_count)
        self.filtered_derivative = np.zeros(band_count)
        self.modulation = np.zeros(band_count)

    def process(self, unsmeared_excitation: np.ndarray) -> None:
        a = self.a
        loudness = unsmeared_excitation ** 0.3
        deriv = self.derivative_factor * np.abs(
            loudness - self.previous_loudness)
        self.filtered_derivative = (a * self.filtered_derivative
                                    + (1 - a) * deriv)
        self.filtered_loudness = a * self.filtered_loudness + (1 - a) * loudness
        self.modulation = self.filtered_derivative / (
            1.0 + self.filtered_loudness / 0.3)
        self.previous_loudness = loudness


# ---------------------------------------------------------------------------
# MOV accumulators (src/movaccum.c)
# ---------------------------------------------------------------------------

MODE_AVG = "avg"
MODE_AVG_LOG = "avg_log"
MODE_RMS = "rms"
MODE_RMS_ASYM = "rms_asym"
MODE_AVG_WINDOW = "avg_window"
MODE_ADB = "adb"
MODE_FILTERED_MAX = "filtered_max"


class MovAccum:
    """Streaming accumulator with INIT/tentative semantics;
    src/movaccum.c:257-481."""

    def __init__(self, mode: str, channels: int):
        self.mode = mode
        self.channels = channels
        self.status = "init"
        self.num = np.zeros(channels)
        self.num2 = np.zeros(channels)
        self.den = np.zeros(channels)
        self.past_sqrts = np.full((channels, 3), np.nan)
        self.filt_state = np.zeros(channels)
        self.max = np.zeros(channels)
        self.saved = None

    def _snapshot(self):
        return (self.num.copy(), self.num2.copy(), self.den.copy(),
                self.max.copy())

    def set_tentative(self, tentative: bool) -> None:
        if tentative:
            if self.status == "normal":
                self.saved = self._snapshot()
                self.status = "tentative"
        else:
            self.status = "normal"

    def accumulate(self, c: int, val: float, weight: float = 1.0) -> None:
        if self.status == "init":
            return
        if self.mode == MODE_RMS:
            w2 = weight * weight
            self.num[c] += w2 * val * val
            self.den[c] += w2
        elif self.mode == MODE_RMS_ASYM:
            self.num[c] += val * val
            self.num2[c] += weight * weight
            self.den[c] += 1.0
        elif self.mode in (MODE_AVG, MODE_AVG_LOG, MODE_ADB):
            self.num[c] += weight * val
            self.den[c] += weight
        elif self.mode == MODE_AVG_WINDOW:
            val_sqrt = math.sqrt(val)
            if not math.isnan(self.past_sqrts[c, 0]):
                winsum = (val_sqrt + self.past_sqrts[c].sum()) / 4.0
                self.num[c] += winsum ** 4
                self.den[c] += 1.0
            self.past_sqrts[c, :2] = self.past_sqrts[c, 1:]
            self.past_sqrts[c, 2] = val_sqrt
        elif self.mode == MODE_FILTERED_MAX:
            self.filt_state[c] = 0.9 * self.filt_state[c] + 0.1 * val
            if self.filt_state[c] > self.max[c]:
                self.max[c] = self.filt_state[c]
        else:
            raise ValueError(self.mode)

    def get_value(self) -> float:
        if self.status == "tentative" and self.saved is not None:
            num, num2, den, mx = self.saved
        else:
            num, num2, den, mx = self.num, self.num2, self.den, self.max
        value = 0.0
        for c in range(self.channels):
            if self.mode == MODE_AVG:
                value += num[c] / den[c]
            elif self.mode == MODE_AVG_LOG:
                value += 10.0 * math.log10(num[c] / den[c])
            elif self.mode in (MODE_AVG_WINDOW, MODE_RMS):
                value += math.sqrt(num[c] / den[c])
            elif self.mode == MODE_RMS_ASYM:
                value += math.sqrt(num[c] / den[c])
                value += 0.5 * math.sqrt(num2[c] / den[c])
            elif self.mode == MODE_FILTERED_MAX:
                value += mx[c]
            elif self.mode == MODE_ADB:
                if den[c] > 0:
                    value += (-0.5 if num[c] == 0.0
                              else math.log10(num[c] / den[c]))
        return value / self.channels


# ---------------------------------------------------------------------------
# Per-frame MOV functions (src/movs.c)
# ---------------------------------------------------------------------------


def mov_modulation_difference(p, ref_mod: list, test_mod: list,
                              acc1: MovAccum, acc2, acc_win) -> None:
    """src/movs.c:204-254."""
    lev_wt = 100.0 if acc2 is not None else 1.0
    bc = p.band_count
    for c in range(acc1.channels):
        mr = ref_mod[c].modulation
        mt = test_mod[c].modulation
        avg_loud = ref_mod[c].filtered_loudness
        diff = np.abs(mr - mt)
        mod_diff_1b = float(np.sum(diff / (1.0 + mr)))
        w = np.where(mt >= mr, 1.0, 0.1)
        mod_diff_2b = float(np.sum(w * diff / (0.01 + mr)))
        temp_wt = float(np.sum(
            avg_loud / (avg_loud + lev_wt * p.internal_noise ** 0.3)))
        if acc1.mode == MODE_RMS:
            mod_diff_1b *= 100.0 / math.sqrt(bc)
        else:
            mod_diff_1b *= 100.0 / bc
        mod_diff_2b *= 100.0 / bc
        acc1.accumulate(c, mod_diff_1b, temp_wt)
        if acc2 is not None:
            acc2.accumulate(c, mod_diff_2b, temp_wt)
        if acc_win is not None:
            acc_win.accumulate(c, mod_diff_1b, 1.0)


def calc_noise_loudness(p, alpha, thres_fac, s0, nl_min,
                        ref_modulation, test_modulation,
                        ref_excitation, test_excitation) -> float:
    """(66)-(68) of BS.1387; src/movs.c:708-743."""
    sref = thres_fac * ref_modulation + s0
    stest = thres_fac * test_modulation + s0
    ethres = p.internal_noise
    beta = np.exp(-alpha * (test_excitation - ref_excitation) / ref_excitation)
    nl = np.sum((ethres / stest) ** 0.23 * (
        (1.0 + np.maximum(stest * test_excitation - sref * ref_excitation, 0.0)
         / (ethres + sref * ref_excitation * beta)) ** 0.23 - 1.0))
    nl *= 24.0 / p.band_count
    return 0.0 if nl < nl_min else float(nl)


def mov_noise_loudness(p, ref_mod, test_mod, level, acc: MovAccum) -> None:
    """RmsNoiseLoudB; src/movs.c:353-371."""
    for c in range(acc.channels):
        nl = calc_noise_loudness(
            p, 1.5, 0.15, 0.5, 0.0, ref_mod[c].modulation,
            test_mod[c].modulation, level[c].adapted_ref, level[c].adapted_test)
        acc.accumulate(c, nl, 1.0)


def mov_noise_loud_asym(p, ref_mod, test_mod, level, acc: MovAccum,
                        settings: C.Settings) -> None:
    """RmsNoiseLoudAsymA; src/movs.c:550-577."""
    for c in range(acc.channels):
        nl = calc_noise_loudness(
            p, 2.5, 0.3, 1.0, 0.1, ref_mod[c].modulation,
            test_mod[c].modulation, level[c].adapted_ref, level[c].adapted_test)
        if settings.swap_mod_patts_for_noise_loudness_movs:
            mc = calc_noise_loudness(
                p, 1.5, 0.15, 1.0, 0.0, test_mod[c].modulation,
                ref_mod[c].modulation, level[c].adapted_test,
                level[c].adapted_ref)
        else:
            mc = calc_noise_loudness(
                p, 1.5, 0.15, 1.0, 0.0, ref_mod[c].modulation,
                test_mod[c].modulation, level[c].adapted_test,
                level[c].adapted_ref)
        acc.accumulate(c, nl, mc)


def mov_lin_dist(p, ref_mod, test_mod, level, ref_excitations,
                 acc: MovAccum, settings: C.Settings) -> None:
    """AvgLinDistA; src/movs.c:678-706."""
    for c in range(acc.channels):
        if settings.swap_mod_patts_for_noise_loudness_movs:
            test_m = ref_mod[c].modulation
        else:
            test_m = test_mod[c].modulation
        nl = calc_noise_loudness(
            p, 1.5, 0.15, 1.0, 0.0, ref_mod[c].modulation, test_m,
            level[c].adapted_ref, ref_excitations[c])
        acc.accumulate(c, nl, 1.0)


def mov_bandwidth(ref_power_spectra, test_power_spectra,
                  acc_ref: MovAccum, acc_test: MovAccum) -> None:
    """BandwidthRefB/TestB; src/movs.c:775-809."""
    for c in range(acc_ref.channels):
        rp = ref_power_spectra[c]
        tp = test_power_spectra[c]
        zero_threshold = tp[921:1024].max()
        bw_ref = 0
        for i in range(921, 0, -1):
            if rp[i - 1] > 10.0 * zero_threshold:
                bw_ref = i
                break
        if bw_ref > 346:
            bw_test = 0
            for i in range(bw_ref, 0, -1):
                if tp[i - 1] >= C.FIVE_DB_POWER_FACTOR * zero_threshold:
                    bw_test = i
                    break
            acc_ref.accumulate(c, float(bw_ref), 1.0)
            acc_test.accumulate(c, float(bw_test), 1.0)


def mov_nmr(p, ref_states, test_states, acc_nmr: MovAccum,
            acc_rel_dist) -> None:
    """Total/Segmental NMRB + RelDistFramesB; src/movs.c:970-1023."""
    for c in range(acc_nmr.channels):
        rw = ref_states[c].weighted_power_spectrum
        tw = test_states[c].weighted_power_spectrum
        noise_spectrum = rw - 2.0 * np.sqrt(rw * tw) + tw
        noise_in_bands = group_into_bands(p, noise_spectrum)
        mask = ref_states[c].excitation / p.masking_difference
        nmr_vec = noise_in_bands / mask
        nmr = float(np.mean(nmr_vec))
        nmr_max = float(np.max(np.concatenate(([0.0], nmr_vec))))
        if acc_nmr.mode == MODE_AVG_LOG:
            acc_nmr.accumulate(c, nmr, 1.0)
        else:
            acc_nmr.accumulate(c, 10.0 * math.log10(nmr), 1.0)
        if acc_rel_dist is not None:
            acc_rel_dist.accumulate(
                c, 1.0 if nmr_max > C.ONE_POINT_FIVE_DB_POWER_FACTOR else 0.0,
                1.0)


def mov_prob_detect(p, ref_excitations, test_excitations, channels,
                    acc_adb: MovAccum, acc_mfpd: MovAccum,
                    settings: C.Settings) -> None:
    """ADBB + MFPDB; src/movs.c:1223-1276."""
    bc = p.band_count
    binaural_p = 1.0
    binaural_steps = 0.0
    for i in range(bc):
        det_p = 0.0
        det_steps = 0.0
        for c in range(channels):
            eref_db = 10.0 * math.log10(ref_excitations[c][i])
            etest_db = 10.0 * math.log10(test_excitations[c][i])
            l = 0.3 * max(eref_db, etest_db) + 0.7 * etest_db
            cs = C.PD_S_COEFFS
            if l > 0:
                s = (cs[0] * (cs[1] / l) ** cs[2] + cs[3] * l ** 4
                     + cs[4] * l ** 3 - cs[5] * l * l + cs[6] * l - cs[7])
            else:
                s = 1e30
            e = eref_db - etest_db
            b = 4.0 if eref_db > etest_db else 6.0
            pc = 1.0 - 0.5 ** ((e / s) ** b)
            if settings.use_floor_for_steps_above_threshold:
                qc = abs(math.floor(e)) / s
            else:
                qc = abs(math.trunc(e)) / s
            if pc > det_p:
                det_p = pc
            if c == 0 or qc > det_steps:
                det_steps = qc
        binaural_p *= 1.0 - det_p
        binaural_steps += det_steps
    binaural_p = 1.0 - binaural_p
    if binaural_p > 0.5:
        acc_adb.accumulate(0, binaural_steps, 1.0)
    acc_mfpd.accumulate(0, binaural_p, 1.0)


def _ehs_xcorr(d: np.ndarray) -> np.ndarray:
    """c[i] = sum_{k<256} d[k] d[k+i]; src/movs.c:1278-1315."""
    n = C.MAXLAG
    f1 = np.fft.rfft(d[:2 * n])
    d2 = np.concatenate([d[:n], np.zeros(n)])
    f2 = np.fft.rfft(d2)
    return np.fft.irfft(f1 * np.conj(f2))[:n]


def mov_ehs(ref_states, test_states, acc: MovAccum,
            settings: C.Settings) -> None:
    """EHSB; src/movs.c:1345-1443."""
    channels = acc.channels
    ehs_valid = any(ref_states[c].energy_threshold_reached
                    or test_states[c].energy_threshold_reached
                    for c in range(channels))
    if not ehs_valid:
        return
    window = EP.ehs_correlation_window(settings.center_ehs_correlation_window)
    n = C.MAXLAG
    for c in range(channels):
        rw = ref_states[c].weighted_power_spectrum
        tw = test_states[c].weighted_power_spectrum
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where((rw[:2 * n] == 0) & (tw[:2 * n] == 0), 0.0,
                         np.log(tw[:2 * n] / rw[:2 * n]))
        corr = _ehs_xcorr(d)
        d0 = corr[0]
        # dk[i] = sum_{k=i}^{i+255} d[k]^2
        dsq = d ** 2
        dk = d0 + np.concatenate(
            ([0.0], np.cumsum(dsq[n:2 * n] - dsq[:n])[:-1]))
        with np.errstate(divide="ignore", invalid="ignore"):
            cnorm = corr / np.sqrt(d0 * dk)
        if settings.ehs_subtract_dc_before_window:
            cwin = (cnorm - np.mean(cnorm)) * window
        else:
            cwin = cnorm * window
        cfft = np.fft.rfft(cwin)
        power = cfft.real ** 2 + cfft.imag ** 2
        if not settings.ehs_subtract_dc_before_window:
            power[0] = 0.0
        # max over bins that exceed their predecessor; src/movs.c:1434-1440
        ehs = 0.0
        s = power[0]
        for i in range(1, n // 2 + 1):
            if power[i] > s and power[i] > ehs:
                ehs = power[i]
            s = power[i]
        acc.accumulate(c, 1000.0 * ehs, 1.0)


# ---------------------------------------------------------------------------
# Neural network (src/nn.c)
# ---------------------------------------------------------------------------


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def calculate_di_basic(movs: np.ndarray, clamp: bool = False) -> float:
    """src/nn.c:186-216."""
    m = (np.asarray(movs) - C.NN_AMIN_BASIC) / (C.NN_AMAX_BASIC - C.NN_AMIN_BASIC)
    if clamp:
        m = np.clip(m, 0.0, 1.0)
    x = C.NN_WXB_BASIC + m @ C.NN_WX_BASIC
    return float(C.NN_WYB_BASIC + np.sum(C.NN_WY_BASIC * _sigmoid(x)))


def calculate_di_advanced(movs: np.ndarray, clamp: bool = False) -> float:
    """src/nn.c:303-335."""
    m = ((np.asarray(movs) - C.NN_AMIN_ADVANCED)
         / (C.NN_AMAX_ADVANCED - C.NN_AMIN_ADVANCED))
    if clamp:
        m = np.clip(m, 0.0, 1.0)
    x = C.NN_WXB_ADVANCED + m @ C.NN_WX_ADVANCED
    return float(C.NN_WYB_ADVANCED + np.sum(C.NN_WY_ADVANCED * _sigmoid(x)))


def calculate_odg(di: float) -> float:
    """src/nn.c:371-375."""
    return C.NN_BMIN + (C.NN_BMAX - C.NN_BMIN) / (1.0 + math.exp(-di))


# ---------------------------------------------------------------------------
# Frame-level orchestration (src/gstpeaq.c)
# ---------------------------------------------------------------------------


def is_frame_above_threshold(frame: np.ndarray) -> bool:
    """5-sample sliding |x| sum test; src/gstpeaq.c:1080-1099.

    frame is [frame_size, channels].  The reference checks the running sum of
    windows [i-4..i] for i >= 5 (accumulated in float32); we evaluate exact
    sliding sums in float64 — identical decisions except for borderline cases
    below 1e-4 relative of the threshold.
    """
    data = np.abs(np.asarray(frame, dtype=np.float64))
    if data.ndim == 1:
        data = data[:, None]
    cs = np.cumsum(data, axis=0)
    wsum = cs[5:] - cs[:-5]
    return bool((wsum >= C.FRAME_THRESHOLD).any())


@dataclasses.dataclass
class PeaqResult:
    odg: float
    di: float
    movs: dict


def peaq_basic(ref: np.ndarray, test: np.ndarray,
               playback_level: float = 92.0,
               settings: C.Settings = C.DEFAULT_SETTINGS) -> PeaqResult:
    """Full basic-version PEAQ; orchestration per src/gstpeaq.c:849-921.

    ref/test: float32 arrays [samples, channels] at 48 kHz.
    """
    if ref.ndim == 1:
        ref = ref[:, None]
    if test.ndim == 1:
        test = test[:, None]
    channels = ref.shape[1]
    p = EP.fft_ear_params(C.BASIC_BAND_COUNT, playback_level)
    ref_frames = _frames_pair(ref, test, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)

    ref_states = [FFTEarState(p.band_count) for _ in range(channels)]
    test_states = [FFTEarState(p.band_count) for _ in range(channels)]
    level = [LevelAdapterState(p.band_count, p.adapt_time_constants)
             for _ in range(channels)]
    ref_mod = [ModulationState(p.band_count, p.adapt_time_constants,
                               C.FFT_STEPSIZE) for _ in range(channels)]
    test_mod = [ModulationState(p.band_count, p.adapt_time_constants,
                                C.FFT_STEPSIZE) for _ in range(channels)]

    acc = {
        "BandwidthRefB": MovAccum(MODE_AVG, channels),
        "BandwidthTestB": MovAccum(MODE_AVG, channels),
        "TotalNMRB": MovAccum(MODE_AVG_LOG, channels),
        "WinModDiff1B": MovAccum(MODE_AVG_WINDOW, channels),
        "ADBB": MovAccum(MODE_ADB, 1),
        "EHSB": MovAccum(MODE_AVG, channels),
        "AvgModDiff1B": MovAccum(MODE_AVG, channels),
        "AvgModDiff2B": MovAccum(MODE_AVG, channels),
        "RmsNoiseLoudB": MovAccum(MODE_RMS, channels),
        "MFPDB": MovAccum(MODE_FILTERED_MAX, 1),
        "RelDistFramesB": MovAccum(MODE_AVG, channels),
    }

    loudness_reached = None
    for frame_counter, (rf, tf) in enumerate(ref_frames):
        above = is_frame_above_threshold(rf)
        for a in acc.values():
            a.set_tentative(not above)
        for c in range(channels):
            fft_ear_process_block(p, ref_states[c], rf[:, c])
            fft_ear_process_block(p, test_states[c], tf[:, c])
            level[c].process(ref_states[c].excitation,
                             test_states[c].excitation)
            ref_mod[c].process(ref_states[c].unsmeared_excitation)
            test_mod[c].process(test_states[c].unsmeared_excitation)
            if loudness_reached is None:
                if (calc_loudness(p, ref_states[c].excitation) > 0.1
                        and calc_loudness(p, test_states[c].excitation) > 0.1):
                    loudness_reached = frame_counter
        if frame_counter >= 24:
            mov_modulation_difference(
                p, ref_mod, test_mod, acc["AvgModDiff1B"],
                acc["AvgModDiff2B"], acc["WinModDiff1B"])
        if (frame_counter >= 24 and loudness_reached is not None
                and frame_counter - 3 >= loudness_reached):
            mov_noise_loudness(p, ref_mod, test_mod, level,
                               acc["RmsNoiseLoudB"])
        mov_bandwidth([s.power_spectrum for s in ref_states],
                      [s.power_spectrum for s in test_states],
                      acc["BandwidthRefB"], acc["BandwidthTestB"])
        mov_nmr(p, ref_states, test_states, acc["TotalNMRB"],
                acc["RelDistFramesB"])
        mov_prob_detect(p, [s.excitation for s in ref_states],
                        [s.excitation for s in test_states], channels,
                        acc["ADBB"], acc["MFPDB"], settings)
        mov_ehs(ref_states, test_states, acc["EHSB"], settings)

    movs = {name: acc[name].get_value() for name in C.MOV_BASIC_NAMES}
    di = calculate_di_basic(
        np.array([movs[n] for n in C.MOV_BASIC_NAMES]), settings.clamp_movs)
    return PeaqResult(odg=calculate_odg(di), di=di, movs=movs)


def _frames_pair(ref: np.ndarray, test: np.ndarray, frame_size: int,
                 step_size: int):
    """Paired framing matching the GstAdapter drain semantics: full frames
    while *both* signals have one, then a single zero-padded flush frame if
    either has leftover (src/gstpeaq.c:596-611,715-745)."""
    n = min(ref.shape[0], test.shape[0])
    offset = 0
    out = []
    while offset + frame_size <= n:
        out.append((ref[offset:offset + frame_size],
                    test[offset:offset + frame_size]))
        offset += step_size
    if ref.shape[0] - offset > 0 or test.shape[0] - offset > 0:
        def pad(sig):
            frame = np.zeros((frame_size, sig.shape[1]), dtype=sig.dtype)
            remain = sig[offset:offset + frame_size]
            frame[:remain.shape[0]] = remain
            return frame
        out.append((pad(ref), pad(test)))
    return out


def peaq_advanced(ref: np.ndarray, test: np.ndarray,
                  playback_level: float = 92.0,
                  settings: C.Settings = C.DEFAULT_SETTINGS) -> PeaqResult:
    """Full advanced-version PEAQ; orchestration per src/gstpeaq.c:923-1010."""
    if ref.ndim == 1:
        ref = ref[:, None]
    if test.ndim == 1:
        test = test[:, None]
    channels = ref.shape[1]
    pf = EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT, playback_level)
    pb = fb = EP.fb_ear_params(playback_level)

    acc = {
        "RmsModDiffA": MovAccum(MODE_RMS, channels),
        "RmsNoiseLoudAsymA": MovAccum(MODE_RMS_ASYM, channels),
        "SegmentalNMRB": MovAccum(MODE_AVG, channels),
        "EHSB": MovAccum(MODE_AVG, channels),
        "AvgLinDistA": MovAccum(MODE_AVG, channels),
    }

    # FFT path: NMR + EHS only
    ref_states = [FFTEarState(pf.band_count) for _ in range(channels)]
    test_states = [FFTEarState(pf.band_count) for _ in range(channels)]
    for rf, tf in _frames_pair(ref, test, C.FFT_FRAMESIZE, C.FFT_STEPSIZE):
        above = is_frame_above_threshold(rf)
        acc["SegmentalNMRB"].set_tentative(not above)
        acc["EHSB"].set_tentative(not above)
        for c in range(channels):
            fft_ear_process_block(pf, ref_states[c], rf[:, c])
            fft_ear_process_block(pf, test_states[c], tf[:, c])
        mov_nmr(pf, ref_states, test_states, acc["SegmentalNMRB"], None)
        mov_ehs(ref_states, test_states, acc["EHSB"], settings)

    # Filter-bank path: modulation/noise-loudness MOVs
    fb_frames = _frames_pair(ref, test, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    ref_sig = np.concatenate([rf for rf, _ in fb_frames], axis=0)
    test_sig = np.concatenate([tf for _, tf in fb_frames], axis=0)
    swap = settings.swap_slope_filter_coefficients
    ref_exc = [fb_process_signal(fb, ref_sig[:, c], swap_slope=swap)
               for c in range(channels)]
    test_exc = [fb_process_signal(fb, test_sig[:, c], swap_slope=swap)
                for c in range(channels)]

    class _ExcView:
        """Adapts precomputed per-frame excitations to the stateful API."""

        def __init__(self):
            self.excitation = None
            self.unsmeared_excitation = None

    fb_ref = [_ExcView() for _ in range(channels)]
    fb_test = [_ExcView() for _ in range(channels)]
    level = [LevelAdapterState(fb.band_count, fb.adapt_time_constants)
             for _ in range(channels)]
    ref_mod = [ModulationState(fb.band_count, fb.adapt_time_constants,
                               C.FB_FRAMESIZE) for _ in range(channels)]
    test_mod = [ModulationState(fb.band_count, fb.adapt_time_constants,
                                C.FB_FRAMESIZE) for _ in range(channels)]
    loudness_reached = None
    for frame_counter, (rf, tf) in enumerate(fb_frames):
        above = is_frame_above_threshold(rf)
        for name in ("RmsModDiffA", "RmsNoiseLoudAsymA", "AvgLinDistA"):
            acc[name].set_tentative(not above)
        for c in range(channels):
            fb_ref[c].excitation = ref_exc[c][0][frame_counter]
            fb_ref[c].unsmeared_excitation = ref_exc[c][1][frame_counter]
            fb_test[c].excitation = test_exc[c][0][frame_counter]
            fb_test[c].unsmeared_excitation = test_exc[c][1][frame_counter]
            level[c].process(fb_ref[c].excitation, fb_test[c].excitation)
            ref_mod[c].process(fb_ref[c].unsmeared_excitation)
            test_mod[c].process(fb_test[c].unsmeared_excitation)
            if loudness_reached is None:
                if (calc_loudness(fb, fb_ref[c].excitation) > 0.1
                        and calc_loudness(fb, fb_test[c].excitation) > 0.1):
                    loudness_reached = frame_counter
        if frame_counter >= 125:
            mov_modulation_difference(pb, ref_mod, test_mod,
                                      acc["RmsModDiffA"], None, None)
        if (frame_counter >= 125 and loudness_reached is not None
                and frame_counter - 13 >= loudness_reached):
            mov_noise_loud_asym(pb, ref_mod, test_mod, level,
                                acc["RmsNoiseLoudAsymA"], settings)
            mov_lin_dist(pb, ref_mod, test_mod, level,
                         [s.excitation for s in fb_ref],
                         acc["AvgLinDistA"], settings)

    movs = {name: acc[name].get_value() for name in C.MOV_ADVANCED_NAMES}
    di = calculate_di_advanced(
        np.array([movs[n] for n in C.MOV_ADVANCED_NAMES]), settings.clamp_movs)
    return PeaqResult(odg=calculate_odg(di), di=di, movs=movs)
