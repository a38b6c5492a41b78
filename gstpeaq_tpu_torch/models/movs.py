"""Model output variables of the basic version per frame (src/movs.c).

Band quantities come in the [..., Z, F] layout (bands second to last);
spectra in [CH, F, bins].  The masked accumulation over frames lives in
accum.py.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C
from ..ops import exact


def modulation_difference(internal_noise: torch.Tensor,
                          mod_ref: torch.Tensor, mod_test: torch.Tensor,
                          avg_loud_ref: torch.Tensor, rms_mode: bool,
                          lev_wt: float):
    """ModDiff1/ModDiff2/TempWt per frame; src/movs.c:204-254.
    Returns (mod_diff_1, mod_diff_2, temp_wt), each [..., F]."""
    band_count = mod_ref.shape[-2]
    diff = torch.abs(mod_ref - mod_test)
    md1 = torch.sum(diff / (1.0 + mod_ref), dim=-2)
    w = torch.full_like(diff, 0.1).masked_fill_(mod_test >= mod_ref, 1.0)
    md2 = torch.sum(w * diff / (0.01 + mod_ref), dim=-2)
    temp_wt = torch.sum(
        avg_loud_ref
        / (avg_loud_ref + (lev_wt * internal_noise ** 0.3)[:, None]), dim=-2)
    if rms_mode:
        md1 = md1 * (100.0 / math.sqrt(band_count))
    else:
        md1 = md1 * (100.0 / band_count)
    md2 = md2 * (100.0 / band_count)
    return md1, md2, temp_wt


def noise_loudness(internal_noise: torch.Tensor, alpha: float,
                   thres_fac: float, s0: float, nl_min: float,
                   mod_ref: torch.Tensor, mod_test: torch.Tensor,
                   e_ref: torch.Tensor, e_test: torch.Tensor) -> torch.Tensor:
    """Noise loudness, (66)-(68) of BS.1387; src/movs.c:708-743.
    Band inputs [..., Z, F] -> [..., F]."""
    band_count = mod_ref.shape[-2]
    noise = internal_noise[:, None]
    sref = thres_fac * mod_ref + s0
    stest = thres_fac * mod_test + s0
    beta = exact.exp(-alpha * (e_test - e_ref) / e_ref)
    nl = torch.sum(
        (noise / stest) ** 0.23
        * ((1.0 + torch.clamp_min(stest * e_test - sref * e_ref, 0.0)
            / (noise + sref * e_ref * beta)) ** 0.23 - 1.0),
        dim=-2) * (24.0 / band_count)
    return torch.where(nl < nl_min, 0.0, nl)


def bandwidth(ref_power: torch.Tensor, test_power: torch.Tensor):
    """BandwidthRef/TestB per frame; src/movs.c:775-809.

    ref/test_power: [..., 1025] in natural bin order.  Returns
    (bw_ref, bw_test, valid) with valid = bw_ref > 346."""
    dtype = ref_power.dtype
    zt = torch.amax(test_power[..., 921:1024], dim=-1, keepdim=True)
    idx = torch.arange(921, device=ref_power.device)
    # largest i in [1, 921] with ref_power[i-1] > 10*zt, else 0
    mask_ref = ref_power[..., :921] > 10.0 * zt
    bw_ref = torch.amax(torch.where(mask_ref, idx + 1, 0), dim=-1)
    # largest i <= bw_ref with test_power[i-1] >= 5dB*zt, else 0
    mask_test = test_power[..., :921] >= C.FIVE_DB_POWER_FACTOR * zt
    below = idx < bw_ref[..., None]
    bw_test = torch.amax(torch.where(mask_test & below, idx + 1, 0), dim=-1)
    return bw_ref.to(dtype), bw_test.to(dtype), bw_ref > 346


def nmr_noise_bands(group_matrix: torch.Tensor, ref_power: torch.Tensor,
                    test_power: torch.Tensor, delta_power: torch.Tensor):
    """NMR's noise per band, the bin-domain half of nmr (src/movs.c:
    970-1023).  ref/test_power and delta_power (the exactly cancelled
    pr - pt of fft_ear): [..., hi] over the grouping-supported bins;
    group_matrix: [hi, Z] with the ear weight folded in.  The noise
    spectrum evaluates as ((pr - pt) / (sqrt(pr) + sqrt(pt)))^2,
    algebraically (sqrt(pr) - sqrt(pt))^2 without its cancellation.
    Returns [..., Z] with the 1e-12 floor."""
    denom = exact.sqrt(ref_power) + exact.sqrt(test_power)
    ratio = delta_power / torch.where(denom > 0.0, denom, 1.0)
    return torch.clamp_min(exact.band_sum(ratio * ratio, group_matrix),
                           1e-12)


def nmr_from_bands(masking_difference: torch.Tensor,
                   noise_in_bands: torch.Tensor,
                   ref_excitation: torch.Tensor):
    """NMR per frame and the disturbed-frame flag from the noise per band
    (nmr_noise_bands) and ref_excitation [..., Z], the band-domain half of
    nmr.  Returns (nmr_mean, disturbed in {0, 1})."""
    nmr_vec = noise_in_bands / (ref_excitation / masking_difference)
    nmr_mean = torch.mean(nmr_vec, dim=-1)
    nmr_max = torch.amax(nmr_vec, dim=-1)
    disturbed = (nmr_max > C.ONE_POINT_FIVE_DB_POWER_FACTOR).to(nmr_mean.dtype)
    return nmr_mean, disturbed


def nmr(group_matrix: torch.Tensor, masking_difference: torch.Tensor,
        ref_power: torch.Tensor, test_power: torch.Tensor,
        ref_excitation: torch.Tensor, delta_power: torch.Tensor):
    """NMR per frame and the disturbed-frame flag; src/movs.c:970-1023:
    nmr_noise_bands, then nmr_from_bands.  Returns (nmr_mean, disturbed in
    {0, 1})."""
    return nmr_from_bands(
        masking_difference,
        nmr_noise_bands(group_matrix, ref_power, test_power, delta_power),
        ref_excitation)


def prob_detect(e_ref: torch.Tensor, e_test: torch.Tensor,
                use_floor: bool = False):
    """Binaural detection probability and steps per frame;
    src/movs.c:1223-1276.

    e_ref/e_test: [..., CH, Z, F].  Returns (p_bin, steps_bin), each
    [..., F]."""
    eref_db = 10.0 * exact.log10(e_ref)
    etest_db = 10.0 * exact.log10(e_test)
    l = 0.3 * torch.maximum(eref_db, etest_db) + 0.7 * etest_db
    cs = C.PD_S_COEFFS
    l_safe = torch.where(l > 0.0, l, 1.0)
    s = torch.where(
        l > 0.0,
        cs[0] * (cs[1] / l_safe) ** cs[2] + cs[3] * l_safe ** 4
        + cs[4] * l_safe ** 3 - cs[5] * l_safe * l_safe + cs[6] * l_safe
        - cs[7],
        1e30)
    e = eref_db - etest_db
    # (e/s)^b with b in {4, 6} as explicit even powers: a generic pow with a
    # data-dependent exponent is undefined for the negative bases that occur
    # whenever the test is louder (src/movs.c:1240)
    t = e / s
    t2 = t * t
    t4 = t2 * t2
    tb = torch.where(eref_db > etest_db, t4, t4 * t2)
    pc = 1.0 - 0.5 ** tb
    int_e = torch.floor(e) if use_floor else torch.trunc(e)
    qc = torch.abs(int_e) / s
    p_band = torch.amax(pc, dim=-3)         # max over channels
    q_band = torch.amax(qc, dim=-3)
    p_bin = 1.0 - torch.prod(1.0 - p_band, dim=-2)
    steps_bin = torch.sum(q_band, dim=-2)
    return p_bin, steps_bin


def ehs_log_difference(ref_power: torch.Tensor, test_power: torch.Tensor,
                       delta_power: torch.Tensor,
                       ehs_zero: torch.Tensor) -> torch.Tensor:
    """EHS's log-spectral difference d = log(pt / pr) over the first 512
    bins, the bin-domain half of ehs (src/movs.c:1345-1443).

    ref/test_power: [..., >=512] plain power spectra; delta_power: the
    exactly cancelled pr - pt; ehs_zero: [512] dead-bin mask (the bins
    whose ear weight is 0, where the reference's weighted spectra are
    identically zero).  d has two regimes: where the distortion is small
    (|pr - pt| <= pr / 2) it is log1p(-(pr - pt) / pr), exact zero for
    identical signals; where the test removed most of a bin it is the
    direct log(pt / pr) (gstpeaq_tpu/models/movs.py:231-238).  Returns
    [..., 512]."""
    n = C.MAXLAG
    rw = ref_power[..., :2 * n]
    tw = test_power[..., :2 * n]
    ratio = delta_power[..., :2 * n] / rw
    tw_safe = torch.where(tw > 0.0, tw, 1.0)
    d = torch.where(torch.abs(ratio) <= 0.5, torch.log1p(-ratio),
                    torch.where(tw > 0.0, exact.log(tw_safe / rw),
                                -math.inf))
    d = torch.where((rw == 0.0) & (tw == 0.0), 0.0, d)
    return torch.where(ehs_zero, 0.0, d)


def ehs_valid(ref_thresh: torch.Tensor,
              test_thresh: torch.Tensor) -> torch.Tensor:
    """EHS's frame gate [..., F] from ref/test_thresh [..., CH, F] bool:
    either signal's energy threshold reached in some channel."""
    return torch.any(ref_thresh | test_thresh, dim=-2)


def ehs_values(d: torch.Tensor, window: torch.Tensor,
               subtract_dc: bool) -> torch.Tensor:
    """Error harmonic structure (x 1000) of each row of the log-spectral
    difference d [..., 512] (ehs_log_difference); window: the [256]
    correlation window; subtract_dc: Settings'
    ehs_subtract_dc_before_window.  Returns [...].  The plain version of
    kernel E1 (ops/cuda_ehs.py)."""
    n = C.MAXLAG
    # c[i] = sum_{k<256} d[k] d[k+i], through the frequency domain like the
    # reference
    f1 = torch.fft.rfft(d, dim=-1)
    f2 = torch.fft.rfft(torch.cat([d[..., :n], torch.zeros_like(d[..., :n])],
                                  dim=-1), dim=-1)
    corr = torch.fft.irfft(f1 * torch.conj(f2), n=2 * n, dim=-1)[..., :n]
    d0 = corr[..., :1]
    dsq = d * d
    dk = d0 + torch.cat(
        [torch.zeros_like(d0),
         torch.cumsum(dsq[..., n:2 * n - 1] - dsq[..., :n - 1], dim=-1)],
        dim=-1)
    cnorm = corr / exact.sqrt(d0 * dk)
    if subtract_dc:
        cwin = (cnorm - torch.mean(cnorm, dim=-1, keepdim=True)) * window
    else:
        cwin = cnorm * window
    cfft = torch.fft.rfft(cwin, dim=-1)
    power = cfft.real ** 2 + cfft.imag ** 2
    if not subtract_dc:
        power = torch.cat([torch.zeros_like(power[..., :1]), power[..., 1:]],
                          dim=-1)
    # max over bins exceeding their predecessor; NaN-proof: NaN > x is False
    ascending = power[..., 1:] > power[..., :-1]
    ehs_val = torch.amax(torch.where(ascending, power[..., 1:], 0.0), dim=-1)
    return 1000.0 * ehs_val


def ehs_from_difference(d: torch.Tensor, ref_thresh: torch.Tensor,
                        test_thresh: torch.Tensor, settings: C.Settings,
                        window: torch.Tensor):
    """Error harmonic structure per frame from the log-spectral difference
    d [CH, F, 512] (ehs_log_difference), the rest of ehs: ehs_values and
    ehs_valid.  ref/test_thresh: [CH, F] bool; window: the [256]
    correlation window.  Returns (ehs_value [CH, F], valid [F]); the value
    is meaningless where valid is False."""
    return (ehs_values(d, window, settings.ehs_subtract_dc_before_window),
            ehs_valid(ref_thresh, test_thresh))


def ehs(ref_power: torch.Tensor, test_power: torch.Tensor,
        ref_thresh: torch.Tensor, test_thresh: torch.Tensor,
        settings: C.Settings, window: torch.Tensor,
        delta_power: torch.Tensor, ehs_zero: torch.Tensor):
    """Error harmonic structure per frame; src/movs.c:1345-1443:
    ehs_log_difference, then ehs_from_difference.

    ref/test_power: [CH, F, >=512] plain power spectra; delta_power: the
    exactly cancelled pr - pt; ref/test_thresh: [CH, F] bool; window: the
    [256] correlation window; ehs_zero: [512] dead-bin mask.  Returns
    (ehs_value [CH, F], valid [F]); the value is meaningless where valid
    is False."""
    return ehs_from_difference(
        ehs_log_difference(ref_power, test_power, delta_power, ehs_zero),
        ref_thresh, test_thresh, settings, window)
