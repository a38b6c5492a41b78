"""Batched plain-PyTorch PEAQ in float64: the benchmark's reference.

The same mathematics as `numpy_spec.py` (the frozen NumPy specification,
cited per function there), written over a leading axis of pairs so that a
sample of a run's pairs is scored in a few seconds on a card.  Every step
is a plain `torch` operation in float64: the frame-parallel parts over the
frame axis at once, the recurrences over frames (and over the FB ear's
subsampled instants) as Python loops, the accumulators as masks over the
frames they would have seen.  The DC-rejection filter, a two-pole IIR over
every sample, runs as the specification runs it, through SciPy's `lfilter`
on the host.

It imports NumPy, SciPy and PyTorch, and the frozen constants and ear
parameters beside it; nothing of the program under test.  The CPU tests in
peaqbench/tests/ hold it to `numpy_spec.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from . import earparams as EP

F64 = torch.float64


def frame_count(n: int, size: int, step: int) -> int:
    """Frames of two equal-length signals of n samples: full frames, then
    one zero-padded flush frame if samples are left (`_frames_pair`)."""
    full = (n - size) // step + 1 if n >= size else 0
    return full + (1 if n - full * step > 0 else 0)


def frames(sig: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """[..., T] -> [..., F, size], the flush frame zero-padded."""
    n = sig.shape[-1]
    length = (frame_count(n, size, step) - 1) * step + size
    if length > n:
        sig = torch.nn.functional.pad(sig, (0, length - n))
    return sig[..., :length].unfold(-1, size, step)


def recur(a, x: torch.Tensor) -> torch.Tensor:
    """y[f] = a y[f - 1] + x[f] along axis -2 (frames), from y = 0: one
    launch a frame, written in place."""
    out = torch.empty_like(x)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device).expand_as(
        x[..., 0, :])
    out[..., 0, :] = x[..., 0, :]
    for f in range(1, x.shape[-2]):
        torch.addcmul(x[..., f, :], a, out[..., f - 1, :],
                      out=out[..., f, :])
    return out


def smooth(a, x: torch.Tensor) -> torch.Tensor:
    """The ear's first-order smoother y = a y + (1 - a) x over frames."""
    return recur(a, (1.0 - a) * x)


def above_threshold(ref_frames: torch.Tensor) -> torch.Tensor:
    """[K, CH, F, N] -> [K, F]: some 5-sample |x| sum of the reference
    reaches the threshold (`is_frame_above_threshold`)."""
    cs = torch.cumsum(ref_frames.abs().to(F64), -1)
    wsum = cs[..., 5:] - cs[..., :-5]
    return (wsum >= C.FRAME_THRESHOLD).any(-1).any(1)


# ---------------------------------------------------------------------------
# FFT ear
# ---------------------------------------------------------------------------

class FFTConsts:
    def __init__(self, band_count: int, level: float, device):
        p = EP.fft_ear_params(band_count, level)
        self.p = p
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=F64,
                                      device=device)
        self.z = band_count
        self.hann = t(p.hann_window)
        self.om = t(p.outer_middle_ear_weight)
        self.gm = t(p.group_matrix)
        self.noise = t(p.internal_noise)
        self.a_uc = t(p.a_uc)
        self.g_il = t(p.g_il)
        self.norm = t(p.spreading_normalization)
        self.ear_a = t(p.ear_time_constants)
        self.adapt_a = t(p.adapt_time_constants)
        self.mask_diff = t(p.masking_difference)
        self.loud = loudness_consts(p, t)
        self.expo = t(band_count - np.arange(band_count))


def loudness_consts(p, t):
    return (t(p.loudness_factor), t(p.threshold),
            t(p.excitation_threshold), p.band_count)


def spread(k: FFTConsts, pp: torch.Tensor) -> torch.Tensor:
    """Frequency spreading over the last axis (`_spread_reference`)."""
    z = k.z
    a_uce = k.a_uc * pp ** (0.2 * k.p.delta_z)
    g_iu = (1.0 - a_uce ** k.expo) / (1.0 - a_uce)
    en = pp / (k.g_il + g_iu - 1.0)
    a_ucee = a_uce ** 0.4
    ene = en ** 0.4
    ale = k.p.lower_spreading_exponentiated
    e2 = torch.empty_like(ene)
    e2[..., z - 1] = ene[..., z - 1]
    for i in range(z - 1, 0, -1):
        e2[..., i - 1] = ale * e2[..., i] + ene[..., i - 1]
    r = ene.clone()
    for d in range(1, z):
        r = r * a_ucee
        e2[..., d:] += r[..., :z - d]
    return e2 ** (1.0 / 0.4) / k.norm


def fft_ear(k: FFTConsts, fr: torch.Tensor) -> dict:
    """The FFT ear of every frame, fr [..., F, 2048] float32 samples
    (`fft_ear_process_block` frame after frame)."""
    x = fr.to(F64)
    spec = torch.fft.rfft(k.hann * x, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2) * k.p.level_factor
    weighted = power * k.om
    band = torch.clamp_min(weighted @ k.gm, 1e-12)
    unsmeared = spread(k, band + k.noise)
    filtered = smooth(k.ear_a, unsmeared)
    energy = (x[..., C.FFT_FRAMESIZE // 2:] ** 2).sum(-1)
    return {"power": power, "weighted": weighted, "unsmeared": unsmeared,
            "excitation": torch.maximum(filtered, unsmeared),
            "energy_reached": energy >= C.EHS_ENERGY_THRESHOLD}


def loudness(consts, exc: torch.Tensor) -> torch.Tensor:
    """Overall loudness of each frame (`calc_loudness`)."""
    fac, thr, ethr, z = consts
    l = fac * ((1.0 - thr + thr * exc / ethr) ** 0.23 - 1.0)
    return torch.clamp_min(l, 0.0).sum(-1) * 24.0 / z


# ---------------------------------------------------------------------------
# FB ear
# ---------------------------------------------------------------------------

class FBConsts:
    def __init__(self, level: float, device):
        p = EP.fb_ear_params(level)
        self.p = p
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=F64,
                                      device=device)
        n = C.FB_BUFFER_LENGTH
        h_re = p.h_re[:, :n].copy()
        h_im = p.h_im[:, :n].copy()
        h_re[:, 0] += p.h_re[:, n]
        h_im[:, 0] += p.h_im[:, n]
        # window columns run oldest to newest; lag j sits at column n-1-j
        self.h = t(np.concatenate([h_re, h_im])[:, ::-1].copy())   # [80, n]
        self.fc = t(p.fc)
        z = C.FB_BAND_COUNT
        ii = np.arange(z)
        expo = ii[None, :] - ii[:, None]
        self.expo = t(np.maximum(expo, 1))
        self.upper = torch.as_tensor(expo > 0, device=device)
        self.eye = t(np.eye(z))
        self.lower = t(np.where(expo <= 0, C.CL ** np.maximum(-expo, 0),
                                0.0))
        self.back = [float(v) for v in p.back_mask]
        self.noise = t(p.internal_noise)
        self.ear_a = t(p.ear_time_constants)
        self.adapt_a = t(p.adapt_time_constants)
        self.loud = loudness_consts(p, t)


def dc_reject(x: np.ndarray) -> np.ndarray:
    """Two cascaded DC-rejection high-pass stages over the last axis
    (`dc_reject`)."""
    from scipy.signal import lfilter
    b = [1.0, -2.0, 1.0]
    y1 = lfilter(b, [1.0, -C.HP1_A[0], -C.HP1_A[1]], x, axis=-1)
    return lfilter(b, [1.0, -C.HP2_A[0], -C.HP2_A[1]], y1, axis=-1)


def fb_ear(k: FBConsts, sig: torch.Tensor, rows: int = 8):
    """The FB ear of whole signals, sig [R, T] float32 with T a multiple
    of 192 (`fb_process_signal`).  Returns (excitation, unsmeared), each
    [R, F, 40]; `rows` signals at a time through the filter bank."""
    n = sig.shape[-1]
    frames_ = n // C.FB_FRAMESIZE
    sub = C.FB_SUBSAMPLING
    z = C.FB_BAND_COUNT
    hp2 = torch.as_tensor(dc_reject(sig.double().cpu().numpy()
                                    * k.p.level_factor), device=sig.device)
    padded = torch.nn.functional.pad(hp2, (C.FB_BUFFER_LENGTH - 1, 0))
    # the filter bank, `rows` signals at a time: [R, I, 80]
    fb = torch.cat([
        padded[s:s + rows].unfold(-1, C.FB_BUFFER_LENGTH, sub) @ k.h.T
        for s in range(0, sig.shape[0], rows)])
    re, im = fb[..., :z], fb[..., z:]
    level = 10.0 * torch.log10(re ** 2 + im ** 2)
    s_ = torch.clamp_min(24.0 + 230.0 / k.fc - 0.2 * level, 4.0)
    dist_s = C.DIST ** s_
    # the slope filter over the instants, every signal at once:
    # cu = prev + A (dist_s - prev), written in place
    cu = torch.empty_like(dist_s)
    torch.mul(dist_s[:, 0], C.SLOPE_FILTER_A, out=cu[:, 0])
    for i in range(1, dist_s.shape[1]):
        torch.add(cu[:, i - 1], dist_s[:, i] - cu[:, i - 1],
                  alpha=C.SLOPE_FILTER_A, out=cu[:, i])
    e0 = []
    for s in range(0, sig.shape[0], rows):
        m = torch.where(k.upper, cu[s:s + rows, ..., None] ** k.expo,
                        0.0) + k.eye
        a_re = torch.einsum("rti,rtij->rtj", re[s:s + rows], m) @ k.lower
        a_im = torch.einsum("rti,rtij->rtj", im[s:s + rows], m) @ k.lower
        e0.append(a_re ** 2 + a_im ** 2)
    e0 = torch.cat(e0)                                   # [R, I, 40]
    per = C.FB_FRAMESIZE // sub
    e0p = torch.nn.functional.pad(e0, (0, 0, 10, 0))
    last = per * torch.arange(frames_, device=sig.device) + (per - 1)
    e1 = torch.zeros(sig.shape[0], frames_, z, dtype=F64, device=sig.device)
    for i in range(11):
        e1 = e1 + k.back[i] * e0p[:, last + 10 - i]
    unsmeared = e1 + k.noise
    return smooth(k.ear_a, unsmeared), unsmeared


# ---------------------------------------------------------------------------
# Level adapter, modulation, per-frame MOVs
# ---------------------------------------------------------------------------

def band_average(x: torch.Tensor) -> torch.Tensor:
    """The pattern adapter's window average over bands."""
    bc = x.shape[-1]
    m1c, m2c = bc // 36, bc // 25
    out = torch.empty_like(x)
    for k in range(bc):
        m1 = min(k, m1c)
        m2 = min(bc - k - 1, m2c)
        out[..., k] = x[..., k - m1:k + m2 + 1].sum(-1) / (m1 + m2 + 1)
    return out


def level_adapt(a, ref: torch.Tensor, test: torch.Tensor):
    """`LevelAdapterState.process` over frames: (adapted_ref,
    adapted_test), [..., F, Z] each."""
    filt = smooth(a, torch.stack([ref, test]))
    num = torch.sqrt(filt[0] * filt[1]).sum(-1)
    den = filt[1].sum(-1)
    lev = (num * num / (den * den))[..., None]
    big = lev > 1
    lr = torch.where(big, ref / lev, ref)
    lt = torch.where(big, test, test * lev)
    fnum, fden = recur(a, torch.stack([lt * lr, lr * lr]))
    ge = fnum >= fden
    pa_ref = torch.where(ge, 1.0, fnum / fden)
    pa_test = torch.where(ge, fden / fnum, 1.0)
    pc = smooth(a, torch.stack([band_average(pa_ref),
                                band_average(pa_test)]))
    return lr * pc[0], lt * pc[1]


def modulation(a, unsmeared: torch.Tensor, step: int):
    """`ModulationState.process` over frames: (modulation, filtered
    loudness)."""
    loud = unsmeared ** 0.3
    prev = torch.nn.functional.pad(loud, (0, 0, 1, 0))[..., :-1, :]
    deriv = (C.SAMPLING_RATE / step) * (loud - prev).abs()
    fd, fl = smooth(a, torch.stack([deriv, loud]))
    return fd / (1.0 + fl / 0.3), fl


def noise_loudness(noise, z, alpha, thres_fac, s0, nl_min, ref_mod,
                   test_mod, ref_exc, test_exc) -> torch.Tensor:
    """`calc_noise_loudness` of every frame."""
    sref = thres_fac * ref_mod + s0
    stest = thres_fac * test_mod + s0
    beta = torch.exp(-alpha * (test_exc - ref_exc) / ref_exc)
    nl = ((noise / stest) ** 0.23 * (
        (1.0 + torch.clamp_min(stest * test_exc - sref * ref_exc, 0.0)
         / (noise + sref * ref_exc * beta)) ** 0.23 - 1.0)).sum(-1)
    nl = nl * (24.0 / z)
    return torch.where(nl < nl_min, 0.0, nl)


def mod_diff(noise, z, ref_mod, test_mod, ref_loud, lev_wt, rms: bool):
    """`mov_modulation_difference` of every frame: (1b, 2b, temp_wt)."""
    diff = (ref_mod - test_mod).abs()
    d1 = (diff / (1.0 + ref_mod)).sum(-1)
    w = torch.where(test_mod >= ref_mod, 1.0, 0.1)
    d2 = (w * diff / (0.01 + ref_mod)).sum(-1)
    tw = (ref_loud / (ref_loud + lev_wt * noise ** 0.3)).sum(-1)
    d1 = d1 * (100.0 / np.sqrt(z) if rms else 100.0 / z)
    return d1, d2 * (100.0 / z), tw


def nmr(k: FFTConsts, ref: dict, test: dict):
    """`mov_nmr` of every frame: (mean NMR, largest NMR or 0)."""
    rw, tw = ref["weighted"], test["weighted"]
    noise = rw - 2.0 * torch.sqrt(rw * tw) + tw
    bands = torch.clamp_min(noise @ k.gm, 1e-12)
    vec = bands / (ref["excitation"] / k.mask_diff)
    return vec.mean(-1), torch.clamp_min(vec.amax(-1), 0.0)


def bandwidth(ref_power, test_power):
    """`mov_bandwidth` of every frame: (bw_ref, bw_test)."""
    zt = test_power[..., 921:1024].amax(-1, keepdim=True)
    idx = torch.arange(1, 922, device=ref_power.device, dtype=F64)
    bw_ref = torch.where(ref_power[..., :921] > 10.0 * zt, idx,
                         0.0).amax(-1)
    hit = ((test_power[..., :921] >= C.FIVE_DB_POWER_FACTOR * zt)
           & (idx <= bw_ref[..., None]))
    return bw_ref, torch.where(hit, idx, 0.0).amax(-1)


PD = C.PD_S_COEFFS


def prob_detect(ref_exc, test_exc):
    """`mov_prob_detect` of every frame over channels [K, CH, F, Z]:
    (binaural detection probability, steps), [K, F] each."""
    er = 10.0 * torch.log10(ref_exc)
    et = 10.0 * torch.log10(test_exc)
    l = 0.3 * torch.maximum(er, et) + 0.7 * et
    lp = torch.where(l > 0, l, 1.0)
    s = (PD[0] * (PD[1] / lp) ** PD[2] + PD[3] * lp ** 4 + PD[4] * lp ** 3
         - PD[5] * lp * lp + PD[6] * lp - PD[7])
    s = torch.where(l > 0, s, 1e30)
    e = er - et
    b = torch.where(er > et, 4.0, 6.0)
    pc = 1.0 - 0.5 ** ((e / s) ** b)
    qc = torch.trunc(e).abs() / s
    det_p = torch.clamp_min(pc.amax(1), 0.0)
    det_steps = qc.amax(1)
    return 1.0 - torch.prod(1.0 - det_p, -1), det_steps.sum(-1)


def ehs(rw, tw, window) -> torch.Tensor:
    """`mov_ehs`'s per-channel value before the x1000 of every frame."""
    n = C.MAXLAG
    r, t = rw[..., :2 * n], tw[..., :2 * n]
    d = torch.where((r == 0) & (t == 0), 0.0, torch.log(t / r))
    f1 = torch.fft.rfft(d, dim=-1)
    d2 = torch.cat([d[..., :n], torch.zeros_like(d[..., :n])], -1)
    f2 = torch.fft.rfft(d2, dim=-1)
    corr = torch.fft.irfft(f1 * torch.conj(f2), n=2 * n, dim=-1)[..., :n]
    d0 = corr[..., :1]
    dsq = d ** 2
    run = torch.cumsum(dsq[..., n:] - dsq[..., :n], -1)[..., :-1]
    dk = d0 + torch.nn.functional.pad(run, (1, 0))
    cnorm = corr / torch.sqrt(d0 * dk)
    cwin = (cnorm - cnorm.mean(-1, keepdim=True)) * window
    cf = torch.fft.rfft(cwin, dim=-1)
    power = cf.real ** 2 + cf.imag ** 2
    rise = power[..., 1:] > power[..., :-1]
    return torch.clamp_min(torch.where(rise, power[..., 1:], 0.0).amax(-1),
                           0.0)


# ---------------------------------------------------------------------------
# Accumulators (`MovAccum`) as masks over frames
# ---------------------------------------------------------------------------

class Span:
    """The frames an accumulator sees for one pair: from the first frame
    above the threshold on (before it the accumulator is in its initial
    state), and counted up to the last such frame (what follows is
    tentative and rolled back at the end)."""

    def __init__(self, above: torch.Tensor):                  # [K, F]
        n = above.shape[-1]
        f = torch.arange(n, device=above.device)
        self.f = f
        self.first = torch.where(above, f, n).amin(-1, keepdim=True)
        self.last = torch.where(above, f, -1).amax(-1, keepdim=True)
        self.live = f >= self.first                            # [K, F]
        self.counted = self.live & (f <= self.last)


def counted(span, val, gate):
    """Where an accumulator of [K, CH, F] values adds: its span's counted
    frames (the same for every channel) and `gate` (broadcast to val)."""
    m = span.counted[:, None, :].expand(val.shape)
    return m if gate is None else m & gate


def acc_avg(span, val, weight=1.0, gate=None) -> torch.Tensor:
    """MODE_AVG's num / den of each channel, [K, CH]."""
    m = counted(span, val, gate)
    weight = torch.as_tensor(weight, dtype=F64, device=val.device)
    return (torch.where(m, weight * val, 0.0).sum(-1)
            / torch.where(m, weight, 0.0).sum(-1))


def acc_rms(span, val, weight=1.0, gate=None) -> torch.Tensor:
    m = counted(span, val, gate)
    w2 = torch.as_tensor(weight, dtype=F64, device=val.device) ** 2
    return torch.sqrt(torch.where(m, w2 * val * val, 0.0).sum(-1)
                      / torch.where(m, w2, 0.0).sum(-1))


def acc_rms_asym(span, val, weight, gate=None) -> torch.Tensor:
    m = counted(span, val, gate)
    den = m.to(F64).sum(-1)
    return (torch.sqrt(torch.where(m, val * val, 0.0).sum(-1) / den)
            + 0.5 * torch.sqrt(torch.where(m, weight * weight, 0.0).sum(-1)
                               / den))


def acc_window(span, val, start: int) -> torch.Tensor:
    """MODE_AVG_WINDOW: called on every frame from max(first, start)."""
    k, ch, n = val.shape
    s0 = torch.clamp_min(span.first, start)[:, None, :]       # [K, 1, 1]
    r = torch.sqrt(val)
    pad = torch.nn.functional.pad(r, (3, 0))
    past = (pad[..., 0:n] + pad[..., 1:n + 1]) + pad[..., 2:n + 2]
    win = ((r + past) / 4.0) ** 4
    f = span.f
    m = (f >= s0 + 3) & (f <= span.last[:, None, :])
    return torch.sqrt(torch.where(m, win, 0.0).sum(-1)
                      / m.to(F64).sum(-1))


def acc_adb(span, steps, prob) -> torch.Tensor:
    m = span.counted & (prob > 0.5)
    num = torch.where(m, steps, 0.0).sum(-1)
    den = m.to(F64).sum(-1)
    val = torch.where(num == 0, -0.5,
                      torch.log10(num / torch.clamp_min(den, 1.0)))
    return torch.where(den > 0, val, 0.0)


def acc_filtered_max(span, val) -> torch.Tensor:
    filt = torch.zeros_like(val[:, 0])
    best = torch.zeros_like(val[:, 0])
    for f in range(val.shape[-1]):
        filt = torch.where(span.live[:, f], 0.9 * filt + 0.1 * val[:, f],
                           filt)
        best = torch.where(span.counted[:, f], torch.maximum(best, filt),
                           best)
    return best


# ---------------------------------------------------------------------------
# Neural network
# ---------------------------------------------------------------------------

def odg_di(movs: torch.Tensor, advanced: bool) -> torch.Tensor:
    """[K, M] MOVs -> [K, 2 + M]: ODG, DI, the MOVs (`calculate_di_*`,
    `calculate_odg`)."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=F64,
                                  device=movs.device)
    if advanced:
        amin, amax, wx, wxb, wy, wyb = (
            C.NN_AMIN_ADVANCED, C.NN_AMAX_ADVANCED, C.NN_WX_ADVANCED,
            C.NN_WXB_ADVANCED, C.NN_WY_ADVANCED, C.NN_WYB_ADVANCED)
    else:
        amin, amax, wx, wxb, wy, wyb = (
            C.NN_AMIN_BASIC, C.NN_AMAX_BASIC, C.NN_WX_BASIC,
            C.NN_WXB_BASIC, C.NN_WY_BASIC, C.NN_WYB_BASIC)
    m = (movs - t(amin)) / (t(amax) - t(amin))
    x = t(wxb) + m @ t(wx)
    di = wyb + (t(wy) / (1.0 + torch.exp(-x))).sum(-1)
    odg = C.NN_BMIN + (C.NN_BMAX - C.NN_BMIN) / (1.0 + torch.exp(-di))
    return torch.cat([odg[:, None], di[:, None], movs], -1)


# ---------------------------------------------------------------------------
# Both versions
# ---------------------------------------------------------------------------

def peaq_basic(ref: torch.Tensor, test: torch.Tensor,
               level: float = 92.0) -> torch.Tensor:
    """Basic PEAQ of K equal-length pairs, ref and test [K, CH, T]
    (`peaq_basic`, default settings).  Returns [K, 2 + 11]."""
    k = FFTConsts(C.BASIC_BAND_COUNT, level, ref.device)
    rf = frames(ref, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)        # [K, CH, F, N]
    tf = frames(test, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    span = Span(above_threshold(rf))
    r = fft_ear(k, rf)
    t = fft_ear(k, tf)
    del rf, tf
    a = k.adapt_a
    ad_ref, ad_test = level_adapt(a, r["excitation"], t["excitation"])
    (mod_r, loud_r), (mod_t, _) = (modulation(a, r["unsmeared"], 1024),
                                   modulation(a, t["unsmeared"], 1024))
    f = span.f
    reached = ((loudness(k.loud, r["excitation"]) > 0.1)
               & (loudness(k.loud, t["excitation"]) > 0.1)).any(1)
    at = torch.where(reached, f, f.numel()).amin(-1, keepdim=True)
    late = f >= 24
    loud_gate = (late & (f - 3 >= at))[:, None, :]

    d1, d2, tw = mod_diff(k.noise, k.z, mod_r, mod_t, loud_r, 100.0, False)
    nl = noise_loudness(k.noise, k.z, 1.5, 0.15, 0.5, 0.0, mod_r, mod_t,
                        ad_ref, ad_test)
    bw_r, bw_t = bandwidth(r["power"], t["power"])
    nmr_mean, nmr_max = nmr(k, r, t)
    prob, steps = prob_detect(r["excitation"], t["excitation"])
    valid = (r["energy_reached"] | t["energy_reached"]).any(1)[:, None, :]
    window = torch.as_tensor(EP.ehs_correlation_window(False), dtype=F64,
                             device=ref.device)
    e = 1000.0 * ehs(r["weighted"], t["weighted"], window)
    wide = bw_r > 346
    movs = {
        "BandwidthRefB": acc_avg(span, bw_r, gate=wide).mean(-1),
        "BandwidthTestB": acc_avg(span, bw_t, gate=wide).mean(-1),
        "TotalNMRB": (10.0 * torch.log10(acc_avg(span, nmr_mean))).mean(-1),
        "WinModDiff1B": acc_window(span, d1, 24).mean(-1),
        "ADBB": acc_adb(span, steps, prob),
        "EHSB": acc_avg(span, e, gate=valid).mean(-1),
        "AvgModDiff1B": acc_avg(span, d1, tw, late).mean(-1),
        "AvgModDiff2B": acc_avg(span, d2, tw, late).mean(-1),
        "RmsNoiseLoudB": acc_rms(span, nl, gate=loud_gate).mean(-1),
        "MFPDB": acc_filtered_max(span, prob),
        "RelDistFramesB": acc_avg(
            span, (nmr_max > C.ONE_POINT_FIVE_DB_POWER_FACTOR).to(F64)
        ).mean(-1),
    }
    return odg_di(torch.stack([movs[m] for m in C.MOV_BASIC_NAMES], -1),
                  False)


def peaq_advanced(ref: torch.Tensor, test: torch.Tensor,
                  level: float = 92.0) -> torch.Tensor:
    """Advanced PEAQ of K equal-length pairs, ref and test [K, CH, T]
    (`peaq_advanced`, default settings).  Returns [K, 2 + 5]."""
    kf = FFTConsts(C.ADVANCED_FFT_BAND_COUNT, level, ref.device)
    rf = frames(ref, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    tf = frames(test, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    span = Span(above_threshold(rf))
    r = fft_ear(kf, rf)
    t = fft_ear(kf, tf)
    del rf, tf
    nmr_mean, _ = nmr(kf, r, t)
    valid = (r["energy_reached"] | t["energy_reached"]).any(1)[:, None, :]
    window = torch.as_tensor(EP.ehs_correlation_window(False), dtype=F64,
                             device=ref.device)
    e = 1000.0 * ehs(r["weighted"], t["weighted"], window)
    seg_nmr = acc_avg(span, 10.0 * torch.log10(nmr_mean)).mean(-1)
    ehs_mov = acc_avg(span, e, gate=valid).mean(-1)
    del r, t

    kb = FBConsts(level, ref.device)
    kk, ch, _ = ref.shape
    rfb = frames(ref, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    tfb = frames(test, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    span = Span(above_threshold(rfb))
    nf = rfb.shape[-2]
    sig = torch.cat([rfb.reshape(kk * ch, -1), tfb.reshape(kk * ch, -1)])
    del rfb, tfb
    exc, uns = fb_ear(kb, sig)
    exc = exc.reshape(2, kk, ch, nf, -1)
    uns = uns.reshape(2, kk, ch, nf, -1)
    a = kb.adapt_a
    ad_ref, ad_test = level_adapt(a, exc[0], exc[1])
    (mod_r, loud_r), (mod_t, _) = (modulation(a, uns[0], 192),
                                   modulation(a, uns[1], 192))
    f = span.f
    reached = ((loudness(kb.loud, exc[0]) > 0.1)
               & (loudness(kb.loud, exc[1]) > 0.1)).any(1)
    at = torch.where(reached, f, f.numel()).amin(-1, keepdim=True)
    late = f >= 125
    loud_gate = (late & (f - 13 >= at))[:, None, :]
    z = C.FB_BAND_COUNT
    d1, _, tw = mod_diff(kb.noise, z, mod_r, mod_t, loud_r, 1.0, True)
    nl = noise_loudness(kb.noise, z, 2.5, 0.3, 1.0, 0.1, mod_r, mod_t,
                        ad_ref, ad_test)
    # SWAP_MOD_PATTS_FOR_NOISE_LOUDNESS_MOVS (the default settings)
    mc = noise_loudness(kb.noise, z, 1.5, 0.15, 1.0, 0.0, mod_t, mod_r,
                        ad_test, ad_ref)
    lin = noise_loudness(kb.noise, z, 1.5, 0.15, 1.0, 0.0, mod_r, mod_r,
                         ad_ref, exc[0])
    movs = {
        "RmsModDiffA": acc_rms(span, d1, tw, late).mean(-1),
        "RmsNoiseLoudAsymA": acc_rms_asym(span, nl, mc, loud_gate).mean(-1),
        "SegmentalNMRB": seg_nmr,
        "EHSB": ehs_mov,
        "AvgLinDistA": acc_avg(span, lin, gate=loud_gate).mean(-1),
    }
    return odg_di(torch.stack([movs[m] for m in C.MOV_ADVANCED_NAMES], -1),
                  True)


def peaq(ref: torch.Tensor, test: torch.Tensor, advanced: bool,
         level: float = 92.0, block: int = 8) -> torch.Tensor:
    """PEAQ of K equal-length pairs [K, CH, T], `block` pairs at a time:
    [K, 2 + M] float64, ODG, DI, then the MOVs in the specification's
    order."""
    fn = peaq_advanced if advanced else peaq_basic
    with torch.no_grad():
        return torch.cat([fn(ref[s:s + block], test[s:s + block], level)
                          for s in range(0, ref.shape[0], block)])
