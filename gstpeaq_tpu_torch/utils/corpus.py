"""Drift corpus v2: 20 synthetic program-like pairs from a seed, the
corpus the precision tiers are held to (chip_smoke.py phase 5c).

The port's own copy of `_harmonic`, `_stft_quantize`, `_lowpass` and
`realistic_pairs` of tools/tpu_drift.py, numpy only, so that the port runs
where JAX is absent; tests/test_torch_standalone.py holds realistic_pairs
equal to the original bit for bit.
"""

from __future__ import annotations

import numpy as np


def _harmonic(t, f0, cutoff=15000.0, phase=0.3):
    """Harmonic series with 1/k rolloff up to `cutoff`."""
    out = np.zeros_like(t)
    k = 1
    while k * f0 < cutoff:
        out += np.sin(2 * np.pi * k * f0 * t + phase * k) / k
        k += 1
    return out


def _stft_quantize(x, snr_db, frame=1024, rng=None):
    """Codec-like artifact: quantize 50%-overlap windowed-DFT coefficients
    with a step that follows the local spectral envelope — an MDCT-style
    quantizer shaped under a masking-curve proxy.  Long windows over
    transients produce genuine pre-echo.  snr_db sets the per-frame
    noise-to-envelope ratio."""
    hop = frame // 2
    win = np.sin(np.pi * (np.arange(frame) + 0.5) / frame)  # sine window
    n = (len(x) - frame) // hop * hop + frame
    y = np.zeros(n)
    norm = np.zeros(n)
    for s in range(0, n - frame + 1, hop):
        seg = x[s:s + frame] * win
        spec = np.fft.rfft(seg)
        mag = np.abs(spec)
        # masking-curve proxy: smoothed spectral envelope (running max over
        # +-8 bins, lower-bounded well below the frame's peak)
        env = np.maximum.reduce([np.roll(mag, d) for d in range(-8, 9)])
        env = np.maximum(env, mag.max() * 1e-4)
        step = env * 10.0 ** (-snr_db / 20.0) * np.sqrt(12.0)
        q = np.round(spec.real / step) * step + 1j * (
            np.round(spec.imag / step) * step)
        y[s:s + frame] += np.fft.irfft(q, frame) * win
        norm[s:s + frame] += win * win
    y /= np.maximum(norm, 1e-9)
    out = x.copy()
    out[:n] = y
    return out


def _lowpass(x, cutoff):
    """Linear-phase FFT brickwall lowpass."""
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / 48000.0)
    return np.fft.irfft(spec * (f < cutoff), len(x))


def realistic_pairs(n, seconds, seed=3):
    """Drift corpus v2: 20 distinct item types spanning near-transparent
    to severe, including the codec-artifact classes the round-2 corpus
    lacked — MDCT-style quantization noise shaped under a masking proxy,
    transient/pre-echo content, mid-signal bandwidth switching,
    tonal/harmonic-rich items (the reference's own worst case is the
    harpsichord item lcodpip, doc/conformance_basic_table.xml:44) — plus
    quiet-tail tentative stress, a true-stereo binaural item, DC +
    infrasonic rumble, and a mid-band spectral hole (EHS log regime).
    ODGs must cover the whole scale: a saturated corpus under-weights MOV
    drift through the sigmoid (round-1 lesson, docs/precision.md)."""
    rng = np.random.default_rng(seed)
    ns = int(seconds * 48000)
    t = np.arange(ns, dtype=np.float64) / 48000.0
    am = (1.0 + 0.35 * np.sin(2 * np.pi * 4.0 * t)
          * np.sin(2 * np.pi * 0.7 * t))

    def harm_ref(i, cutoff=15000.0):
        return 0.5 * _harmonic(t, 180.0 + 37.0 * (i % 11), cutoff) * am

    def transients():
        """Castanet-like clicks: decaying noise bursts every ~0.25 s.
        Lowpassed at 14 kHz like real program material — a flat burst
        spectrum keeps BandwidthRefB's per-frame validity gate
        (ref bw > 346, src/movs.c:806) permanently closed and the MOV
        ends 0/0."""
        x = np.zeros(ns)
        period = 12000
        for s in range(2000, ns - 4000, period):
            burst = (rng.standard_normal(4000)
                     * np.exp(-np.arange(4000) / 500.0))
            x[s:s + 4000] += 0.4 * burst
        # flat -94 dB dither: a brickwall-lowpassed ref has NO high-band
        # floor, so the bandwidth MOV's zero threshold (max power in bins
        # 921..1023, src/movs.c:781) compares numerical dust and both
        # tiers produce noise-driven (or NaN) BandwidthRefB
        return (_lowpass(x, 14000.0) + 0.02 * np.sin(2 * np.pi * 523.0 * t)
                + 2e-5 * rng.standard_normal(ns))

    def tonal():
        """Harpsichord-like: dense harmonic stack with sharp decays."""
        x = np.zeros(ns)
        for j, f0 in enumerate([220.0, 277.2, 329.6, 415.3]):
            on = int(j * 0.9 * 48000) % max(ns - 48000, 1)
            dur = min(96000, ns - on)
            td = np.arange(dur) / 48000.0
            x[on:on + dur] += 0.35 * np.exp(-td / 0.8) * _harmonic(
                td, f0, 16000.0, phase=0.11 * j)
        return x

    items = []
    # 1-4: severity ladder (lowpass + gain error + noise floor) — v1 corpus
    for cutoff, gain, noise in [(16000.0, 1.000, 1e-5), (13000.0, 0.995, 5e-5),
                                (10000.0, 0.985, 2e-4), (7000.0, 0.970, 6e-4)]:
        i = len(items)
        ref = harm_ref(i) + 1e-5 * rng.standard_normal(ns)
        test = (harm_ref(i, cutoff) * gain
                + noise * rng.standard_normal(ns))
        items.append((ref, test))
    # 5-7: MDCT-style quantization under a masking proxy, three severities
    for snr in (70.0, 45.0, 25.0):
        ref = harm_ref(len(items)) + 3e-5 * rng.standard_normal(ns)
        items.append((ref, _stft_quantize(ref, snr, rng=rng)))
    # 8-9: transient item, mild and severe quantization (pre-echo: the
    # long quantizer window smears burst noise backwards over the attack)
    trans = transients()
    items.append((trans, _stft_quantize(trans, 60.0, rng=rng)))
    items.append((trans, _stft_quantize(trans, 30.0, rng=rng)))
    # 10-11: tonal/harmonic-rich (lcodpip proxy): quantization + detune
    ton = tonal() + 1e-5 * rng.standard_normal(ns)
    items.append((ton, _stft_quantize(ton, 50.0, rng=rng)))
    det = np.interp(t * (1.0 + 3e-4), t, ton)   # ~0.5-cent pitch error
    items.append((ton, _lowpass(det, 12000.0)
                  + 1e-4 * rng.standard_normal(ns)))
    # 12: bandwidth switching every 0.5 s (codec rate switching)
    ref = harm_ref(len(items)) + 1e-5 * rng.standard_normal(ns)
    lo = _lowpass(ref, 4500.0)
    gate = (np.floor(t * 2.0) % 2).astype(bool)
    items.append((ref, np.where(gate, lo, ref)
                  + 5e-5 * rng.standard_normal(ns)))
    # 13: near-transparent (noise floor at -90 dB only)
    ref = harm_ref(len(items)) + 1e-5 * rng.standard_normal(ns)
    items.append((ref, ref + 3e-5 * rng.standard_normal(ns)))
    # 14: slow gain drift (level-adapter stress)
    ref = harm_ref(len(items)) + 1e-5 * rng.standard_normal(ns)
    items.append((ref, ref * (1.0 + 0.04 * np.sin(2 * np.pi * 0.25 * t))))
    # 15: speech-like AM noise (modulation MOVs without harmonic
    # structure).  Content to 10 kHz (fricative-like) keeps the
    # BandwidthRefB validity gate (>346 bins ~ 8.1 kHz) open — a
    # narrowband item leaves the accumulator 0/0 in every tier — plus
    # flat dither for a well-defined zero threshold (see transients)
    formant = _lowpass(rng.standard_normal(ns), 10000.0)
    syl = np.abs(np.sin(2 * np.pi * 3.1 * t)) ** 1.5
    ref = 0.3 * formant * syl + 2e-5 * rng.standard_normal(ns)
    items.append((ref, _stft_quantize(ref, 40.0, rng=rng)))
    # 16: clipping nonlinearity (harmonic distortion, full-band error)
    ref = harm_ref(len(items)) + 1e-5 * rng.standard_normal(ns)
    items.append((ref, np.clip(ref, -0.35, 0.35)))
    # 17: quiet tail (trailing 40% below the 200/32768 data-boundary
    # threshold) — exercises the accumulators' tentative/snapshot
    # machinery (src/movaccum.c:304-354): the committed value must come
    # from the content prefix in EVERY tier
    ref = harm_ref(len(items)) + 1e-5 * rng.standard_normal(ns)
    fade = np.where(t < 0.6 * seconds, 1.0, 0.0)
    fade = _lowpass(fade, 40.0)                  # click-free ~25 ms ramp
    qt_ref = ref * fade + 2e-6 * rng.standard_normal(ns)
    items.append((qt_ref, _stft_quantize(qt_ref, 40.0, rng=rng)))
    # 18: TRUE STEREO (every other item is dual-mono): different content
    # and different codec severity per channel — stresses the binaural
    # ADB/MFPD channel max (src/movs.c:1240-1260) and the channel-
    # averaged accumulators
    lch = harm_ref(len(items)) + 1e-5 * rng.standard_normal(ns)
    rch = 0.8 * tonal() + 0.1 * harm_ref(len(items) + 3) \
        + 1e-5 * rng.standard_normal(ns)
    st_ref = np.stack([lch, rch], 1)
    st_test = np.stack([_stft_quantize(lch, 55.0, rng=rng),
                        _stft_quantize(rch, 32.0, rng=rng)], 1)
    items.append((st_ref, st_test))
    # 19: DC offset + infrasonic rumble (DC-rejection chain stress: the
    # cascade must kill ~0.02 DC and 5 Hz content before the FIR bank;
    # f32 near-unit-pole rounding shows up here first)
    ref = (harm_ref(len(items)) + 0.02 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
           + 1e-5 * rng.standard_normal(ns))
    items.append((ref, _stft_quantize(ref, 45.0, rng=rng)))
    # 20: mid-band spectral hole (codec-REMOVED content, 2-4 kHz): the
    # EHS log-difference leaves the |d| << r regime — the direct-log
    # branch of the hybrid (models/movs.py::ehs) is the code under test
    ref = harm_ref(len(items)) + 2e-5 * rng.standard_normal(ns)
    spec = np.fft.rfft(ref)
    fgrid = np.fft.rfftfreq(ns, 1.0 / 48000.0)
    hole = np.fft.irfft(spec * ~((fgrid >= 2000.0) & (fgrid < 4000.0)), ns)
    items.append((ref, hole + 2e-5 * rng.standard_normal(ns)))

    refs, tests = [], []
    for i in range(n):
        ref, test = items[i % len(items)]
        if ref.ndim == 1:
            ref = np.stack([ref, ref], 1)
            test = np.stack([test, test], 1)
        refs.append(ref.astype(np.float32))
        tests.append(test.astype(np.float32))
    return refs, tests
