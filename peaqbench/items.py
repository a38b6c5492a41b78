"""Codec-evaluation items made on the device from a seed.

A PyTorch copy of the 20 item classes of drift corpus v2 (the port's
`utils/corpus.py::realistic_pairs`): harmonic stacks under a severity
ladder, MDCT-style quantisation shaped under a masking proxy (three
severities), transients with pre-echo (two), a harpsichord-like tonal item
quantised and detuned, bandwidth switching, a near-transparent item, slow
gain drift, speech-like AM noise, clipping, a quiet tail, a true-stereo
binaural item, DC with infrasonic rumble, and a mid-band spectral hole.

Each class is a *kind* (the function that makes it) with parameter ranges,
read from the traffic file.  Every seed makes the same set of classes and
strengths in [0, 1) (`draw`), in an order and with noise drawn from the
seed; every parameter given as [lo, hi] takes lo + strength (hi - lo)
(geometrically where the traffic file says "log").  The same seed, shapes
and device give the same items.  No class is one the
specification scores as NaN: no pair is identical, no reference is silent
or band-limited below ~8.1 kHz (BandwidthRefB's gate), and every reference
holds frames above the data-boundary threshold.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RATE = 48000
F64 = torch.float64


class Maker:
    """The signals of one batch of items of one kind, [N, T] float64 on
    `device`, with a generator of its own."""

    def __init__(self, n: int, samples: int, device, gen: torch.Generator):
        self.n = n
        self.samples = samples
        self.device = device
        self.gen = gen
        self.t = torch.arange(samples, dtype=F64, device=device) / RATE
        am = (1.0 + 0.35 * torch.sin(2 * math.pi * 4.0 * self.t)
              * torch.sin(2 * math.pi * 0.7 * self.t))
        self.am = am

    def noise(self, scale) -> torch.Tensor:
        x = torch.randn(self.n, self.samples, dtype=F64, device=self.device,
                        generator=self.gen)
        return x * col(scale, self.device)

    def harmonic(self, f0, cutoff=15000.0, phase=0.3, t=None) -> torch.Tensor:
        """Harmonic series with 1/k roll-off up to `cutoff` (per item f0 and
        cutoff, [N] or scalars)."""
        t = self.t if t is None else t
        f0 = col(f0, self.device)
        cutoff = col(cutoff, self.device)
        out = torch.zeros(f0.shape[0], t.shape[-1], dtype=F64,
                          device=self.device)
        kmax = int(torch.max(cutoff / f0).item()) + 1
        for k in range(1, kmax + 1):
            on = (k * f0 < cutoff).to(F64)
            out += on * torch.sin(2 * math.pi * k * f0 * t + phase * k) / k
        return out

    def harm_ref(self, f0, cutoff=15000.0) -> torch.Tensor:
        return 0.5 * self.harmonic(f0, cutoff) * self.am

    def transients(self) -> torch.Tensor:
        """Castanet-like decaying noise bursts every 0.25 s, low-passed at
        14 kHz, a 523 Hz tone and a -94 dB dither."""
        x = torch.zeros(self.n, self.samples, dtype=F64, device=self.device)
        decay = torch.exp(-torch.arange(4000, dtype=F64,
                                        device=self.device) / 500.0)
        for s in range(2000, self.samples - 4000, 12000):
            burst = torch.randn(self.n, 4000, dtype=F64, device=self.device,
                                generator=self.gen)
            x[:, s:s + 4000] += 0.4 * burst * decay
        return (lowpass(x, 14000.0)
                + 0.02 * torch.sin(2 * math.pi * 523.0 * self.t)
                + self.noise(2e-5))

    def tonal(self) -> torch.Tensor:
        """Harpsichord-like: four dense harmonic notes with sharp decays."""
        x = torch.zeros(self.n, self.samples, dtype=F64, device=self.device)
        for j, f0 in enumerate([220.0, 277.2, 329.6, 415.3]):
            on = int(j * 0.9 * RATE) % max(self.samples - RATE, 1)
            dur = min(96000, self.samples - on)
            td = torch.arange(dur, dtype=F64, device=self.device) / RATE
            x[:, on:on + dur] += 0.35 * torch.exp(-td / 0.8) * self.harmonic(
                torch.full((self.n,), f0, dtype=F64, device=self.device),
                16000.0, 0.11 * j, td)
        return x


def col(x, device) -> torch.Tensor:
    """A scalar or [N] values as an [N, 1] (or [1, 1]) float64 column."""
    return torch.as_tensor(x, dtype=F64, device=device).reshape(-1, 1)


def lowpass(x: torch.Tensor, cutoff) -> torch.Tensor:
    """Linear-phase FFT brick-wall low-pass of [N, T] rows (per row
    cutoff, [N] or a scalar)."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x, dim=-1)
    f = torch.fft.rfftfreq(n, 1.0 / RATE, dtype=F64, device=x.device)
    return torch.fft.irfft(spec * (f < col(cutoff, x.device)), n, dim=-1)


def stft_quantize(x: torch.Tensor, snr_db, frame: int = 1024) -> torch.Tensor:
    """MDCT-style codec noise: quantise 50%-overlap sine-windowed DFT
    coefficients with a step that follows the local spectral envelope (a
    running maximum over +-8 bins, floored 80 dB under the frame's peak),
    `snr_db` (per row) under it; long windows over transients give real
    pre-echo."""
    hop = frame // 2
    n_rows, n = x.shape
    dev = x.device
    win = torch.sin(math.pi * (torch.arange(frame, dtype=F64, device=dev)
                               + 0.5) / frame)
    used = (n - frame) // hop * hop + frame
    segs = x[:, :used].unfold(-1, frame, hop) * win          # [N, S, frame]
    spec = torch.fft.rfft(segs, dim=-1)
    mag = spec.abs()
    env = mag
    for d in range(-8, 9):
        env = torch.maximum(env, torch.roll(mag, d, -1))
    env = torch.maximum(env, mag.amax(-1, keepdim=True) * 1e-4)
    step = (env * (10.0 ** (-col(snr_db, dev) / 20.0))[:, :, None]
            * math.sqrt(12.0))
    q = torch.complex(torch.round(spec.real / step) * step,
                      torch.round(spec.imag / step) * step)
    y = torch.fft.irfft(q, frame, dim=-1) * win              # [N, S, frame]
    s = y.shape[1]
    out = torch.nn.functional.fold(
        y.transpose(1, 2), (1, used), (1, frame), stride=(1, hop))
    norm = torch.nn.functional.fold(
        (win * win)[None, :, None].expand(1, frame, s).contiguous(),
        (1, used), (1, frame), stride=(1, hop))
    res = x.clone()
    res[:, :used] = out[:, 0, 0] / torch.clamp_min(norm[:, 0, 0], 1e-9)
    return res


def _mono(ref, test):
    return ref[:, None].expand(-1, 2, -1), test[:, None].expand(-1, 2, -1)


# Each kind: (maker, params) -> (ref, test), [N, 2, T] float64.  `params`
# holds each parameter of the class, [N] per item.

def k_ladder(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(1e-5)
    test = (m.harm_ref(p["f0_hz"], p["cutoff_hz"]) * col(p["gain"], m.device)
            + m.noise(p["noise"]))
    return _mono(ref, test)


def k_quantized_harmonic(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(3e-5)
    return _mono(ref, stft_quantize(ref, p["snr_db"]))


def k_pre_echo(m, p):
    ref = m.transients()
    return _mono(ref, stft_quantize(ref, p["snr_db"]))


def k_tonal_quantized(m, p):
    ref = m.tonal() + m.noise(1e-5)
    return _mono(ref, stft_quantize(ref, p["snr_db"]))


def k_tonal_detuned(m, p):
    ref = m.tonal() + m.noise(1e-5)
    # ~0.5-cent pitch error at 3e-4: read the reference at a faster clock
    pos = (torch.arange(m.samples, dtype=F64, device=m.device)[None]
           * (1.0 + col(p["detune"], m.device)))
    lo = torch.clamp(pos.floor().long(), max=m.samples - 1)
    hi = torch.clamp(lo + 1, max=m.samples - 1)
    frac = pos - pos.floor()
    det = torch.where(pos <= m.samples - 1,
                      ref.gather(1, lo) * (1 - frac) + ref.gather(1, hi) * frac,
                      ref[:, -1:])
    test = lowpass(det, p["cutoff_hz"]) + m.noise(1e-4)
    return _mono(ref, test)


def k_bandwidth_switch(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(1e-5)
    lo = lowpass(ref, p["cutoff_hz"])
    gate = (torch.floor(m.t[None] / col(p["period_s"], m.device)) % 2) == 1
    return _mono(ref, torch.where(gate, lo, ref) + m.noise(5e-5))


def k_near_transparent(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(1e-5)
    return _mono(ref, ref + m.noise(p["noise"]))


def k_gain_drift(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(1e-5)
    drift = 1.0 + col(p["depth"], m.device) * torch.sin(
        2 * math.pi * 0.25 * m.t)
    return _mono(ref, ref * drift)


def k_speech(m, p):
    formant = lowpass(m.noise(1.0), 10000.0)
    syl = torch.abs(torch.sin(2 * math.pi * 3.1 * m.t)) ** 1.5
    ref = 0.3 * formant * syl + m.noise(2e-5)
    return _mono(ref, stft_quantize(ref, p["snr_db"]))


def k_clipping(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(1e-5)
    c = col(p["clip"], m.device)
    return _mono(ref, torch.minimum(torch.maximum(ref, -c), c))


def k_quiet_tail(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(1e-5)
    seconds = m.samples / RATE
    fade = (m.t < 0.6 * seconds).to(F64)[None]
    fade = lowpass(fade, 40.0)
    ref = ref * fade + m.noise(2e-6)
    return _mono(ref, stft_quantize(ref, p["snr_db"]))


def k_binaural(m, p):
    left = m.harm_ref(p["f0_hz"]) + m.noise(1e-5)
    right = (0.8 * m.tonal() + 0.1 * m.harm_ref(p["f0_hz"] * 1.5)
             + m.noise(1e-5))
    ref = torch.stack([left, right], 1)
    test = torch.stack([stft_quantize(left, p["snr_db"]),
                        stft_quantize(right, p["snr_db_right"])], 1)
    return ref, test


def k_rumble(m, p):
    ref = (m.harm_ref(p["f0_hz"]) + 0.02
           + 0.01 * torch.sin(2 * math.pi * 5.0 * m.t) + m.noise(1e-5))
    return _mono(ref, stft_quantize(ref, p["snr_db"]))


def k_spectral_hole(m, p):
    ref = m.harm_ref(p["f0_hz"]) + m.noise(2e-5)
    spec = torch.fft.rfft(ref, dim=-1)
    f = torch.fft.rfftfreq(m.samples, 1.0 / RATE, dtype=F64, device=m.device)
    hole = (f >= 2000.0) & (f < col(p["hole_hi_hz"], m.device))
    test = torch.fft.irfft(spec * ~hole, m.samples, dim=-1) + m.noise(2e-5)
    return _mono(ref, test)


KINDS = {
    "ladder": k_ladder,
    "quantized_harmonic": k_quantized_harmonic,
    "pre_echo": k_pre_echo,
    "tonal_quantized": k_tonal_quantized,
    "tonal_detuned": k_tonal_detuned,
    "bandwidth_switch": k_bandwidth_switch,
    "near_transparent": k_near_transparent,
    "gain_drift": k_gain_drift,
    "speech": k_speech,
    "clipping": k_clipping,
    "quiet_tail": k_quiet_tail,
    "binaural": k_binaural,
    "rumble": k_rumble,
    "spectral_hole": k_spectral_hole,
}


def draw(classes: list, n: int, seed: int) -> dict:
    """Each item's class index, degradation strength and tone (the place
    of its fundamental in the class's range), in [0, 1).  Every seed gets
    the same set: the classes in turn, and within a class strengths and
    tones on an even grid (the tones in another order); the seed draws
    which item takes which place.  So every seed asks the same work of the
    card, whatever of it depends on the signals."""
    i = np.arange(n)
    cls = i % len(classes)
    j = i // len(classes)                        # the item's rank in its class
    m = -(-(n - cls) // len(classes))            # items in its class
    strength = (j + 0.5) / m
    tone = ((j * 7 + 3) % m + 0.5) / m
    order = np.random.default_rng([seed, 0x5EED]).permutation(n)
    return {"class": cls[order], "strength": strength[order],
            "tone": tone[order]}


def param(spec, strength: np.ndarray) -> np.ndarray:
    """A class parameter at each strength (or tone): a number, [lo, hi],
    or [lo, hi, "log"] (geometric)."""
    if not isinstance(spec, list):
        return np.full(strength.shape, float(spec))
    lo, hi = float(spec[0]), float(spec[1])
    if len(spec) > 2 and spec[2] == "log":
        return lo * (hi / lo) ** strength
    return lo + strength * (hi - lo)


def make(classes: list, n: int, seconds: float, seed: int, device,
         out: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """`n` stereo items of `seconds` at 48 kHz: [2(ref, test), n, 2, T]
    float32 on `device` (written into `out`, whose last axis may be
    longer and is left as it is past T).  Returns (items, drawn)."""
    samples = int(round(seconds * RATE))
    drawn = draw(classes, n, seed)
    if out is None:
        out = torch.zeros(2, n, 2, samples, dtype=torch.float32,
                          device=device)
    for c, spec in enumerate(classes):
        idx = np.nonzero(drawn["class"] == c)[0]
        if not idx.size:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.default_rng([seed, c]).integers(2**62)))
        p = {k: torch.as_tensor(
            param(v, drawn["tone" if k == "f0_hz" else "strength"][idx]),
            dtype=F64, device=device)
            for k, v in spec.items() if k not in ("kind", "name")}
        maker = Maker(len(idx), samples, device, gen)
        ref, test = KINDS[spec["kind"]](maker, p)
        where = torch.as_tensor(idx, device=device)
        out[0, where, :, :samples] = ref.to(torch.float32)
        out[1, where, :, :samples] = test.to(torch.float32)
    return out, drawn
