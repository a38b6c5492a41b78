"""E1 `ehs_frames` (ops/cuda_ehs.py) on the CPU, where the wrapper takes its
plain version, models/movs.py::ehs_values.

The plain route is held to the JAX package's gstpeaq_tpu/models/movs.py::
ehs in float64 at 1e-12 (max(1, |v|) a frame), under both Settings flags
that reach EHS (ehs_subtract_dc_before_window and
center_ehs_correlation_window), on spectra made with numpy from a seed
that hold the rows the card is checked on: identical frames (an all-zero
d), a bin removed outright (-inf in d) below 256 and at 256 or above, a
NaN bin, in mono, stereo and 3 channels, at F = 0, 1, 64 and 469.  The
kernel's walk (csrc/ehs.cu) is re-enacted in numpy, a warp a row, lanes
as an array axis: the energies and the power of two s, the 16 x 32
transform of s h + i d (its 16-point DFTs, the running twiddle product,
the exchange's places, the parity swap between lanes l and l ^ 16), the
conjugate-symmetry split into 4 s D conj H by warp shuffles, the pairing
of R[k] with R[256 - k] and the 256-point inverse pruned to 128 points
(radix-4, then 8 x 8 through its places), the helper's running sums in
order, the normalisation, the mean, the window's 128-point FFT, the split
into 129 powers by shuffles and the peak; it equals the plain version
within 1e-12 (float64) and 2e-4 (float32) in mono and 3 channels under
both flags, and gives exactly 0 on every row holding a NaN or an
infinity (also at d[511] alone) or whose d0 is 0; its stages equal
numpy's FFTs and the direct lags.  The exchanges' places are one to one
and free of bank conflicts, the source's constants are the model's and
those the wrapper launches with, the launch plan covers every row once, the C entries are
bound with their argument counts, and every EHS site of the pipelines
and the chunk steps goes through ehs_frames.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import constants as JC
from gstpeaq_tpu import earparams as JEP
from gstpeaq_tpu.models import movs as JMOVS
from gstpeaq_tpu.ops import fft_ear as JFE
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch import convert
from gstpeaq_tpu_torch import earparams as EP
from gstpeaq_tpu_torch.models import movs as MOVS
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_ehs
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.parallel import stream as PS

N = C.MAXLAG
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
# (channels, frames): stereo, mono at a pair's 469 frames, 3 channels at
# a stream's one frame, no frame
SHAPES = [(2, 64), (1, 469), (3, 1), (2, 0)]


def tt(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, bar):
    """Frame by frame: |got - want| <= bar max(1, |want|), NaN nowhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert not np.isnan(got).any() and not np.isnan(want).any()
    return np.all(np.abs(got - want) <= bar * np.maximum(1.0, np.abs(want)))


@pytest.fixture(scope="module")
def consts():
    params = JEP.fft_ear_params(C.BASIC_BAND_COUNT)
    return JFE.build_consts(params), FE.build_consts(params, torch.float64)


def spectra(channels: int, frames: int, seed: int = 3):
    """(ref, test, delta) power spectra [CH, F, 1025] with a falling
    envelope and a noise floor, the test a perturbed copy, and the rows
    the card is checked on: identical frames (an all-zero d), a bin
    removed outright (-inf in d) below 256 and at 256 or above, a NaN
    bin, and a frame whose d is zero but for two bins."""
    rng = np.random.default_rng(seed + 7 * channels + frames)
    shape = (channels, frames, 1025)
    env = 10.0 ** (8.0 - 10.0 * np.arange(1025) / 1025)
    ref = env * rng.uniform(0.1, 1.0, shape) + rng.uniform(0, 1e-2, shape)
    test = ref * rng.uniform(0.3, 1.7, shape)
    edits = [lambda f: test.__setitem__((0, f), ref[0, f]),     # identical
             lambda f: test.__setitem__((-1, f, 100), 0.0),     # -inf < 256
             lambda f: test.__setitem__((0, f, 300), 0.0),      # -inf >= 256
             lambda f: test.__setitem__((-1, f, 511), 0.0),     # d[511]
             lambda f: ref.__setitem__((0, f, 7), np.nan),      # NaN
             lambda f: (test.__setitem__((-1, f), ref[-1, f]),  # two bins
                        test.__setitem__((-1, f, 3), 0.9 * ref[-1, f, 3]),
                        test.__setitem__((-1, f, 40), 1.2 * ref[-1, f, 40]))]
    for f, edit in zip(range(0, frames, 7), edits):
        edit(f)
    return ref, test, ref - test


def port_d(k, ref, test, delta) -> torch.Tensor:
    return MOVS.ehs_log_difference(tt(ref), tt(test), tt(delta), k.ehs_zero)


@pytest.mark.parametrize("subtract_dc,centered", FLAGS)
@pytest.mark.parametrize("channels,frames", SHAPES)
def test_plain_route_matches_jax(consts, subtract_dc, centered, channels,
                                 frames):
    jk, k = consts
    ref, test, delta = spectra(channels, frames)
    rng = np.random.default_rng(frames)
    thresh = rng.uniform(size=(2, channels, frames)) > 0.3
    jsettings = JC.Settings(ehs_subtract_dc_before_window=subtract_dc,
                            center_ehs_correlation_window=centered)
    settings = convert.settings_from_jax(jsettings)
    window = tt(EP.ehs_correlation_window(centered))
    want = jax.jit(JMOVS.ehs, static_argnames=("settings", "dtype"))(
        jnp.asarray(ref), jnp.asarray(test), jnp.asarray(thresh[0]),
        jnp.asarray(thresh[1]), jsettings, jnp.float64,
        delta_weighted=jnp.asarray(delta), ehs_zero=jk.ehs_zero)
    d = port_d(k, ref, test, delta)
    got = cuda_ehs.ehs_frames(d, window,
                              settings.ehs_subtract_dc_before_window)
    assert got.shape == (channels, frames) and got.dtype == torch.float64
    assert close(got, want[0], 1e-12)
    np.testing.assert_array_equal(
        MOVS.ehs_valid(tt(thresh[0]), tt(thresh[1])), want[1])
    if frames == 0:
        return
    # the composed form is the same function
    value, valid = MOVS.ehs_from_difference(d, tt(thresh[0]), tt(thresh[1]),
                                            settings, window)
    assert torch.equal(value, got)
    np.testing.assert_array_equal(valid, want[1])
    if frames >= 64:
        # rows with a NaN or an infinity, all-zero rows, and the two-bin
        # row, whose running update cancels to 0 (0 / 0 in cn), give 0
        bad = (~torch.isfinite(d).all(dim=-1)
               | ((d != 0).sum(dim=-1) <= 2))
        assert bad.sum() >= 5 and torch.all(got[bad] == 0.0)
        assert (got[~bad] > 0).all()


# ---------------------------------------------------------------------------
# the kernel's walk, re-enacted
# ---------------------------------------------------------------------------

LANE = np.arange(32)
K8 = np.arange(8)
H = np.sqrt(0.5)
# csrc/ehs.cu's constants that the walk below follows, and the launch's
SOURCE = ("kRow", "kLags", "kHalf", "kRadix", "kWarps", "kThreads",
          "kAhead", "kResident", "kExchange", "kAtV", "kAtG", "kSumRow",
          "kTwiddles", "kMaxShift")


def source_constants() -> dict:
    text = (_build.CSRC / "ehs.cu").read_text()
    return {name: int(re.search(rf"(?:constexpr int |, ){name} = (\d+)[;,]",
                                text)[1])
            for name in SOURCE}


def twiddles() -> np.ndarray:
    """ehs.cu's table: e^{-2 pi i j / 512}, j < 512, in double."""
    j = np.arange(512)
    return np.cos(np.pi * j / 256) - 1j * np.sin(np.pi * j / 256)


def tw_at(j):
    """The table's padded place of entry j (ehs.cu tw_at)."""
    return j + (j >> 3)


def butterfly(x, op):
    """A warp's xor butterfly over lanes (the last axis, 32), offsets 16,
    8, 4, 2, 1: every lane ends with the same value."""
    for off in (16, 8, 4, 2, 1):
        x = op(x, x[..., LANE ^ off])
    return x


def cswap(z):
    return z.imag + 1j * z.real


def dft8(x):
    """ehs.cu dft8 over the last axis: radix-2 decimation in frequency,
    e^{-2 pi i / 8}, natural order out."""
    x = [x[..., j] for j in range(8)]
    a0, a4 = x[0] + x[4], x[0] - x[4]
    a1, t5 = x[1] + x[5], x[1] - x[5]
    a2, t6 = x[2] + x[6], x[2] - x[6]
    a3, t7 = x[3] + x[7], x[3] - x[7]
    a5 = H * (t5.real + t5.imag) + 1j * (H * (t5.imag - t5.real))
    a6 = t6.imag - 1j * t6.real
    a7 = H * (t7.imag - t7.real) - 1j * (H * (t7.real + t7.imag))
    b0, b2, b1, t3 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    b3 = t3.imag - 1j * t3.real
    b4, b6, b5, u7 = a4 + a6, a4 - a6, a5 + a7, a5 - a7
    b7 = u7.imag - 1j * u7.real
    return np.stack([b0 + b1, b4 + b5, b2 + b3, b6 + b7, b0 - b1, b4 - b5,
                     b2 - b3, b6 - b7], axis=-1)


def idft8(x):
    """ehs.cu idft8: e^{+2 pi i / 8}, unscaled, as swap(DFT(swap(x)))."""
    return cswap(dft8(cswap(x)))


def dft4(x, inverse: bool):
    """ehs.cu dft4 over the last axis, forward or inverse."""
    s02, d02 = x[..., 0] + x[..., 2], x[..., 0] - x[..., 2]
    s13, d13 = x[..., 1] + x[..., 3], x[..., 1] - x[..., 3]
    id13 = -d13.imag + 1j * d13.real
    one, three = (d02 + id13, d02 - id13) if inverse else (d02 - id13,
                                                          d02 + id13)
    return np.stack([s02 + s13, one, s02 - s13, three], axis=-1)


def powers(w):
    """ehs.cu powers: w^k, k < 8, from the root w [...] by six products."""
    p = [np.ones_like(w), w]
    p += [w * w]
    p += [p[2] * w, p[2] * p[2]]
    p += [p[4] * w, p[3] * p[3]]
    p += [p[6] * w]
    return np.stack(p, axis=-1)


def w8_times(w, k, inverse: bool):
    """ehs.cu w8_times: w e^{-+2 pi i k / 8}, k < 4, from sums and
    differences of w's parts."""
    s, d = w.real + w.imag, w.real - w.imag
    if k == 0:
        return w
    if k == 2:
        return (-w.imag + 1j * w.real) if inverse else (w.imag - 1j * w.real)
    if k == 1:
        return H * d + 1j * (H * s) if inverse else H * s - 1j * (H * d)
    return -H * s + 1j * (H * d) if inverse else -H * d - 1j * (H * s)


# W32^k, k < 32 (ehs.cu w32)
W32 = np.exp(-2j * np.pi * np.arange(32) / 32)


def dft16(x):
    """ehs.cu dft16 over the last axis: 4-point DFTs over n2 of n = n1 + 4
    n2, times W16^{n1 k2}, then 4-point DFTs over n1; natural order out."""
    b = np.stack([dft4(x[..., n1::4], inverse=False) for n1 in range(4)],
                 axis=-2)                                # [.., n1, k2]
    b = b * W32[2 * (np.arange(4)[:, None] * np.arange(4)) % 32]
    y = dft4(np.swapaxes(b, -1, -2), inverse=False)      # [.., k2, k1]
    return np.swapaxes(y, -1, -2).reshape(*x.shape[:-1], 16)


def lag_product(z, p):
    """R' = B' conj A' from Z[m] and its partner Z[-m] (ehs.cu
    lag_product): 4 s D conj H."""
    ar, ai = z.real + p.real, z.imag - p.imag
    br, bi = z.imag + p.imag, p.real - z.real
    return (br * ar + bi * ai) + 1j * (bi * ar - br * ai)


def exchange_maps() -> dict:
    """Every shared-memory exchange of the walk: name -> (places the lanes
    write, places they read), each [32 lanes, registers], -1 where a lane
    takes no part, and the part of the warp's space it takes, (first
    place, size)."""
    k = source_constants()
    g = LANE[:, None] + 32 * np.arange(2)                     # [32, 2]
    k16 = np.arange(16)
    a_write = LANE[:, None] + 33 * k16
    a_read = (2 * k16 + (LANE >> 4)[:, None]) + 33 * (LANE & 15)[:, None]
    a, n = LANE & 7, LANE >> 3
    m4 = np.arange(4)
    v_write = g[..., None] + 64 * m4                          # [32, 2, 4]
    v_read = a[:, None] + 8 * K8 + 64 * n[:, None]
    t_write = a[:, None] + 9 * K8 + 74 * n[:, None]
    n2, p2 = LANE & 3, LANE >> 2
    t_read = K8 + 9 * p2[:, None] + 74 * n2[:, None]
    f_write = LANE[:, None] + 36 * m4
    r0, m1 = LANE & 3, LANE >> 2
    low = LANE < 16
    f_read = np.where(low[:, None], r0[:, None] + 4 * K8
                      + 36 * m1[:, None], -1)
    g_write = np.where(low[:, None], K8 + 9 * r0[:, None] + 36 * m1[:, None],
                       -1)
    s0, mm = LANE & 7, LANE >> 3
    g_read = s0[:, None] + 9 * m4 + 36 * mm[:, None]
    return {"A": (a_write, a_read, (0, 527)),
            "V": (v_write, v_read, (k["kAtV"], 256)),
            "T": (t_write, t_read, (0, 293)),
            "F": (f_write, f_read, (0, 140)),
            "G": (g_write, g_read, (k["kAtG"], 143))}


def kernel_walk(d: np.ndarray, window: np.ndarray, subtract_dc: bool,
                stages: dict | None = None) -> np.ndarray:
    """ehs.cu's walk over rows d [R, 512] of float32 or float64, in
    float64 as the kernel computes both, its values in d's type: [R].  A
    warp a row: lane l's registers are the arrays' axis 1, a warp shuffle
    an index over it, the warp's shared space an array of complex doubles
    written and read at the kernel's places.  `stages`, where given, takes
    the transform's spectrum Z, the product R', the lags c and the scale's
    log2, for the tests to hold against numpy's FFT."""
    rows = d.shape[0]
    out_type = d.dtype
    x = d.astype(np.float64)
    tw = twiddles()
    g = LANE[:, None] + 32 * np.arange(2)                        # [32, 2]
    # lane l holds d[l + 32 u + 64 j]; the energies d0 = |h|^2 (the
    # lane's squares of h in order, u outer, then the butterfly) and the
    # lanes' parts of |d|^2, not finite where a value is not; s = 2^((e_d
    # - e_h) / 2) from the largest exponents of the lanes' parts
    with np.errstate(invalid="ignore", over="ignore"):
        v = x[:, g[..., None] + 64 * K8]                 # [R, 32, 2, 8]
        lo = v[..., :4]
        part = lo[:, :, 0, 0] * lo[:, :, 0, 0]
        for u, j in [(0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2),
                     (1, 3)]:
            part = part + lo[:, :, u, j] * lo[:, :, u, j]
        mine = part + np.sum(v[..., 4:] ** 2, axis=(2, 3))      # [R, 32]
        d0 = butterfly(part, np.add)[:, 0]
    finite = np.isfinite(mine).all(axis=-1)
    live = finite & (d0 > 0)

    def exponent(e):
        return np.frexp(np.where(np.isfinite(e), e, 1.0))[1] - 1

    shift = np.where(live, (exponent(mine).max(axis=-1)
                            - exponent(part).max(axis=-1)) // 2, 0)
    shift = np.minimum(shift, source_constants()["kMaxShift"])
    scale = np.ldexp(1.0, shift)
    v = np.where(live[:, None, None, None], v, 0.0)
    lo = v[..., :4]
    x = np.where(live[:, None], x, 0.0)
    # the 512-point transform of z = s h + i d as 16 x 32: pass 1, the
    # lane's points l + 32 m (m = u + 2 j), a 16-point DFT over m, times
    # W512^{l k} by a running product of the root, into A
    m16 = np.arange(16)
    z = 1j * v[:, :, m16 & 1, m16 >> 1]                          # [R, 32, 16]
    z[..., :8] += scale[:, None, None] * v[:, :, m16[:8] & 1, m16[:8] >> 1]
    a1 = dft16(z)
    w = tw[LANE]
    p = w
    for k in range(1, 16):
        a1[..., k] *= p
        p = p * w
    maps = exchange_maps()
    buf = np.zeros((rows, 527), complex)
    buf[:, maps["A"][0]] = a1
    # pass 2: lane (k2, h) takes A[2 r + h][k2], its 16-point DFT (E on
    # h = 0, O on h = 1), swaps half its bins with lane l ^ 16 and keeps
    # X[k2 + 16 (h + 2 j + 16 t)] = E[k] +- W32^k O[k], k = h + 2 j
    eo = dft16(buf[:, maps["A"][1]])                              # [R, 32, 16]
    h = (LANE >> 4)[:, None]
    j8 = np.arange(8)
    own = np.where(h == 1, eo[..., 2 * j8 + 1], eo[..., 2 * j8])
    send = np.where(h == 1, eo[..., 2 * j8], eo[..., 2 * j8 + 1])
    got = send[:, LANE ^ 16]
    e = np.where(h == 1, got, own)
    o = np.where(h == 1, own, got) * np.where(h == 1, W32[2 * j8 + 1],
                                              W32[2 * j8])
    zl = np.concatenate([e + o, e - o], axis=-1)                  # Z[l + 32 i]
    zs = zl[..., 2 * K8[None, :] + np.arange(2)[:, None]]  # [R, 32, 2, 8]
    # R' at the lane's bins m = g + 64 k, k < 4: the partner Z[512 - m] on
    # lane -l's other group at 7 - k, lane 0 its own; R'[256] on lane 0
    partner = (-LANE) & 31
    k4 = np.arange(4)
    p = np.stack([zs[:, partner, 1 - u][..., 7 - k4] for u in (0, 1)], 2)
    p[:, 0, 0] = zs[:, 0, 0, (8 - k4) & 7]
    p[:, 0, 1] = zs[:, 0, 1, 7 - k4]
    r = lag_product(zs[..., :4], p)                      # [R, 32, 2, 4]
    r256 = lag_product(zs[:, 0, 0, 4], zs[:, 0, 0, 4])
    # Y' = E' + i O' from X[k] = R'[k] and X[256 - k] (lane -l's other
    # group at 3 - k)
    q = np.stack([r[:, partner, 1 - u][..., 3 - k4] for u in (0, 1)], 2)
    q[:, 0, 0, 0] = r256
    q[:, 0, 0, 1:] = r[:, 0, 0, (4 - k4[1:]) & 3]
    q[:, 0, 1] = r[:, 0, 1, 3 - k4]
    root = np.conj(tw[g])                                        # [32, 2]
    w = np.stack([w8_times(root, kk, inverse=True) for kk in range(4)], -1)
    e = (r.real + q.real) + 1j * (r.imag - q.imag)
    o = ((r.real - q.real) + 1j * (r.imag + q.imag)) * w
    yk = (e.real - o.imag) + 1j * (e.imag + o.real)
    # the 256-point inverse: radix-4 over k, e^{+2 pi i g n / 256}; 8 x 8
    # over g = a + 8 b (the second's conjugate twiddles are t2's), the last
    # pass pruned to q < 4
    vv = dft4(yk, inverse=True)
    w1 = root * root
    w2 = w1 * w1
    vv[..., 1:] *= np.stack([w1, w2, w2 * w1], axis=-1)
    vbuf = np.zeros((rows, 256), complex)
    vbuf[:, maps["V"][0]] = vv
    tv = idft8(vbuf[:, maps["V"][1]])
    tv[..., 1:] *= powers(np.conj(tw[8 * (LANE & 7)]))[:, 1:]
    tbuf = np.zeros((rows, 293), complex)
    tbuf[:, maps["T"][0]] = tv
    y = idft8(tbuf[:, maps["T"][1]])[..., :4]                    # y[l + 32 q]
    # c[2n] + i c[2n + 1] = y[n] 2^-(11 + log2 s); c[0] = d0; the lane's
    # lags i = 2 l + 64 q + h
    f = np.ldexp(1.0, -(11 + shift))[:, None, None, None]
    c = np.stack([y.real, y.imag], axis=-1) * f          # [R, 32, 4, 2]
    c[:, 0, 0, 0] = d0
    lag = 2 * LANE[:, None, None] + 64 * k4[:, None] + np.arange(2)
    if stages is not None:
        stages.update(z=zs, r=r, r256=r256, c=c, lag=lag, shift=shift,
                      live=live)
    # the helper's running sums in order, S_0 = 0
    terms = (x[:, N:2 * N - 1] * x[:, N:2 * N - 1]
             - x[:, :N - 1] * x[:, :N - 1])
    sums = np.concatenate([np.zeros((rows, 1)), np.cumsum(terms, axis=-1)],
                          axis=-1)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        prod = d0[:, None, None, None] * (d0[:, None, None, None]
                                          + sums[:, lag])
        cn = c * (1.0 / np.sqrt(prod))
        # the rsqrt estimate flushes a subnormal product to 0: not finite
        cn = np.where(prod >= np.finfo(np.float64).tiny, cn, np.nan)
        # the mean's sum, the lane's 8 in order, then the butterfly; the
        # row is ok where it is finite
        part = cn[:, :, 0, 0]
        for qq, h in [(0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0),
                      (3, 1)]:
            part = part + cn[:, :, qq, h]
        total = butterfly(part, np.add)[:, 0]
    ok = live & np.isfinite(total)
    cn = np.where(ok[:, None, None, None], cn, 0.0)
    wl = window.astype(d.dtype).astype(np.float64)[lag]
    mean = np.where(ok, total, 0.0)[:, None, None, None] * (1.0 / N)
    cw = (cn - mean) * wl if subtract_dc else cn * wl
    # the window's 128-point FFT of x[2n] + i x[2n + 1], n = l + 32 q:
    # radix-4 over q, times W128^{l m}; 8 x 4 over l = r0 + 4 r1
    fv = dft4(cw[..., 0] + 1j * cw[..., 1], inverse=False)       # [R, 32, 4]
    w1 = tw[4 * LANE]
    w2 = w1 * w1
    fv[..., 1:] *= np.stack([w1, w2, w2 * w1], axis=-1)
    fbuf = np.zeros((rows, 140), complex)
    fbuf[:, maps["F"][0]] = fv
    low = LANE < 16
    gv = dft8(fbuf[:, maps["F"][1][low]])                        # [R, 16, 8]
    gv[..., 1:] *= powers(tw[16 * (LANE[low] & 3)])[:, 1:]
    gbuf = np.zeros((rows, 143), complex)
    gbuf[:, maps["G"][0][low]] = gv
    zf = dft4(gbuf[:, maps["G"][1]], inverse=False)              # [R, 32, 4]
    # the split: lane (s0, m1) = (l & 7, l >> 3) holds Zf[m1 + 4 s0 + 32
    # s1]; Zf[128 - m] is a shuffle from lane src at 3 - s1 (lane 0: its
    # own at (4 - s1) & 3); W256^m = W256^{m1 + 4 s0} W8^{s1}; lane 0
    # also forms m = 128 from Zf[0]
    s0, m1 = LANE & 7, LANE >> 3
    src = np.where(m1 > 0, (7 - s0) + 8 * (4 - m1), (8 - s0) & 7)
    zb = zf[:, src][..., 3 - k4]
    zb[:, 0] = zf[:, 0][..., (4 - k4) & 3]
    root = tw[2 * (m1 + 4 * s0)]
    wm = np.stack([w8_times(root, kk, inverse=False) for kk in range(4)], -1)
    m = m1[:, None] + 4 * s0[:, None] + 32 * k4                  # [32, 4]
    # 2 A, 2 B, 2 X: the powers 4 |X|^2, the peak 1000 / 4 of the largest
    zr, zi, cr, ci = zf.real, zf.imag, zb.real, -zb.imag
    ar, ai = zr + cr, zi + ci
    br, bi = zr - cr, zi - ci
    xr = ar + (wm.real * bi + wm.imag * br)
    xi = ai - (wm.real * br - wm.imag * bi)
    power = np.zeros((rows, N // 2 + 1))
    power[:, m] = xr * xr + xi * xi
    z0 = zf[:, 0, 0]
    power[:, N // 2] = (2 * (z0.real - z0.imag)) ** 2
    if not subtract_dc:
        power[:, 0] = 0
    cand = np.where(power[:, 1:] > power[:, :-1], power[:, 1:], 0.0)
    return np.where(ok, 250.0 * cand.max(axis=-1), 0.0).astype(out_type)


def test_kernel_constants_are_the_models():
    """ehs.cu's constants are the model's (C.MAXLAG lags, a window of as
    many values, rows of twice that as 16 x 32 points) and the wrapper's
    copies of those its launch takes (the row, rows a block, blocks an
    SM); its shared memory a block (chip_smoke.ehs_shared, kShared read
    from the source) is the exchange spaces, the table, the sums, the
    window and two mbarriers, and fits kResident blocks an SM."""
    import chip_smoke as S
    k = source_constants()
    assert k["kRow"] == 2 * C.MAXLAG == cuda_ehs.ROW
    assert k["kLags"] == C.MAXLAG == cuda_ehs.LAGS
    assert EP.ehs_correlation_window().shape == (k["kLags"],)
    assert k["kHalf"] == C.MAXLAG // 2
    assert 2 * k["kRadix"] ** 2 == k["kRow"]
    assert k["kWarps"] == cuda_ehs.WARPS
    assert k["kResident"] == cuda_ehs.RESIDENT
    assert k["kAhead"] >= 1
    assert k["kThreads"] == 32 * (k["kWarps"] + 1)
    assert k["kSumRow"] >= k["kLags"] and k["kSumRow"] % 2 == 0
    assert k["kTwiddles"] == tw_at(k["kRow"] - 1) + 1
    shared = S.ehs_shared()
    assert shared == (16 * k["kWarps"] * k["kExchange"]
                      + 16 * k["kTwiddles"]
                      + 8 * k["kWarps"] * k["kSumRow"]
                      + 8 * k["kLags"] + 8 * 2)
    assert k["kResident"] * shared <= 227 * 1024


@pytest.mark.parametrize("subtract_dc,centered", FLAGS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("channels", [1, 3])
def test_kernel_walk_equals_the_plain_version(consts, subtract_dc, centered,
                                             dtype, channels):
    """The walk within 1e-12 (float64) or 2e-4 (float32) of the plain
    version on the same rows, mono and 3 channels, exactly 0 on the rows
    with a NaN or an infinity and on the all-zero rows."""
    _, k = consts
    ref, test, delta = spectra(channels, 64, seed=11)
    d = port_d(k, ref, test, delta).to(torch.from_numpy(
        np.zeros(0, dtype)).dtype)
    window = EP.ehs_correlation_window(centered).astype(dtype)
    want = cuda_ehs.ehs_frames(d, tt(window), subtract_dc).numpy()
    rows = d.reshape(-1, 2 * N).numpy()
    got = kernel_walk(rows, window, subtract_dc)
    assert got.dtype == dtype
    assert close(got, want.reshape(-1), 1e-12 if dtype == np.float64
                 else 2e-4)
    bad = ~np.isfinite(rows).all(axis=-1) | ((rows != 0).sum(axis=-1) <= 2)
    assert bad.sum() >= 6
    assert np.all(got[bad] == 0) and np.all(want.reshape(-1)[bad] == 0)


# the powers of ten fft_form_edges scales a row by: 1e-30 .. 1e+30 in
# double; in float the plain version's own products (d0 dk, its spectra's)
# leave float's range past ~1e-10 .. 1e+8, so there 1e-6 .. 1e+6
EDGE_SCALES = {np.float64: range(-30, 31, 10), np.float32: range(-6, 7, 3)}


def fft_form_edges(rows: np.ndarray, dtype) -> np.ndarray:
    """Rows that the FFT form meets otherwise than direct lags: a NaN, +inf
    and -inf only at d[511] (which no lag reads, but which enters the
    transform), energy only in d[256:512] (d0 = 0), then one row at each of
    EDGE_SCALES' scales."""
    e = [rows[0].copy() for _ in range(3)]
    for r, bad in zip(e, (np.nan, np.inf, -np.inf)):
        r[511] = bad
    high = rows[1].copy()
    high[:N] = 0.0
    scaled = [rows[2] * 10.0 ** p for p in EDGE_SCALES[dtype]]
    return np.stack(e + [high] + scaled).astype(dtype)


@pytest.mark.parametrize("subtract_dc", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_walk_on_fft_form_edges(subtract_dc, dtype):
    """On fft_form_edges' rows the walk is the plain version's within 1e-12
    (float64) or 2e-4 (float32): exactly 0 on the non-finite rows and on
    d0 = 0, the scaled rows' values those of the row at scale 1."""
    rng = np.random.default_rng(31)
    rows = fft_form_edges(rng.standard_normal((3, 2 * N)), dtype)
    window = EP.ehs_correlation_window().astype(dtype)
    want = cuda_ehs.ehs_frames(tt(rows), tt(window), subtract_dc).numpy()
    got = kernel_walk(rows, window, subtract_dc)
    assert close(got, want, 1e-12 if dtype == np.float64 else 2e-4)
    assert np.all(got[:4] == 0) and np.all(want[:4] == 0)
    assert (got[4:] > 0).all()
    scaled = got[4:].astype(np.float64)
    one = list(EDGE_SCALES[dtype]).index(0)
    assert np.allclose(scaled, scaled[one], atol=0,
                       rtol=1e-5 if dtype == np.float32 else 1e-12)


def test_kernel_walk_on_plain_random_rows():
    """Random rows with no zero bin: the walk within 1e-12 of the plain
    version, and its stages are numpy's FFTs: Z is the 512-point transform
    of s h + i d, R' is 4 s D conj H, the lags are the direct sums within
    1e-12 of the largest, also where h is 1e-9 of d (s = 2^30; unscaled, h
    would keep only ~7 digits).  There the normalisation divides lags by
    sqrt(d0 dk) ~1e-8 of them and lifts either side's rounding of the lags
    alike, so those rows' values are held at 1e-8."""
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((40, 2 * N))
    rows[::5] *= 1e-40                # small, d0 dk still normal
    rows[1::5, :N] *= 1e-9            # h far below d: s = 2^30
    low_h = np.arange(40) % 5 == 1
    for subtract_dc in (False, True):
        window = EP.ehs_correlation_window()
        want = MOVS.ehs_values(tt(rows), tt(window), subtract_dc).numpy()
        stages = {}
        got = kernel_walk(rows, window, subtract_dc, stages)
        assert close(got[~low_h], want[~low_h], 1e-12)
        assert close(got[low_h], want[low_h], 1e-8)
        assert (want > 0).all()
    s = np.ldexp(1.0, stages["shift"])
    assert (stages["shift"][1::5] >= 29).all()
    z = 1j * rows
    z[:, :N] += s[:, None] * rows[:, :N]
    zz = np.fft.fft(z)
    g = LANE[:, None] + 32 * np.arange(2)
    bins = g[..., None] + 64 * K8
    scale = np.abs(zz).max(axis=-1)[:, None, None, None]
    assert np.abs(stages["z"] - zz[:, bins]).max() <= 1e-13 * scale.max()
    dd = np.fft.fft(rows)
    hh = np.fft.fft(np.concatenate([rows[:, :N], np.zeros((40, N))], -1))
    r = 4 * s[:, None] * dd * np.conj(hh)
    big = np.abs(r).max(axis=-1)
    assert (np.abs(stages["r"] - r[:, bins[..., :4]]).max(axis=(1, 2, 3))
            <= 1e-12 * big).all()
    assert (np.abs(stages["r256"] - r[:, N]) <= 1e-12 * big).all()
    lags = np.stack([np.sum(rows[:, :N] * rows[:, i:i + N], axis=-1)
                     for i in range(N)], axis=-1)
    c = lags[:, stages["lag"]]
    assert np.abs(stages["c"] - c).max() <= 1e-12 * np.abs(lags).max(
        axis=-1).max()


def test_exchange_layouts():
    """Each exchange through the warp's space writes its places once and
    reads those it wrote, inside its part of the space, the parts that one
    step reads and the next writes apart (V and T, F and G, G and Zf); each
    quarter-warp's 16-byte access meets 8 distinct banks (places mod 8),
    so that no exchange is held up by a bank conflict; the twiddle table's
    padding spreads the lanes' strided reads."""
    k = source_constants()
    maps = exchange_maps()
    for name, (write, read, (first, size)) in maps.items():
        used = np.sort(write[write >= 0])
        assert len(set(used)) == len(used) and used.max() < size, name
        assert first + size <= k["kExchange"], name
        if read is not None:
            assert np.array_equal(np.sort(read[read >= 0]), used), name
        for places in (write, read):
            if places is None:
                continue
            cols = places.reshape(32, -1)
            for col in range(cols.shape[1]):
                for quarter in range(4):
                    at = cols[8 * quarter:8 * quarter + 8, col]
                    at = at[at >= 0]
                    assert len(set(at % 8)) == len(at), (name, col)
    for one, other in (("V", "T"), ("F", "G")):
        (a0, n0), (a1, n1) = maps[one][2], maps[other][2]
        assert a0 + n0 <= a1 or a1 + n1 <= a0, (one, other)
    assert tw_at(511) + 1 == k["kTwiddles"]
    for stride in (1, 2, 4, 8):
        at = tw_at(stride * np.arange(8)) % 8
        assert len(set(at)) == 8, stride


def test_twiddle_table_and_split_are_the_dft():
    """The table is e^{-2 pi i j / 512}, the radix-16, radix-8 and radix-4
    blocks are the DFTs, and the walk's FFT with its split gives the
    256-point real DFT's powers: on a row whose lags hold a cosine at bin
    17, the walk's peak is the plain version's."""
    tw = twiddles()
    j = np.arange(512)
    np.testing.assert_allclose(tw, np.exp(-2j * np.pi * j / 512),
                               atol=1e-15)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8)) + 1j * rng.standard_normal((3, 8))
    np.testing.assert_allclose(dft8(x), np.fft.fft(x), atol=1e-13)
    x16 = np.concatenate([x, x[:, ::-1] * 1j], axis=-1)
    np.testing.assert_allclose(dft16(x16), np.fft.fft(x16), atol=1e-13)
    np.testing.assert_allclose(W32, np.exp(-2j * np.pi * np.arange(32) / 32))
    np.testing.assert_allclose(idft8(x), 8 * np.fft.ifft(x), atol=1e-13)
    np.testing.assert_allclose(dft4(x[:, :4], False), np.fft.fft(x[:, :4]),
                               atol=1e-13)
    np.testing.assert_allclose(dft4(x[:, :4], True),
                               4 * np.fft.ifft(x[:, :4]), atol=1e-13)
    rows = rng.standard_normal((6, 2 * N))
    rows[:, :N] += 3.0 * np.cos(2 * np.pi * np.arange(N) * 17 / N)
    window = EP.ehs_correlation_window()
    got = kernel_walk(rows, window, False)
    want = MOVS.ehs_values(tt(rows), tt(window), False).numpy()
    assert close(got, want, 1e-12)


def test_cpu_route_is_the_plain_version():
    """On CPU tensors ehs_frames is ehs_values, bit for bit, with no
    launch; on another device it raises."""
    rng = np.random.default_rng(4)
    d = tt(rng.standard_normal((2, 5, 2 * N)))
    window = tt(EP.ehs_correlation_window())
    before = cuda_ehs.ehs_frames_launches
    for flag in (False, True):
        assert torch.equal(cuda_ehs.ehs_frames(d, window, flag),
                           MOVS.ehs_values(d, window, flag))
    assert cuda_ehs.ehs_frames_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ehs.ehs_frames(d.to("meta"), window.to("meta"), False)


def test_ehs_entries_are_bound():
    """The C entries of csrc/ehs.cu have their ctypes signatures, one
    argument type a parameter."""
    text = (_build.CSRC / "ehs.cu").read_text()
    for suffix in ("f32", "f64"):
        name = f"peaq_ehs_frames_{suffix}"
        params = re.search(rf"int {name}\(([^)]*)\)", text)[1]
        assert len(_build.SIGNATURES[name]) == params.count(",") + 1


@pytest.mark.parametrize("rows,sms,grid", [
    (1, 132, (1, 1)), (15, 132, (1, 15)), (128, 132, (1, 128)),
    (133, 132, (2, 67)), (936, 132, (8, 117)), (1980, 132, (15, 132)),
    (65536, 132, (15, 132)), (2 * 16 * 1024, 132, (15, 132)),
    (65536, 1, (15, 1)), (0, 132, (1, 0))])
def test_ehs_grid(rows, sms, grid):
    """A persistent grid: at most RESIDENT blocks an SM, each taking as
    few rows a round as spread the rows over all of them (a warp a row,
    WARPS at most)."""
    assert tuple(cuda_ehs.ehs_grid(rows, sms)) == grid


@pytest.mark.parametrize("rows", [1, 5, 128, 936, 4097, 65536])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_ehs_rounds_cover_every_row_once(rows, sms):
    """ehs.cu's rounds: block b takes the blocks of per_block rows b, b +
    grid, ..., (row_blocks - b + grid - 1) / grid of them; every row is
    taken by one warp of one round, and each row it stages kAhead rounds
    on is a row that a later round of the same warp takes."""
    ahead_rounds = source_constants()["kAhead"]
    per, grid = cuda_ehs.ehs_grid(rows, sms)
    blocks = -(-rows // per)
    taken = np.zeros(rows, int)
    for b in range(grid):
        for t in range(max(0, -(-(blocks - b) // grid))):
            first = (b + t * grid) * per
            n = min(per, rows - first)
            assert 0 < n and first + n <= rows
            taken[first:first + n] += 1
            for w in range(n):
                ahead = first + w + ahead_rounds * grid * per
                later = b + (t + ahead_rounds) * grid
                assert ahead >= rows or (ahead // per == later
                                         and ahead % per == w)
    assert (taken == 1).all()


def test_every_ehs_site_calls_ehs_frames(monkeypatch):
    """The pipelines and the chunk steps take EHS through ehs_frames, never
    the plain version directly: once a basic call, once an advanced one,
    once in each FFT chunk step, never in an FB step."""
    calls = []
    frames = cuda_ehs.ehs_frames

    def spy(d, window, subtract_dc):
        calls.append(tuple(d.shape))
        return frames(d, window, subtract_dc)
    monkeypatch.setattr(cuda_ehs, "ehs_frames", spy)
    rng = np.random.default_rng(8)
    ref = rng.standard_normal((40 * 1024, 2)).astype(np.float32) * 0.1
    test = ref + rng.standard_normal(ref.shape).astype(np.float32) * 0.01
    for advanced in (False, True):
        calls.clear()
        api.peaq(ref, test, advanced=advanced, device="cpu")
        assert len(calls) == 1 and calls[0][-1] == 2 * N
    chunk = 4
    for advanced in (False, True):
        calls.clear()
        pool = PS.PeaqStreamPool(1, chunk_frames=chunk, advanced=advanced,
                                 device="cpu")
        fft_need = (chunk + 1) * C.FFT_STEPSIZE
        pool.feed(ref[None, :fft_need], test[None, :fft_need])
        assert calls == [(1, 2, chunk, 2 * N)]
        if advanced:
            # the FB step computes no EHS: one more FFT step only
            fb_need = 16 * chunk * C.FB_FRAMESIZE
            pool.feed(ref[None, fft_need:fb_need],
                      test[None, fft_need:fb_need])
            assert calls == [(1, 2, chunk, 2 * N)] * 2
