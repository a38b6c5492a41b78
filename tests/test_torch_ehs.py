"""E1 `ehs_frames` (ops/cuda_ehs.py) on the CPU, where the wrapper takes its
plain version, models/movs.py::ehs_values.

The plain route is held to the JAX package's gstpeaq_tpu/models/movs.py::
ehs in float64 at 1e-12 (max(1, |v|) a frame), under both Settings flags
that reach EHS (ehs_subtract_dc_before_window and
center_ehs_correlation_window), on spectra made with numpy from a seed
that hold the rows the card is checked on: identical frames (an all-zero
d), a bin removed outright (-inf in d) below 256 and at 256 or above, a
NaN bin, in mono, stereo and 3 channels, at F = 0, 1, 64 and 469.  The
kernel's walk (csrc/ehs.cu) is re-enacted in numpy: the lags summed in a
fixed order, the running update summed in order, the butterfly mean, the
radix-2 FFT of the 128 complex points with its twiddle table and its
split into the 129 bins, and the NaN-proof peak; it equals the plain
version within 1e-12 on the same rows, and gives exactly 0 on every row
holding a NaN or an infinity.  The source's constants are the model's,
its C entries are bound with their argument counts, and every EHS site
of the pipelines and the chunk steps goes through ehs_frames.
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

def source_constants() -> dict:
    text = (_build.CSRC / "ehs.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = ([^;]+);",
                                text)[1].replace("kLags / 2", "128")
                      .replace("32 * (kWarps + 1)", "160")
                      .replace("kHalf + 1", "129")
                      .replace("kLags / 32", "8"))
            for name in ("kRow", "kLags", "kHalf", "kBins", "kLagsPerLane",
                         "kWarps", "kThreads")}


def twiddles():
    """ehs.cu's table: e^{-2 pi i k / 256}, k < 128, in double."""
    k = np.arange(128) / 128.0
    return np.cos(np.pi * k), -np.sin(np.pi * k)


def butterfly(x, op):
    """A warp's xor butterfly over lanes (the last axis, 32), offsets 16,
    8, 4, 2, 1: every lane ends with the same value."""
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = op(x, x[..., lane ^ off])
    return x


def kernel_walk(d: np.ndarray, window: np.ndarray,
                subtract_dc: bool) -> np.ndarray:
    """ehs.cu's walk over rows d [R, 512] of float32 or float64, in
    float64 as the kernel computes both, its values in d's type: [R]."""
    rows = d.shape[0]
    finite = np.isfinite(d).all(axis=-1)
    w = window.astype(d.dtype).astype(np.float64)
    out_type, d = d.dtype, np.where(finite[:, None], d, 0).astype(np.float64)
    # lane l owns lags 8l..8l+7; each lag summed over k = 0..255 in order
    c = np.zeros((rows, N))
    for k in range(N):
        c = c + d[:, k:k + 1] * d[:, k:k + N]
        assert k + 8 * 31 + 8 <= 2 * N - 1      # the window's last load
    d0 = c[:, :1]
    # the running update's terms, then the scan warp's ordered sum
    e = d[:, N:2 * N - 1] * d[:, N:2 * N - 1] - d[:, :N - 1] * d[:, :N - 1]
    dk = np.concatenate([d0, d0 + np.cumsum(e, axis=-1)], axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cn = c / np.sqrt(d0 * dk)
    ok = finite & np.isfinite(cn).all(axis=-1)
    cn = np.where(ok[:, None], cn, 0)
    if subtract_dc:
        lanes = cn.reshape(rows, 32, 8)
        s = lanes[..., 0]
        for l in range(1, 8):
            s = s + lanes[..., l]
        mean = butterfly(s, np.add)[:, :1] * (1.0 / N)
        cw = (cn - mean) * w
    else:
        cw = cn * w
    # the 128-point complex FFT of z[q] = x[2q] + i x[2q + 1]
    tw_re, tw_im = twiddles()
    rev = np.array([int(f"{q:07b}"[::-1], 2) for q in range(N // 2)])
    re = np.empty((rows, N // 2))
    im = np.empty((rows, N // 2))
    re[:, rev] = cw[:, 0::2]
    im[:, rev] = cw[:, 1::2]
    half = 1
    while half < N // 2:
        b = np.arange(N // 4)
        pos = b & (half - 1)
        i0 = 2 * b - pos
        i1 = i0 + half
        k = pos * (N // 2 // half)
        wr, wi = tw_re[k], tw_im[k]
        ar, ai = re[:, i1], im[:, i1]
        tr = wr * ar - wi * ai
        ti = wr * ai + wi * ar
        ur, ui = re[:, i0].copy(), im[:, i0].copy()
        re[:, i0], im[:, i0] = ur + tr, ui + ti
        re[:, i1], im[:, i1] = ur - tr, ui - ti
        half *= 2
    m = np.arange(N // 2 + 1)
    a, bb = m & (N // 2 - 1), (N // 2 - m) & (N // 2 - 1)
    zr, zi, cr, ci = re[:, a], im[:, a], re[:, bb], -im[:, bb]
    ar_, ai_ = 0.5 * (zr + cr), 0.5 * (zi + ci)
    br, bi = 0.5 * (zr - cr), 0.5 * (zi - ci)
    wr = np.where(m < N // 2, tw_re[m % (N // 2)], -1.0)
    wi = np.where(m < N // 2, tw_im[m % (N // 2)], 0.0)
    xr = ar_ + (wr * bi + wi * br)
    xi = ai_ - (wr * br - wi * bi)
    power = xr * xr + xi * xi
    if not subtract_dc:
        power[:, 0] = 0
    # the peak: lane l's bins l + 1 + 32 j, then the butterfly maximum
    cand = np.where(power[:, 1:] > power[:, :-1], power[:, 1:], 0.0)
    best = butterfly(cand.reshape(rows, 4, 32).max(axis=1), np.maximum)
    return np.where(ok, 1000.0 * best[:, 0], 0.0).astype(out_type)


def test_kernel_constants_are_the_models():
    """ehs.cu's constants are the model's (C.MAXLAG lags, a window of as
    many values, rows of twice that) and the wrapper's copies."""
    k = source_constants()
    assert k["kRow"] == 2 * C.MAXLAG == cuda_ehs.ROW
    assert k["kLags"] == C.MAXLAG == cuda_ehs.LAGS
    assert EP.ehs_correlation_window().shape == (k["kLags"],)
    assert k["kHalf"] == C.MAXLAG // 2 and k["kBins"] == C.MAXLAG // 2 + 1
    assert k["kLagsPerLane"] * 32 == k["kLags"]
    assert k["kWarps"] == cuda_ehs.WARPS
    assert k["kThreads"] == 32 * (cuda_ehs.WARPS + 1)     # and a scan warp


@pytest.mark.parametrize("subtract_dc,centered", FLAGS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_walk_equals_the_plain_version(consts, subtract_dc, centered,
                                             dtype):
    """The walk within 1e-12 (float64) or 2e-4 (float32) of the plain
    version on the same rows, exactly 0 on the rows with a NaN or an
    infinity and on the all-zero rows."""
    _, k = consts
    ref, test, delta = spectra(3, 64, seed=11)
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


def test_kernel_walk_on_plain_random_rows():
    """Random rows with no zero bin: the walk within 1e-12 of the plain
    version, and the FFT's split bins are the 256-point DFT's."""
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((40, 2 * N))
    rows[::5] *= 1e-40                # small, d0 dk still normal
    for subtract_dc in (False, True):
        window = EP.ehs_correlation_window()
        want = MOVS.ehs_values(tt(rows), tt(window), subtract_dc).numpy()
        assert close(kernel_walk(rows, window, subtract_dc), want, 1e-12)
        assert (want > 0).all()


def test_twiddle_table_and_split_are_the_dft():
    """The table is e^{-2 pi i k / 256}, and the walk's FFT with its split
    gives the 256-point real DFT's powers: on a row whose normalised lags
    are a cosine at bin m times the window, the walk's peak is the DFT's
    largest ascending power."""
    tw_re, tw_im = twiddles()
    k = np.arange(N // 2)
    np.testing.assert_allclose(tw_re + 1j * tw_im,
                               np.exp(-2j * np.pi * k / N), atol=1e-15)
    rng = np.random.default_rng(5)
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


@pytest.mark.parametrize("rows,grid", [(1, 1), (4, 1), (5, 2), (936, 234),
                                       (65536, 16384), (2 * 16 * 1024, 8192)])
def test_ehs_grid(rows, grid):
    """WARPS rows a block, the last one ragged."""
    assert cuda_ehs.ehs_grid(rows) == grid


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
