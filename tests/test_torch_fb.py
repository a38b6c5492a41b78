"""The port's filter-bank ear model and its kernels D1-D3 against the JAX
package, on the CPU.

On a CPU tensor each kernel wrapper of gstpeaq_tpu_torch runs its plain
PyTorch version.  Here that version is held against the Pallas kernels it
stands for, run in interpret mode in float32 (D2 against K4 at
max|d|/max|ref| < 1e-5; D1 + D2 against K5 + K6 through the whole band
chain at < 1e-4; D3 against K7 at < 2e-3 of max|hp2|: the bars of
test_pallas_kernels.py), and against the JAX XLA path and the NumPy spec in
float64.  The CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import constants as C
from gstpeaq_tpu import earparams as EP
from gstpeaq_tpu.ops import fb_ear as JFB
from gstpeaq_tpu.ops import fft_ear as JFE
from gstpeaq_tpu.ops import iir as JIIR
from gstpeaq_tpu.ops import pallas_dc
from gstpeaq_tpu.ops import pallas_fb
from gstpeaq_tpu.utils import numpy_ref as R
from gstpeaq_tpu_torch import convert
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_dc
from gstpeaq_tpu_torch.ops import cuda_fb
from gstpeaq_tpu_torch.ops import cuda_spread_fft
from gstpeaq_tpu_torch.ops import fb_ear as FB
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.ops import iir
from gstpeaq_tpu_torch.ops import tile_scan

LF = 0.0357           # the DC tests' level factor (test_pallas_kernels.py)
jax_dc_reject = jax.jit(JFB.dc_reject, static_argnames="return_state")


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def tt(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def params():
    return EP.fb_ear_params()


def fb_inputs(rng, shape, scale, zero_column=3):
    """Random FB outputs (re, im) with one all-zero instant column: a
    silent instant, level = -inf."""
    re = rng.standard_normal(shape) * scale
    im = rng.standard_normal(shape) * scale
    re[..., zero_column] = 0.0
    im[..., zero_column] = 0.0
    return re, im


def test_spread_plain_matches_pallas(params):
    """D2's plain version against K4 (spread_apply) with a ragged final
    tile (700 = 512 + 188 instants) and a silent instant."""
    rng = np.random.default_rng(23)
    jk = JFB.build_consts(params, dtype=jnp.float32)
    re, im = fb_inputs(rng, (2, 40, 700), 0.1)
    re, im = re.astype(np.float32), im.astype(np.float32)
    cu = rng.uniform(0.2, 0.9, (2, 40, 700)).astype(np.float32)
    want = pallas_fb.spread_apply(jnp.asarray(re), jnp.asarray(im),
                                  jnp.asarray(cu), jk.lower_matrix,
                                  interpret=True)
    k = FB.build_consts(params, torch.float32)
    got = FB.spread(k, tt(re), tt(im), tt(cu))
    assert got.dtype == torch.float32
    assert rel(got, want) < 1e-5
    assert np.all(got.numpy()[..., 3] == 0.0)


@pytest.mark.parametrize("with_state", [False, True])
def test_slope_and_spread_plain_match_xla_f64(params, with_state):
    """D1 then D2 against the JAX XLA spread_t (its own slope recurrence
    and exp-form spreading), in float64, with and without a carried cu
    state; the last instant's cu is spread_t's returned state."""
    rng = np.random.default_rng(7)
    jk = JFB.build_consts(params)
    re, im = fb_inputs(rng, (2, 40, 124), 1e3)
    cu0 = np.abs(rng.standard_normal((2, 40))) if with_state else None
    want, cu_last = jax.jit(JFB.spread_t, static_argnames="return_state")(
        jk, jnp.asarray(re), jnp.asarray(im),
        None if cu0 is None else jnp.asarray(cu0), return_state=True)
    k = FB.build_consts(params)
    cu = FB.slope_state(k, tt(re), tt(im), tt(cu0))
    got = FB.spread(k, tt(re), tt(im), cu)
    assert got.dtype == torch.float64
    assert rel(got, want) < 1e-12
    assert rel(cu[..., -1], cu_last) < 1e-12


@pytest.mark.parametrize("swap_slope", [False, True])
def test_slope_plain_matches_jax_recurrence_f64(params, swap_slope):
    """D1's plain version against the slope state as spread_t builds it
    (level, s, DIST^s and iir.linear_recurrence_blocked with a y0), for
    both smoothing-coefficient conventions."""
    rng = np.random.default_rng(11)
    jk = JFB.build_consts(params, swap_slope=swap_slope)
    re, im = fb_inputs(rng, (3, 40, 300), 10.0)
    cu0 = rng.uniform(0.0, 0.5, (3, 40))
    level = 10.0 * np.log10(re * re + im * im)
    with np.errstate(invalid="ignore"):
        s = np.maximum(4.0, 24.0 + 230.0 / params.fc[:, None] - 0.2 * level)
    decay = C.SLOPE_FILTER_A if swap_slope else 1.0 - C.SLOPE_FILTER_A
    want = JIIR.linear_recurrence_blocked(
        decay, jnp.asarray((1.0 - decay) * C.DIST ** s), y0=jnp.asarray(cu0))
    _, cu_last = JFB.spread_t(jk, jnp.asarray(re), jnp.asarray(im),
                              jnp.asarray(cu0), True)
    k = FB.build_consts(params, swap_slope=swap_slope)
    assert k.slope_a == decay
    got = FB.slope_state(k, tt(re), tt(im), tt(cu0))
    assert rel(got, want) < 1e-12
    assert rel(got[..., -1], cu_last) < 1e-12
    assert np.all(np.isfinite(got.numpy()))


def test_band_chain_matches_fused_pallas(params):
    """D1 + D2 (through band_chain) against the TPU's fused path: K5's
    slope prefixes, K1's quarter-rate recurrence and K6's spreading from
    the raw conv outputs (FB._spread_fused_masked, interpret mode), in
    float32 on the same hp2, at n_frames = 256 (I = 1,536, the kernels'
    tile)."""
    rng = np.random.default_rng(3)
    n_frames = 256
    x = (rng.standard_normal((2, 192 * n_frames)) * 0.2).astype(np.float32)
    x[1] *= 0.5
    x[:, :1000] = 0.0                       # leading silence
    jk = JFB.build_consts(params, dtype=jnp.float32)
    hp2 = JFB.dc_reject(jnp.asarray(x) * jk.level_factor)
    exc_w, uns_w, _, _ = JFB._spread_fused_masked(jk, hp2, None, None,
                                                  n_frames)
    k = FB.build_consts(params, torch.float32)
    exc, uns = FB.band_chain(k, tt(hp2), n_frames)
    assert exc.dtype == uns.dtype == torch.float32
    assert rel(exc, exc_w) < 1e-4
    assert rel(uns, uns_w) < 1e-4


def test_dc_chain_plain_matches_pallas():
    """D3's plain version against K7 (dc_chain_blocked) in float32: both
    carry ~6e-4 * max|hp2| of intrinsic float32 error against float64 (the
    near-unit poles), so the bar is 2e-3 of max|hp2|."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 49152)) * 2500.0).astype(np.float32)
    want = np.asarray(pallas_dc.dc_chain_blocked(
        jnp.asarray(x).reshape(2, -1, 128), LF,
        interpret=True)).reshape(2, -1)
    got, _ = cuda_dc.dc_chain(tt(x), float(np.float32(LF)))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() / scale < 2e-3
    assert abs(got.numpy().mean()) < 1e-3 * scale


def test_dc_chain_plain_matches_xla_and_spec_f64():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 30000)) * 2500.0
    x[:, :500] = 0.0
    got, _ = cuda_dc.dc_chain(tt(x), LF)
    assert got.dtype == torch.float64
    want = np.asarray(jax_dc_reject(jnp.asarray(x * LF)))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() / scale < 1e-10
    spec = np.stack([R.dc_reject(row * LF) for row in x])
    assert np.abs(got.numpy() - spec).max() / scale < 1e-10


def test_dc_chain_state_resumes_across_packages():
    """Two chunks with the carried state equal the one-shot run, a port
    state resumes JAX's dc_reject, and JAX's state resumes the port, in
    float64 to < 1e-11 of max|hp2| (and the states to < 1e-11 of their
    max).  A chunk split, or the other package's blocked scan, reorders the
    sums, and the poles' ~833x DC gain each lift that float64 rounding to
    1.1e-12 .. 2.3e-12 of max|hp2| here, so 1e-12 cannot be held."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 2, 20000)) * 2500.0
    cut = 12345
    whole, _ = cuda_dc.dc_chain(tt(x), LF)
    h1, st = cuda_dc.dc_chain(tt(x[..., :cut]), LF)
    h2, _ = cuda_dc.dc_chain(tt(x[..., cut:]), LF, st)
    scale = np.abs(whole.numpy()).max()
    assert rel(torch.cat([h1, h2], -1), whole) < 1e-11
    assert all(s.shape == (2, 2, 2) for s in st)
    xs = jnp.asarray(x * LF)
    j2 = jax_dc_reject(xs[..., cut:], tuple(jnp.asarray(s.numpy())
                                            for s in st))
    assert np.abs(np.asarray(j2) - h2.numpy()).max() / scale < 1e-11
    _, jst = jax_dc_reject(xs[..., :cut], None, return_state=True)
    p2, _ = cuda_dc.dc_chain(tt(x[..., cut:] * LF), 1.0,
                             tuple(tt(np.asarray(s)) for s in jst))
    assert np.abs(p2.numpy() - np.asarray(j2)).max() / scale < 1e-11
    for s_port, s_jax in zip(st, jst):
        assert rel(s_port, s_jax) < 1e-11
    # a one-sample chunk keeps the two newest inputs in its tail
    h3, st3 = cuda_dc.dc_chain(tt(x[..., cut:cut + 1]), LF, st)
    np.testing.assert_allclose(st3[0][..., 0], st[0][..., 1])
    np.testing.assert_allclose(st3[0][..., 1], x[..., cut] * LF)
    assert rel(h3[..., 0], h2[..., 0]) < 1e-12


TILE, LANES = tile_scan.TILE, tile_scan.LANES


@pytest.mark.parametrize("t", [1, 31, TILE - 1, TILE, TILE + 1, 480000,
                               10**7])
def test_dc_chain_launch_plan_covers_each_row(t):
    """D3's tiles (tile_scan.launch_plan) cover a row exactly (the last one
    ragged), the LANES segments of `seg` tiles that a block folds reach
    back to tile 0, and the grid stays within CUDA's 2^31 - 1 blocks up to
    2^16 rows."""
    for rows in (1, 4, 2**16):
        tiles, seg, blocks = tile_scan.launch_plan(rows, t, "dc_chain")
        assert (tiles - 1) * TILE < t <= tiles * TILE
        assert (seg - 1) * LANES < tiles <= seg * LANES
        assert blocks == rows * tiles <= tile_scan.GRID_LIMIT == 2**31 - 1
    with pytest.raises(ValueError, match="dc_chain: .* blocks"):
        tile_scan.launch_plan(2**16, 2**40, "dc_chain")


def test_dc_chain_plan_constants_are_the_kernels():
    """ops/tile_scan.py's plan constants are csrc/tile_scan.cuh's, which
    dc_chain.cu (D3) and fb_spread.cu (D1) both include."""
    src = (_build.CSRC / "tile_scan.cuh").read_text()
    assert f"constexpr int kRun = {tile_scan.RUN};" in src
    assert f"constexpr int kThreads = {tile_scan.THREADS};" in src
    assert "constexpr int kTile = kRun * kThreads;" in src
    assert (f"constexpr long long kGridLimit = {tile_scan.GRID_LIMIT}LL;"
            in src)
    assert tile_scan.TILE == tile_scan.RUN * tile_scan.THREADS
    assert LANES == 32 and "constexpr int kWarp = 32;" in (
        _build.CSRC / "warp_scan.cuh").read_text()
    for name in ("dc_chain.cu", "fb_spread.cu"):
        assert '#include "tile_scan.cuh"' in (_build.CSRC / name).read_text()


def _pole_factors(seg):
    """scan_factors(seg) split per pole into [a, *a^n] (lp, lm real; lam
    complex from its (re, im) pairs) and g."""
    f = cuda_dc.scan_factors(seg)
    k = len(tile_scan.scan_exponents(seg)) + 1
    assert f.shape == (4 * k + 2,) and f.dtype == np.float64
    lam = f[2 * k:4 * k:2] + 1j * f[2 * k + 1:4 * k:2]
    return f[:k], f[k:2 * k], lam, complex(f[-2], f[-1])


@pytest.mark.parametrize("seg", [1, 8, 153])
def test_dc_chain_scan_factors_are_float64_powers(seg):
    """Each factor equals numpy's float64 power of its pole to 1e-15
    relative, the complex one through polar form."""
    ns = tile_scan.scan_exponents(seg)
    tile = TILE
    assert ns == [8, 16, 32, 64, 128, 256, tile,
                  tile * seg, 2 * tile * seg, 4 * tile * seg, 8 * tile * seg,
                  16 * tile * seg]
    n = np.array([1, *ns], dtype=np.float64)
    lp, lm, lam, g = cuda_dc.coefficients()
    got_lp, got_lm, got_lam, got_g = _pole_factors(seg)
    for a, got in ((lp, got_lp), (lm, got_lm)):
        want = np.float64(a) ** n
        assert np.all(np.abs(got - want) <= 1e-15 * want)
    want = np.abs(lam) ** n * np.exp(1j * n * np.angle(lam))
    assert np.all(np.abs(got_lam - want) <= 1e-15 * np.abs(want))
    assert got_g == g
    assert not cuda_dc.scan_factors(seg).flags.writeable


@pytest.mark.parametrize("pole", ["lp", "lam"])
def test_dc_chain_factors_fold_tiles_as_the_kernel_does(pole):
    """csrc/dc_chain.cu's algebra on the host's factors, in float64: runs of
    RUN folded by a warp scan and the warp ends by a^(RUN LANES) give a
    tile's zero-entry end (tile_end); the carried state and the earlier
    tiles' ends folded in LANES segments of `seg` tiles, then a warp scan,
    give each tile's entry state (tile_entry).  Both against the
    recurrence run straight through, on 70 tiles (seg = 3)."""
    tile, lanes = TILE, LANES
    tiles, seg, _ = tile_scan.launch_plan(1, 70 * tile, "dc_chain")
    assert (tiles, seg) == (70, 3)
    lp, _, lam, _ = _pole_factors(seg)
    p = lp if pole == "lp" else lam
    a, run, warp, tile_f, carry = p[0], p[1:6], p[6], p[7], p[8:13]
    c0 = 0.7 if pole == "lp" else 0.7 - 0.3j
    dtype = torch.float64 if pole == "lp" else torch.complex128
    v = torch.from_numpy(np.random.default_rng(31).standard_normal(
        tiles * tile)).to(dtype)

    def rec(drive, y0=None):
        return iir.linear_recurrence(a, drive, axis=-1, y0=y0).numpy()

    def warp_scan(x, steps):
        for e, f in enumerate(steps):
            off = 1 << e
            x = np.concatenate([x[..., :off], x[..., off:]
                                + f * x[..., :-off]], -1)
        return x

    y = rec(v, torch.tensor(c0, dtype=dtype))
    agg = rec(v.reshape(tiles, tile))[:, -1]
    ends = warp_scan(rec(v.reshape(tiles, -1, lanes, tile_scan.RUN))[..., -1],
                     run)[..., -1]                  # [tiles, warps]
    folded = np.zeros_like(agg)
    for w in range(ends.shape[-1]):
        folded = warp * folded + ends[:, w]
    scale = np.abs(y).max()
    assert np.abs(folded - agg).max() < 1e-12 * scale
    for j in range(tiles):
        h = np.zeros(lanes, dtype=agg.dtype)
        for lane in range(lanes):
            hi = j - (lanes - 1 - lane) * seg
            for i in range(max(hi - seg, -1), hi):
                h[lane] = tile_f * h[lane] + (c0 if i < 0 else agg[i])
        entry = warp_scan(h, carry)[-1]
        want = c0 if j == 0 else y[j * tile - 1]
        assert abs(entry - want) < 1e-12 * scale, j


@pytest.mark.parametrize("n", [1, 31, TILE - 1, TILE, TILE + 1, 15000,
                               33 * TILE + 1, 10**7])
def test_slope_state_launch_plan_covers_each_row(n):
    """D1's plan (tile_scan.launch_plan): its tiles cover a row of n
    instants exactly, the segments its fold reads reach back to tile 0,
    and both launches (rows (tiles - 1) blocks of ends, rows tiles of cu)
    stay within CUDA's grid, from one row to 2^16 rows of 40 bands."""
    for rows in (1, 160, 40 * 2**10):
        tiles, seg, blocks = tile_scan.launch_plan(rows, n, "slope_state")
        assert (tiles - 1) * TILE < n <= tiles * TILE
        assert (seg - 1) * LANES < tiles <= seg * LANES
        assert 0 <= rows * (tiles - 1) < blocks == rows * tiles
        assert blocks <= tile_scan.GRID_LIMIT
    with pytest.raises(ValueError, match="slope_state: .* blocks"):
        tile_scan.launch_plan(40 * 2**16, 10**8, "slope_state")


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("seg", [1, 2, 153])
def test_slope_factors_are_float64_powers(params, swap, seg):
    """slope_factors: the smoother's decay a (or 1 - a, the swapped slope
    convention) and each a^n of tile_scan.scan_exponents to 1e-15
    relative, then 1 - a; read-only."""
    a = FB.build_consts(params, swap_slope=swap).slope_a
    f = cuda_fb.slope_factors(a, seg)
    n = np.array([1, *tile_scan.scan_exponents(seg)], dtype=np.float64)
    assert f.dtype == np.float64 and f.shape == (len(n) + 1,)
    want = np.float64(a) ** n
    assert np.all(np.abs(f[:-1] - want) <= 1e-15 * want)
    assert f[-1] == 1.0 - a
    assert not f.flags.writeable


def _warp_scan(x, steps):
    """tile_scan.cuh's warp scan on the host, along the last axis (lanes)."""
    for e, f in enumerate(steps):
        off = 1 << e
        x = np.concatenate([x[..., :off], x[..., off:] + f * x[..., :-off]],
                           -1)
    return x


def _slope_state_on_host(re, im, c1, a, y0):
    """csrc/fb_spread.cu's D1 on the host in float64: the drive with
    exp(s ln DIST), the ends launch (tiles but the last: runs of RUN, a
    warp scan, the warp ends folded), the cu launch (tile_entry's fold of
    y0 and the earlier ends in LANES segments of `seg`, run_entry's warp
    fold and scan, then each run from its entry).  Returns cu and the
    ends."""
    rows, n = re.shape
    tiles, seg, _ = tile_scan.launch_plan(rows, n, "slope_state")
    f = cuda_fb.slope_factors(a, seg)
    run, warp, tile_f, carry, oma = f[1:6], f[6], f[7], f[8:13], f[13]
    with np.errstate(divide="ignore"):
        level = 10.0 * np.log10(re * re + im * im)
    s = np.maximum(c1[:, None] - 0.2 * level, 4.0)
    drive = np.zeros((rows, tiles * TILE))
    drive[:, :n] = oma * np.exp(s * float(np.log(C.DIST)))
    v = drive.reshape(rows, tiles, -1, LANES, tile_scan.RUN)
    end = np.zeros(v.shape[:-1])
    for j in range(tile_scan.RUN):
        end = a * end + v[..., j]
    scanned = _warp_scan(end, run)                     # [rows, tiles, W, L]
    agg = np.zeros((rows, tiles))
    for w in range(scanned.shape[2]):
        agg = warp * agg + scanned[:, :, w, -1]
    agg[:, -1] = np.nan                    # the ends launch skips it
    cu = np.zeros_like(v)
    for row in range(rows):
        for t in range(tiles):
            h = np.zeros(LANES)
            for lane in range(LANES):
                hi = t - (LANES - 1 - lane) * seg
                for i in range(max(hi - seg, -1), hi):
                    h[lane] = tile_f * h[lane] + (y0[row] if i < 0
                                                  else agg[row, i])
            x = _warp_scan(h, carry)[-1]               # the tile's entry
            for w in range(v.shape[2]):
                lane0 = end[row, t, w].copy()
                lane0[0] += run[0] * x
                s_in = _warp_scan(lane0, run)
                y = np.concatenate([[x], s_in[:-1]])   # each run's entry
                for j in range(tile_scan.RUN):
                    y = a * y + v[row, t, w, :, j]
                    cu[row, t, w, :, j] = y
                x = warp * x + scanned[row, t, w, -1]
    return cu.reshape(rows, -1)[:, :n], agg[:, :-1]


@pytest.mark.parametrize("swap", [False, True])
def test_slope_state_folds_tiles_as_the_kernel_does(params, swap):
    """D1's tile-and-fold algebra on the host's factors equals the plain
    version (the straight recurrence) to 1e-12, on 2 rows of 34 tiles
    (seg = 2) with silent instants at tile starts and a carried y0; each
    tile's end equals the zero-entry recurrence over that tile."""
    k = FB.build_consts(params, swap_slope=swap)
    rng = np.random.default_rng(37)
    n = 33 * TILE + 5
    re = rng.standard_normal((2, n)) * 100.0
    im = rng.standard_normal((2, n)) * 100.0
    re[:, ::TILE] = im[:, ::TILE] = 0.0
    c1 = (24.0 + 230.0 / k.fc[:2]).numpy()
    y0 = np.array([0.3, 0.05])
    got, ends = _slope_state_on_host(re, im, c1, k.slope_a, y0)
    want = cuda_fb.slope_state_plain(tt(re), tt(im), tt(c1), k.slope_a,
                                     tt(y0)).numpy()
    assert np.isfinite(got).all()
    assert rel(got, want) < 1e-12
    zero = cuda_fb.slope_state_plain(tt(re), tt(im), tt(c1),
                                     k.slope_a).numpy()
    tile_ends = np.stack([
        zero[:, t * TILE + TILE - 1] - k.slope_a ** TILE
        * (zero[:, t * TILE - 1] if t else 0.0) for t in range(33)], 1)
    assert np.abs(ends - tile_ends).max() < 1e-12 * np.abs(zero).max()


def test_slope_state_constants_are_the_kernels():
    """fb_spread.cu's ln DIST is log(C.DIST) in float64, its two launches
    are named slope_state_*_kernel, and it reads slope_factors' layout
    through tile_scan.cuh's fill, then 1 - a."""
    src = (_build.CSRC / "fb_spread.cu").read_text()
    assert f"constexpr double kLnDist = {float(np.log(C.DIST))!r};" in src
    for kernel in ("slope_state_ends_kernel", "slope_state_cu_kernel"):
        assert f"\n{kernel}(" in src
    assert "co.oma = static_cast<T>(*fill(co.p, coef));" in src
    assert f"constexpr int kZ = {cuda_fb.BANDS};" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spread_fb_lower_table_is_cl_powers(params, dtype):
    """The FB lower table is CL^(j-c) (j >= c) in the band dtype, and
    FBEarConsts.cl, which D2's wrapper takes in place of it, is CL in that
    dtype, also under a float64 spectrum.  The table the wrapper forms from
    cl on the CPU is that table, bit for bit in float64, and within the
    rounding of CL to float32 (1e-5 relative, powers up to 39) in float32."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    k = FB.build_consts(params, dtype, spectrum_dtype=torch.float64)
    j, c = np.indices((40, 40))
    want = np.where(j >= c, C.CL ** np.maximum(j - c, 0), 0.0)
    np.testing.assert_array_equal(k.lower_matrix.numpy(),
                                  want.astype(np_dtype))
    assert k.cl == float(np_dtype(C.CL))
    table = cuda_spread_fft.lower_table(40, k.cl, dtype, "cpu")
    if dtype == torch.float64:
        assert torch.equal(table, k.lower_matrix)
    else:
        np.testing.assert_allclose(table.numpy(), k.lower_matrix.numpy(),
                                   rtol=1e-5, atol=1e-44)


def _upper_walk(part, cu, group=None):
    """D2's upper slope on one part [..., 40, I] in its dtype: the
    shift-multiply walk w_i *= cu_i, A_{i+s} += w_i.  group None: source by
    source from the top down; else fb_spread.cu's order, `group` sources
    [lo, top] in lockstep, groups from the top down."""
    a = list(part.unbind(-2))
    groups = ([(i, i) for i in range(38, -1, -1)] if group is None else
              [(max(top - group + 1, 0), top)
               for top in range(38, -1, -group)])
    for lo, top in groups:
        w = {i: a[i] for i in range(lo, top + 1)}
        for step in range(1, 40 - lo):
            for i in range(lo, top + 1):
                if i + step < 40:
                    w[i] = w[i] * cu[..., i, :]
                    a[i + step] = a[i + step] + w[i]
    return a


def _spread_fb_on_host(fb_re, fb_im, cu, cl, group):
    """csrc/fb_spread.cu's D2 re-enacted in torch, in the inputs' dtype:
    each part (real, imaginary) on its own, the upper slope as the grouped
    lockstep walk, the lower slope as the backward recurrence
    B_c = A_c + CL B_{c+1}, and the two parts' B_c^2 joined (the kernel's
    __shfl_xor_sync)."""
    e0 = torch.zeros_like(fb_re)
    for part in (fb_re, fb_im):
        a = _upper_walk(part, cu, group)
        b = a[39]
        e0[..., 39, :] += b * b
        for c in range(38, -1, -1):
            b = a[c] + cl * b
            e0[..., c, :] += b * b
    return e0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spread_fb_parts_and_recurrence_match_plain(params, dtype):
    """D2's design re-enacted on the host equals spread_fb_plain's [40, 40]
    product of the table: within 1e-12 in float64 and 1e-5 in float32 (the
    bars chip_smoke.py holds the kernel to), on 3 leads with a silent
    instant.  Its grouped lockstep walk (fb_spread.cu's kWalkGroup, and 4
    and 16) gives the per-source walk's bits."""
    rng = np.random.default_rng(41)
    k = FB.build_consts(params, dtype)
    re, im = fb_inputs(rng, (3, 40, 257), 10.0)
    cu = rng.uniform(0.2, 0.9, (3, 40, 257))
    re, im, cu = (torch.as_tensor(x, dtype=dtype) for x in (re, im, cu))
    cl = torch.tensor(k.cl, dtype=dtype)
    group = _spread_fb_constants()["kWalkGroup"]
    per_source = _upper_walk(re, cu)
    for g in (group, 4, 16):
        assert all(torch.equal(x, y) for x, y in zip(
            _upper_walk(re, cu, g), per_source)), g
    got = _spread_fb_on_host(re, im, cu, cl, group)
    want = cuda_fb.spread_fb_plain(re, im, cu, k.lower_matrix)
    assert got.dtype == dtype
    assert rel(got, want) < (1e-12 if dtype == torch.float64 else 1e-5)
    assert np.all(got.numpy()[..., 3] == 0.0)


def _spread_fb_constants() -> dict:
    """fb_spread.cu's D2 layout constants: the rows a tile stages and their
    shift, the sources the walk moves at once, and the instants a tile per
    type (two threads an instant, one a part)."""
    src = (_build.CSRC / "fb_spread.cu").read_text()
    out = {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
           for name in ("kRowShift", "kWalkGroup")}
    assert "constexpr int kTileRows = 3 * kZ - 1;" in src
    assert "constexpr int kSpreadThreads = 2 * kTileInstants<T>;" in src
    tile = re.search(r"constexpr int kTileInstants = "
                     r"sizeof\(T\) == 4 \? (\d+) : (\d+);", src)
    out["kTileInstants"] = {torch.float32: int(tile[1]),
                            torch.float64: int(tile[2])}
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("leads,n", [(4, 15000), (70000, 3), (3, 37),
                                     (5, 7), (1, 1)])
def test_spread_fb_tiles_store_each_value_once(leads, n, dtype):
    """D2's persistent tiling (fb_spread.cu's launch_spread, stage_tile and
    spread_tile, re-enacted): blocks walk every tile once; a tile's copies,
    of 1, 2 or 4 instants, fill each (row, instant) slot of its buffer
    once, with no two rows overlapping; and every (lead, instant, band) of
    E0 is stored exactly once, by a live lane whose shuffle partner
    (lane ^ 16) works on the
    same instant and the other part; for lead counts past 65,535 and
    instant counts that are not a multiple of a tile's."""
    k = _spread_fb_constants()
    tile_i = k["kTileInstants"][dtype]
    threads, warp, span, rows, z = 2 * tile_i, 32, 16, 3 * 40 - 1, 40
    total = leads * n
    tiles = -(-total // tile_i)
    blocks = min(tiles, 132 * 3)
    walked = np.concatenate([np.arange(b, tiles, blocks)
                             for b in range(blocks)])
    assert np.array_equal(np.sort(walked), np.arange(tiles))
    # staging, copies of vec instants: thread t copies rows t // chunks,
    # + stride, ... at instants vec (t % chunks) ..
    for vec in ((1, 2, 4) if dtype == torch.float32 else (1, 2)):
        chunks = tile_i // vec
        stride = threads // chunks
        slots = np.array([
            r * tile_i + (r >= z) * k["kRowShift"] + t % chunks * vec + e
            for t in range(threads) for r in range(t // chunks, rows, stride)
            for e in range(vec)])
        assert len(slots) == len(set(slots)) == rows * tile_i, vec
        assert slots.max() < rows * tile_i + k["kRowShift"]
    # compute: warp w, lane l -> instant 16 w + l % 16, part l // 16
    tid = np.arange(threads)
    lane = tid % warp
    instant = tid // warp * span + lane % span
    part = lane // span
    partner = tid // warp * warp + (lane ^ span)
    assert np.all(instant[partner] == instant)
    assert np.all(part[partner] == 1 - part)
    g = (np.arange(tiles)[:, None] * tile_i + instant[None, :]).ravel()
    part = np.tile(part, tiles)
    live = g < total
    stores = np.zeros((total, z), np.int64)
    for c in range(z):
        np.add.at(stores[:, c], g[live & (part == c % 2)], 1)
    assert np.all(stores == 1)


def test_linear_recurrence_complex_matches_jax():
    rng = np.random.default_rng(17)
    lam = complex(0.9989, 0.0021)
    b = rng.standard_normal((3, 5000)) + 1j * rng.standard_normal((3, 5000))
    y0 = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    want = jax.jit(JIIR.linear_recurrence_blocked, static_argnums=0)(
        lam, jnp.asarray(b), y0=jnp.asarray(y0))
    got = iir.linear_recurrence(lam, tt(b), axis=-1, y0=tt(y0))
    assert got.dtype == torch.complex128
    assert rel(got, want) < 1e-12


def test_filter_bank_matches_jax(params):
    rng = np.random.default_rng(19)
    hp2 = rng.standard_normal((2, 192 * 20))
    want_re, want_im = JFB.filter_bank_t(JFB.build_consts(params),
                                         jnp.asarray(hp2))
    got_re, got_im = FB.filter_bank(FB.build_consts(params), tt(hp2))
    assert got_re.shape == (2, 40, 120)
    assert rel(got_re, want_re) < 1e-12
    assert rel(got_im, want_im) < 1e-12


@pytest.mark.parametrize("swap_slope", [False, True])
def test_process_signal_matches_jax_and_spec(params, swap_slope):
    """The whole FB ear model in float64, with leading silence, against JAX
    FB.process_signal (< 1e-10) and numpy_ref.fb_process_signal (< 1e-7,
    test_jax_pipeline.py's bar)."""
    rng = np.random.default_rng(3)
    n_frames = 40
    x = (rng.standard_normal((2, 192 * n_frames)) * 0.3).astype(np.float32)
    x[:, :2000] = 0.0
    jk = JFB.build_consts(params, swap_slope=swap_slope)
    want = jax.jit(JFB.process_signal, static_argnames="n_frames")(
        jk, jnp.asarray(x, jnp.float64), n_frames=n_frames)
    k = FB.build_consts(params, swap_slope=swap_slope)
    got = FB.process_signal(k, tt(x), n_frames)
    for g, w in zip(got, want):
        assert g.shape == (2, 40, n_frames)
        assert rel(g, w) < 1e-10
    for c in range(2):
        spec = R.fb_process_signal(params, x[c], swap_slope=swap_slope)
        for g, w in zip(got, spec):
            assert np.max(np.abs(g[c].numpy().T - w) / np.abs(w)) < 1e-7


def test_fb_loudness_golden(params):
    """test_jax_pipeline.py::test_fb_loudness_golden through the port: a
    1 kHz sine at 40 dB SPL reads loudness 1.03..1.04 in its last frame."""
    k = FB.build_consts(params)
    scale = 10 ** ((40 - 92) / 20)
    sig = scale * np.sin(2 * np.pi * 1000 / 48000 * np.arange(250 * 192))
    exc, _ = FB.process_signal(k, tt(sig), 250)
    loud = float(FE.loudness(k, exc[..., -1]))
    assert 1.03 < loud < 1.04


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("swap_slope", [False, True])
def test_fb_consts_from_jax_equal_native(params, dtype, swap_slope):
    jk = JFB.build_consts(params, dtype=dtype, swap_slope=swap_slope)
    leaves = {f: np.asarray(getattr(jk, f)) for f in (
        "h_phase", "back_mask", "back_mask_w", "internal_noise", "ear_a",
        "adapt_a", "fc", "lower_matrix", "level_factor", "threshold",
        "excitation_threshold", "loudness_factor")}
    got = convert.fb_consts_from_jax(leaves, swap_slope)
    want = FB.build_consts(params, getattr(torch, np.dtype(dtype).name),
                           swap_slope=swap_slope)
    assert got.band_count == want.band_count == jk.band_count
    assert got.slope_a == want.slope_a and got.level == want.level
    for name in FB.CONST_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    np.testing.assert_array_equal(got.back_mask_w.numpy(),
                                  np.asarray(jk.back_mask_w))


def test_fft_spread_ref_only_matches_jax():
    """stateless_pair_hop(spread_ref_only=True) on the advanced FFT ear
    (55 bands): the reference's unsmeared excitation alone."""
    rng = np.random.default_rng(29)
    params = EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT)
    ref = rng.standard_normal((2, 9, 1024)) * 0.3
    test = ref + 0.01 * rng.standard_normal((2, 9, 1024))
    jk = JFE.build_consts(params, truncate_spectrum=True)
    want = jax.jit(JFE.stateless_pair_hop, static_argnames="spread_ref_only")(
        jk, jnp.asarray(ref), jnp.asarray(test), spread_ref_only=True)
    got = FE.stateless_pair_hop(FE.build_consts(params), tt(ref), tt(test),
                                spread_ref_only=True)
    assert got[1].shape == (2, 8, C.ADVANCED_FFT_BAND_COUNT)
    assert rel(got[1], want[1]) < 1e-9
    full = FE.stateless_pair_hop(FE.build_consts(params), tt(ref), tt(test))
    np.testing.assert_array_equal(full[1][0], got[1])


def test_cpu_tensors_take_the_plain_versions(monkeypatch, params):
    """A CPU tensor runs D1-D3's plain versions and launches nothing."""
    monkeypatch.setattr(cuda_fb, "slope_state_launches", 0)
    monkeypatch.setattr(cuda_fb, "spread_fb_launches", 0)
    monkeypatch.setattr(cuda_dc, "dc_chain_launches", 0)
    rng = np.random.default_rng(2)
    k = FB.build_consts(params)
    re, im = (tt(v) for v in fb_inputs(rng, (2, 40, 50), 1.0))
    c1 = 24.0 + 230.0 / k.fc
    cu = cuda_fb.slope_state(re, im, c1, k.slope_a)
    np.testing.assert_array_equal(
        cu, cuda_fb.slope_state_plain(re, im, c1, k.slope_a))
    # the plain versions hand on contiguous tensors, as the kernels do
    assert cu.is_contiguous()
    assert cuda_dc.dc_chain_plain(tt(np.ones((2, 9))), LF)[0].is_contiguous()
    # D2 takes the lower table by its ratio CL, whose float64 powers are
    # the table's
    np.testing.assert_array_equal(
        cuda_fb.spread_fb(re, im, cu, k.cl),
        cuda_fb.spread_fb_plain(re, im, cu, k.lower_matrix))
    x = tt(rng.standard_normal((2, 500)))
    np.testing.assert_array_equal(cuda_dc.dc_chain(x, LF)[0],
                                  cuda_dc.dc_chain_plain(x, LF)[0])
    assert (cuda_fb.slope_state_launches, cuda_fb.spread_fb_launches,
            cuda_dc.dc_chain_launches) == (0, 0, 0)


def test_other_devices_raise_without_fallback():
    """A tensor on neither the CPU nor a CUDA card is refused before any
    build."""
    fb = torch.ones(2, 40, 8, device="meta")
    z = torch.ones(40, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fb.slope_state(fb, fb, z, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fb.spread_fb(fb, fb, fb, 0.08)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dc.dc_chain(torch.ones(2, 64, device="meta"), LF)
