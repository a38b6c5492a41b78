"""The port's kernels K1-K3 against the JAX package, on the CPU.

On a CPU tensor each kernel wrapper of gstpeaq_tpu_torch runs its plain
PyTorch version.  Here that version is held against the Pallas kernel it
stands for, run in interpret mode, in float32 (max|d|/max|ref| < 1e-5, and
elementwise < 1e-4 for the spreading: the bars of test_pallas_kernels.py),
and against the JAX XLA path in float64 (< 1e-12: the two differ only in
summation order).  The CUDA kernels themselves are held against the plain
versions on the card by chip_smoke.py; here their designs (K1's and K2's
one block per row, K3's warp per row) are re-enacted on the host in
float64 and held against the plain versions at their edges.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import earparams as EP
from gstpeaq_tpu.models import level_adapt as JLA
from gstpeaq_tpu.ops import fft_ear as JFE
from gstpeaq_tpu.ops import iir as JIIR
from gstpeaq_tpu.ops import pallas_iir
from gstpeaq_tpu.ops import pallas_spread_fft
from gstpeaq_tpu_torch.models import level_adapt as LA
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_iir
from gstpeaq_tpu_torch.ops import cuda_spread_fft
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.ops import iir
from gstpeaq_tpu_torch.ops import tile_scan

SCALE = 48000 / 1024


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def tt(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def smoothing_coeffs(rng, z, dtype):
    return np.exp(-rng.uniform(0.01, 0.5, z)).astype(dtype)


@pytest.mark.parametrize("f", [1, 37, 300])
@pytest.mark.parametrize("with_y0", [False, True])
def test_recurrence_plain_matches_pallas(f, with_y0):
    rng = np.random.default_rng(f)
    z = 109
    a = smoothing_coeffs(rng, z, np.float32)
    b = rng.standard_normal((2, 2, z, f)).astype(np.float32)
    y0 = (rng.standard_normal((2, 2, z)).astype(np.float32)
          if with_y0 else None)
    want = pallas_iir.recurrence_banded(
        jnp.asarray(a), jnp.asarray(b),
        y0=None if y0 is None else jnp.asarray(y0), interpret=True)
    got = cuda_iir.recurrence_banded(tt(a), tt(b), tt(y0))
    assert got.dtype == torch.float32
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("with_y0", [False, True])
def test_recurrence_plain_matches_xla_f64(with_y0):
    """Both layouts of the dispatcher: [..., Z, F] with axis=-1 and
    [F, ..., Z] with axis=0."""
    rng = np.random.default_rng(3)
    z, f = 55, 200
    a = smoothing_coeffs(rng, z, np.float64)
    b = rng.standard_normal((3, z, f))
    y0 = rng.standard_normal((3, z)) if with_y0 else None
    recurrence = jax.jit(JIIR.linear_recurrence_banded,
                         static_argnames=("axis", "block"))
    want = recurrence(jnp.asarray(a), jnp.asarray(b), axis=-1,
                      y0=None if y0 is None else jnp.asarray(y0))
    got = iir.linear_recurrence_banded(tt(a), tt(b), axis=-1, y0=tt(y0))
    assert got.dtype == torch.float64
    assert rel(got, want) < 1e-12
    bt = np.ascontiguousarray(np.moveaxis(b, -1, 0))      # [F, 3, Z]
    want = recurrence(jnp.asarray(a), jnp.asarray(bt), axis=0,
                      y0=None if y0 is None else jnp.asarray(y0))
    got = iir.linear_recurrence_banded(tt(a), tt(bt), axis=0, y0=tt(y0))
    assert rel(got, want) < 1e-12


def test_fused_mod_plain_matches_pallas():
    rng = np.random.default_rng(5)
    z, f = 109, 150
    a = smoothing_coeffs(rng, z, np.float32)
    exc2 = rng.uniform(0.01, 10.0, (2, 2, z, f)).astype(np.float32)
    uns2 = rng.uniform(0.01, 10.0, (2, 2, z, f)).astype(np.float32)
    want = pallas_iir.fused_mod_smoothers(
        jnp.asarray(a), jnp.asarray(exc2), jnp.asarray(uns2), SCALE,
        interpret=True)
    got = cuda_iir.fused_mod_smoothers(tt(a), tt(exc2), tt(uns2), SCALE)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel(g, w) < 1e-5


def test_fused_mod_plain_matches_xla_f64(monkeypatch):
    """level_adapt_fused_mod: K2's three outputs (exc_filt through the
    adapted excitations) and the two K1 calls of adapt_stage2, against the
    JAX XLA form."""
    monkeypatch.setattr(JIIR, "USE_PALLAS", False)
    rng = np.random.default_rng(9)
    z, f = 109, 120
    a = smoothing_coeffs(rng, z, np.float64)
    exc2 = rng.uniform(0.01, 10.0, (2, 2, z, f))
    uns2 = rng.uniform(0.01, 10.0, (2, 2, z, f))
    avg = LA.sliding_average_matrix(z)
    np.testing.assert_array_equal(avg, JLA.sliding_average_matrix(z))
    want = jax.jit(JLA.level_adapt_fused_mod, static_argnames="step_size")(
        jnp.asarray(a), jnp.asarray(avg), jnp.asarray(exc2),
        jnp.asarray(uns2), step_size=1024)
    got = LA.level_adapt_fused_mod(tt(a), tt(avg), tt(exc2), tt(uns2), 1024)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert rel(g, w) < 1e-12


RUN, LANES = cuda_iir.RUN, cuda_iir.LANES
# K1's and K2's tile edges: one frame; below, at and past one warp's 32
# runs and its 256 frames; below, at and past the largest tile; two of
# those tiles plus one
ROW_EDGES = [1, 31, 32, 33, 255, 256, 257, cuda_iir.MAX_TILE - 1,
             cuda_iir.MAX_TILE, cuda_iir.MAX_TILE + 1,
             2 * cuda_iir.MAX_TILE + 1]


def _row_powers(a):
    """csrc/recurrence.cu's row_powers on the host: a^(RUN 2^e), e < 5, and
    a^(RUN LANES), by repeated squaring in float64."""
    s = np.asarray(a, np.float64) ** 2
    s = s * s
    s = s * s
    run = []
    for _ in range(5):
        run.append(s)
        s = s * s
    return run, s


def _warp_scan_rows(x, steps):
    """warp_scan.cuh's warp scan along the last axis (lanes), with one
    factor per row (the first axis) at each step."""
    for e, f in enumerate(steps):
        off = 1 << e
        f = f.reshape(f.shape + (1,) * (x.ndim - 1))
        x = np.concatenate([x[..., :off], x[..., off:] + f * x[..., :-off]],
                           -1)
    return x


def _rows_on_host(a, v, y0):
    """csrc/recurrence.cu's block on the host in float64: rows of drives v
    [rows, F], one coefficient a and entry y0 per row.  Per tile of RUN *
    block_threads(F) frames: each run of RUN scanned from a zero entry, a
    warp scan over the runs, the warp ends folded in order from the tile's
    entry, the scan again with the warp's entry in lane 0, each run from its
    entry; the last run's last state enters the next tile."""
    rows, f = v.shape
    warps = cuda_iir.block_threads(f) // LANES
    tile = warps * LANES * RUN
    tiles = -(-f // tile)
    run, warp = _row_powers(a)
    col = a[:, None]
    drive = np.zeros((rows, tiles * tile))
    drive[:, :f] = v
    y = np.zeros_like(drive)
    entry = np.asarray(y0, np.float64)
    for t in range(tiles):
        vt = drive[:, t * tile:(t + 1) * tile].reshape(rows, warps, LANES, RUN)
        end = np.zeros((rows, warps, LANES))
        for j in range(RUN):
            end = a[:, None, None] * end + vt[..., j]
        scanned = _warp_scan_rows(end, run)
        yt = np.zeros_like(vt)
        x = entry
        for w in range(warps):
            lane0 = end[:, w].copy()
            lane0[:, 0] += run[0] * x
            s_in = _warp_scan_rows(lane0, run)
            yr = np.concatenate([x[:, None], s_in[:, :-1]], -1)
            for j in range(RUN):
                yr = col * yr + vt[:, w, :, j]
                yt[:, w, :, j] = yr
            x = warp * x + scanned[:, w, -1]
        y[:, t * tile:(t + 1) * tile] = yt.reshape(rows, tile)
        entry = yt[:, -1, -1, -1]
    return y[:, :f]


def _mod_drives_on_host(a, exc, uns, scale):
    """K2's three drives as csrc/recurrence.cu stages them, [3, rows, F]:
    per tile, loud = uns^0.3 (0 past the row); loud_{t-1} of a run's first
    frame is the frame before it in the tile, or, for the tile's first run,
    the previous tile's last loud (0 for the row's first tile)."""
    rows, f = exc.shape
    nt = cuda_iir.block_threads(f)
    tile = nt * RUN
    oma = 1.0 - a[:, None]
    drives = np.zeros((3, rows, f))
    last = np.zeros(rows)
    for t0 in range(0, f, tile):
        m = min(f - t0, tile)
        loud = np.zeros((rows, tile))
        loud[:, :m] = uns[:, t0:t0 + m] ** 0.3
        runs = loud.reshape(rows, nt, RUN)
        first = np.concatenate([last[:, None], runs[:, :-1, -1]], 1)
        prev = np.concatenate([first[..., None], runs[..., :-1]], -1)
        deriv = scale * np.abs(loud - prev.reshape(rows, tile))
        drives[0, :, t0:t0 + m] = oma * exc[:, t0:t0 + m]
        drives[1, :, t0:t0 + m] = oma * deriv[:, :m]
        drives[2, :, t0:t0 + m] = oma * loud[:, :m]
        last = loud[:, -1]
    return drives


@pytest.mark.parametrize("f", ROW_EDGES)
@pytest.mark.parametrize("with_y0", [False, True])
def test_recurrence_rows_scan_as_the_kernel_does(f, with_y0):
    """K1's one-block-per-row plan (runs, warp scan, warp fold, the tile
    walk with its carried state, y0) on the host equals the plain version
    to 1e-12 in float64 at every tile edge."""
    rng = np.random.default_rng(f + 100 * with_y0)
    a = smoothing_coeffs(rng, 3, np.float64)
    b = rng.standard_normal((1, 3, f))
    y0 = rng.standard_normal((1, 3)) if with_y0 else np.zeros((1, 3))
    got = _rows_on_host(a, b[0], y0[0])
    want = cuda_iir.recurrence_banded_plain(
        tt(a), tt(b), tt(y0) if with_y0 else None).numpy()[0]
    assert np.isfinite(got).all()
    assert rel(got, want) < 1e-12


@pytest.mark.parametrize("f", ROW_EDGES)
def test_fused_mod_rows_scan_as_the_kernel_does(f):
    """K2's plan on the host (the drives built from the staged tiles with
    loud_{t-1} across runs, warps and tiles, then K1's block scan of each)
    equals the plain version to 1e-12 in float64 at every tile edge, with
    uns jumping 1000-fold at every run edge, so that a wrong loud_{t-1}
    shows in mod."""
    rng = np.random.default_rng(f + 7)
    a = smoothing_coeffs(rng, 3, np.float64)
    exc2 = rng.uniform(0.01, 10.0, (1, 3, f))
    uns2 = rng.uniform(0.01, 10.0, (1, 3, f))
    uns2[..., np.arange(f) // RUN % 2 == 1] *= 1000.0
    drives = _mod_drives_on_host(a, exc2[0], uns2[0], SCALE)
    exc_filt, filt_deriv, filt_loud = (_rows_on_host(a, d, np.zeros(3))
                                       for d in drives)
    got = (exc_filt, filt_deriv / (1.0 + filt_loud / 0.3), filt_loud)
    want = cuda_iir.fused_mod_smoothers_plain(tt(a), tt(exc2), tt(uns2),
                                              SCALE)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert rel(g, w.numpy()[0]) < 1e-12


def test_recurrence_plan_constants_are_the_kernels():
    """cuda_iir's plan constants and block_threads are recurrence.cu's: runs
    of tile_scan.cuh's kRun, at most kMaxWarps warps a block, and a block
    of the fewest warps that covers a row (a row past MAX_TILE frames is
    walked in tiles of MAX_TILE)."""
    src = (_build.CSRC / "recurrence.cu").read_text()
    assert '#include "tile_scan.cuh"' in src and "using peaq::kRun;" in src
    assert cuda_iir.RUN == tile_scan.RUN and cuda_iir.LANES == tile_scan.LANES
    assert f"constexpr int kMaxWarps = {cuda_iir.MAX_WARPS};" in src
    assert "constexpr int kMaxThreads = kMaxWarps * kWarp;" in src
    assert "constexpr int kMaxTile = kRun * kMaxThreads;" in src
    assert ("const long long warps = (f + kRun * kWarp - 1) / (kRun * kWarp);"
            in src)
    assert cuda_iir.MAX_TILE == RUN * LANES * cuda_iir.MAX_WARPS == 2560
    for f in ROW_EDGES + [468, 2500, 10**6]:
        threads = cuda_iir.block_threads(f)
        assert threads % LANES == 0
        assert LANES <= threads <= LANES * cuda_iir.MAX_WARPS
        if f <= cuda_iir.MAX_TILE:
            assert (threads - LANES) * RUN < f <= threads * RUN
        else:
            assert threads * RUN == cuda_iir.MAX_TILE
    assert [cuda_iir.block_threads(f) for f in (468, 2500)] == [64, 320]


@pytest.mark.parametrize("band_count", [109, 55])
def test_spread_plain_matches_pallas(band_count):
    rng = np.random.default_rng(band_count)
    params = EP.fft_ear_params(band_count)
    jk = JFE.build_consts(params, dtype=jnp.float32)
    k = FE.build_consts(params, torch.float32)
    pp = rng.uniform(1e-6, 1e4, (2, 2, 37, band_count)).astype(np.float32)
    want = np.asarray(pallas_spread_fft.spread_fft(
        jnp.asarray(pp), jk.a_uc_log, jk.g_il, jk.lower_matrix,
        jk.spread_norm, 0.2 * float(np.asarray(jk.delta_z)),
        interpret=True))
    got = FE.spread(k, tt(pp))
    assert got.dtype == torch.float32
    assert rel(got, want) < 1e-5
    assert (np.abs(got.numpy() - want) / np.abs(want)).max() < 1e-4


@pytest.mark.parametrize("band_count", [109, 55])
def test_spread_plain_matches_xla_f64(band_count):
    rng = np.random.default_rng(band_count + 1)
    params = EP.fft_ear_params(band_count)
    jk = JFE.build_consts(params, dtype=jnp.float64)
    k = FE.build_consts(params, torch.float64)
    pp = 10.0 ** rng.uniform(-3, 9, (2, 2, 40, band_count))
    want = np.asarray(jax.jit(JFE.spread)(jk, jnp.asarray(pp)))
    got = cuda_spread_fft.spread_fft_plain(
        tt(pp), k.a_uc, k.g_il, k.lower_matrix, k.spread_norm, k.dz02)
    assert got.dtype == torch.float64
    assert rel(got, want) < 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spread_lower_matrix_is_the_power_table(dtype):
    """For every band count the pipelines run (55..109), the plain
    version's lower table is exactly aLe^(i-j) (i >= j) in the working
    dtype, and FFTEarConsts.a_le, which K3's wrapper takes in place of the
    table, is aLe in that dtype: the kernel's recurrence and the plain
    product are one function.  The table the wrapper forms from a_le on
    the CPU is that table, bit for bit in float64, and within the rounding
    of aLe to float32 (1e-5 relative, for powers up to 108) in float32."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    for bc in range(55, 110):
        params = EP.fft_ear_params(bc)
        a_le = params.lower_spreading_exponentiated
        k = FE.build_consts(params, dtype)
        i, j = np.indices((bc, bc))
        want = np.where(i >= j, a_le ** np.maximum(i - j, 0), 0.0)
        np.testing.assert_array_equal(k.lower_matrix.numpy(),
                                      want.astype(np_dtype))
        assert k.a_le == float(np_dtype(a_le))
        table = cuda_spread_fft.lower_table(bc, k.a_le, dtype, "cpu")
        assert table.dtype == dtype
        if dtype == torch.float64:
            assert torch.equal(table, k.lower_matrix)
        else:
            np.testing.assert_allclose(table.numpy(), k.lower_matrix.numpy(),
                                       rtol=1e-5, atol=1e-44)


def test_spread_lower_factors_are_float64_powers():
    """lower_factors: aLe, then (aLe^4)^(2^e) to 1e-15 relative, the
    backward warp scan's step over 4 bands a lane; read-only."""
    a_le = EP.fft_ear_params(109).lower_spreading_exponentiated
    f = cuda_spread_fft.lower_factors(a_le)
    want = np.float64(a_le) ** np.array([1, 4, 8, 16, 32, 64], np.float64)
    assert f.dtype == np.float64
    assert np.all(np.abs(f - want) <= 1e-15 * want)
    assert not f.flags.writeable


def _warp_scan_down(x, steps):
    """warp_scan.cuh's warp_scan_down on the host, along the last axis
    (lanes): x_l <- f x_{l+1} + x_l from lane 31 down."""
    for e, f in enumerate(steps):
        off = 1 << e
        x = np.concatenate([x[..., :-off] + f * x[..., off:], x[..., -off:]],
                           -1)
    return x


def _spread_on_host(p, a_uc, g_il, norm, dz02, a_le):
    """csrc/spread_fft.cu's K3 on the host in float64: 4 bands a lane of
    32 (bands past Z hold zeros), the powers in log form, the lower part as
    the lane's suffix, the backward warp scan and 4 steps from the lane's
    entry, the upper part as Z - 1 steps of the shift-multiply walk, where
    lane 0 takes in w = 0 and its own last rb."""
    z = p.shape[-1]
    lanes, per = cuda_spread_fft.LANES, cuda_spread_fft.BANDS_PER_LANE
    band = np.arange(z)
    ln_p = np.log(p)
    ln_auce = np.log(a_uc) + dz02 * ln_p
    g_iu = (1.0 - np.exp((z - band) * ln_auce)) / (1.0 - np.exp(ln_auce))
    pad = [(0, 0)] * (p.ndim - 1) + [(0, lanes * per - z)]
    ene = np.pad(np.exp(0.4 * (ln_p - np.log(g_il + g_iu - 1.0))), pad)
    rb = np.pad(np.exp(0.4 * ln_auce), pad)
    f = cuda_spread_fft.lower_factors(a_le)
    lane_ene = ene.reshape(*p.shape[:-1], lanes, per)
    s = lane_ene[..., per - 1]
    for b in range(per - 2, -1, -1):
        s = lane_ene[..., b] + f[0] * s
    scanned = _warp_scan_down(s, f[1:])
    entry = np.concatenate([scanned[..., 1:], np.zeros_like(s[..., :1])], -1)
    e2 = np.zeros_like(lane_ene)
    for b in range(per - 1, -1, -1):
        entry = e2[..., b] = lane_ene[..., b] + f[0] * entry
    e2 = e2.reshape(ene.shape)
    w = ene.copy()
    zero = np.zeros_like(w[..., :1])
    for _ in range(1, z):
        rb = np.concatenate([rb[..., per - 1:per], rb[..., :-1]], -1)
        w = np.concatenate([zero, w[..., :-1]], -1) * rb
        e2 = e2 + w
    e2 = e2[..., :z]
    return e2 * e2 * np.sqrt(e2) / norm


@pytest.mark.parametrize("band_count", [55, 109])
def test_spread_walk_and_lower_recurrence_match_plain(band_count):
    """K3's design reproduced on the host (4 bands a lane, the log-form
    powers, the shift-multiply walk, the backward lower recurrence) equals
    spread_fft_plain to 1e-12 in float64."""
    rng = np.random.default_rng(band_count + 7)
    k = FE.build_consts(EP.fft_ear_params(band_count), torch.float64)
    pp = 10.0 ** rng.uniform(-3, 9, (2, 3, 37, band_count))
    got = _spread_on_host(pp, k.a_uc.numpy(), k.g_il.numpy(),
                          k.spread_norm.numpy(), k.dz02, k.a_le)
    want = cuda_spread_fft.spread_fft_plain(
        tt(pp), k.a_uc, k.g_il, k.lower_matrix, k.spread_norm, k.dz02)
    assert rel(got, want) < 1e-12
    assert (np.abs(got - want.numpy()) / want.numpy()).max() < 1e-12


def test_spread_constants_are_the_kernels():
    """cuda_spread_fft's layout constants are spread_fft.cu's, and the
    kernel reads lower_factors' six float64 values."""
    src = (_build.CSRC / "spread_fft.cu").read_text()
    assert (f"constexpr int kBands = {cuda_spread_fft.BANDS_PER_LANE};"
            in src)
    assert "constexpr int kMaxBands = kBands * kWarp;" in src
    assert cuda_spread_fft.MAX_BANDS == 128
    assert "lo.step[e] = static_cast<T>(lower[e + 1]);" in src
    assert len(cuda_spread_fft.lower_factors(0.5)) == 6


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU tensor runs the plain version and launches nothing."""
    monkeypatch.setattr(cuda_iir, "recurrence_banded_launches", 0)
    monkeypatch.setattr(cuda_iir, "fused_mod_smoothers_launches", 0)
    monkeypatch.setattr(cuda_spread_fft, "spread_fft_launches", 0)
    rng = np.random.default_rng(2)
    a = tt(smoothing_coeffs(rng, 55, np.float64))
    b = tt(rng.uniform(0.1, 1.0, (2, 55, 8)))
    np.testing.assert_array_equal(
        cuda_iir.recurrence_banded(a, b),
        cuda_iir.recurrence_banded_plain(a, b))
    for g, w in zip(cuda_iir.fused_mod_smoothers(a, b, b, SCALE),
                    cuda_iir.fused_mod_smoothers_plain(a, b, b, SCALE)):
        np.testing.assert_array_equal(g, w)
    k = FE.build_consts(EP.fft_ear_params(55), torch.float64)
    p = b.transpose(-1, -2).contiguous()
    np.testing.assert_array_equal(
        cuda_spread_fft.spread_fft(p, k.a_uc, k.g_il, k.a_le, k.spread_norm,
                                   k.dz02),
        cuda_spread_fft.spread_fft_plain(p, k.a_uc, k.g_il, k.lower_matrix,
                                         k.spread_norm, k.dz02))
    assert (cuda_iir.recurrence_banded_launches,
            cuda_iir.fused_mod_smoothers_launches,
            cuda_spread_fft.spread_fft_launches) == (0, 0, 0)


def test_other_devices_raise_without_fallback():
    """A tensor on neither the CPU nor a CUDA card is refused before any
    build."""
    a = torch.ones(4, device="meta")
    b = torch.ones(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_iir.recurrence_banded(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_iir.fused_mod_smoothers(a, b, b, SCALE)
    z = torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_spread_fft.spread_fft(b.transpose(-1, -2).contiguous(), z, z,
                                   0.5, z, 0.1)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_is_keyed_by_the_sources():
    """The library's name hashes every .cu source and the flags; the flags
    target sm_90a and never fast math."""
    names = {p.name for p in _build.sources()}
    assert names == {"recurrence.cu", "spread_fft.cu", "fb_spread.cu",
                     "dc_chain.cu", "fir_bank.cu", "spectral.cu",
                     "gate.cu", "band.cu", "ehs.cu", "fb_mask.cu"}
    assert _build.library_path().name.startswith("libpeaq_kernels_")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast" in flag for flag in _build.NVCC_FLAGS)
    assert os.path.relpath(_build.BUILD_DIR, _build.PACKAGE) == "_build"


def test_build_is_keyed_by_the_headers(monkeypatch, tmp_path):
    """An edited csrc/*.cuh header names a new library, so a stale build is
    never loaded; every C entry of the sources has its signature."""
    assert {p.name for p in _build.headers()} == {"warp_scan.cuh",
                                                  "tile_scan.cuh"}
    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "warp_scan.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before
    text = "".join(src.read_text() for src in _build.sources())
    for name in _build.SIGNATURES:
        assert f"int {name}(" in text, name
