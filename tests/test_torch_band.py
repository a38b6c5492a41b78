"""L1 `levcorr`, L2 `pattern_adapt` and M1 `band_movs` (ops/cuda_band.py) on
the CPU, where the wrappers take their plain versions.

The plain versions are held against the JAX functions they stand for
(gstpeaq_tpu/models/level_adapt.py::adapt_stage2, models/movs.py::
modulation_difference, noise_loudness, nmr's band half, prob_detect, and
ops/fft_ear.py::loudness) at the package's 1e-12 in float64, and bit for
bit, in float32 and float64, against the composition they replaced: the
level adapter's eager lines and the pipelines' calls of movs.py, as they
stood before the kernels.  Inputs are made with numpy from a seed, at the
basic band count (109), the FB ear's (40) and another basic one (80).  The
identical pair's level correction is exactly 1; the advanced swap flag
swaps the noise loudness's inputs; L2's register window is re-enacted in
numpy from its source and gives band_average's bits; the kernels'
constants are the model's; M1's reformulations (where no decision reads
the value: l^4 as products, 0.5^tb as exp2, the quotients by s through
1 / s, the loudness's th e / et as e (th / et), one lead factor for the FB
site's last two noise loudness sets) hold within 1e-14 of the plain forms
on the inputs the 10 s pair gives M1; a CPU tensor takes the plain version
and any other device but CUDA raises; and every call site of the
pipelines, the batch and the streams goes through the wrappers, once per
call.
"""

import functools
import inspect
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import constants as JC
from gstpeaq_tpu import earparams as JEP
from gstpeaq_tpu.models import level_adapt as JLA
from gstpeaq_tpu.models import movs as JMOVS
from gstpeaq_tpu.ops import fb_ear as JFB
from gstpeaq_tpu.ops import fft_ear as JFE
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch import earparams as EP
from gstpeaq_tpu_torch.models import level_adapt as LA
from gstpeaq_tpu_torch.models import movs as MOVS
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_band
from gstpeaq_tpu_torch.ops import cuda_iir
from gstpeaq_tpu_torch.ops import exact
from gstpeaq_tpu_torch.ops import fb_ear as FB
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.ops import iir
from gstpeaq_tpu_torch.parallel import batch as PB
from gstpeaq_tpu_torch.parallel import stream as PS

BANDS = (109, 40, 80)
DTYPES = (torch.float32, torch.float64)
F = 37


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def tt(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


def consts(z: int, dtype=torch.float64):
    """The JAX and the port's constants of a z-band ear: the FB ear's at
    40, the FFT ear's otherwise."""
    if z == C.FB_BAND_COUNT:
        params = EP.fb_ear_params()
        return (JFB.build_consts(JEP.fb_ear_params()),
                FB.build_consts(params, dtype, "cpu"))
    return (JFE.build_consts(JEP.fft_ear_params(z)),
            FE.build_consts(EP.fft_ear_params(z), dtype, "cpu"))


def band_inputs(z: int, seed: int, dtype=torch.float64, lead=(2, 2)):
    """Excitations (ref, test) [2, *lead, z, F] with a louder test in one
    pair (lev_corr > 1 there, < 1 elsewhere), identical frames, stage-1
    smoothed excitations, modulations, an average loudness and NMR's
    noise per band [*lead, F, z], in `dtype`."""
    rng = np.random.default_rng(seed)
    shape = (*lead, z, F)
    exc = 10.0 ** rng.uniform(-1, 6, (2, *shape))
    exc[1] = exc[0] * 10.0 ** rng.uniform(-0.5, 0.5, shape)
    exc[1, 0] *= 3.0
    exc[1, ..., :4] = exc[0, ..., :4]                     # identical frames
    exc[1, ..., 6:9] = 10.0 ** rng.uniform(-3, -1, (*shape[:-1], 3))  # l < 0
    filt = exc * rng.uniform(0.5, 1.0, exc.shape)
    filt[1, ..., :4] = filt[0, ..., :4]
    mod = rng.uniform(0.0, 5.0, (2, *shape))
    mod[1, ..., 10:14] = mod[0, ..., 10:14]
    avg = rng.uniform(0.0, 50.0, shape)
    # NMR's noise about the masked threshold, so that some frames are
    # disturbed and some are not
    noise = (np.swapaxes(exc[0], -1, -2)
             * 10.0 ** (rng.uniform(-3.0, 0.3, (*lead, F, 1))
                        + rng.uniform(-1.0, 0.0, (*lead, F, z))))
    t = {name: tt(x, dtype) for name, x in (
        ("exc", exc), ("filt", filt), ("mod", mod), ("avg", avg),
        ("noise", noise))}
    return t


def old_adapt_stage2(a, avg_matrix, ref_excitation, test_excitation,
                     ref_filt, test_filt):
    """models/level_adapt.py::adapt_stage2 as it stood before L1 and L2
    (fresh state), the composition they replaced."""
    num = torch.sum(exact.sqrt(ref_filt * test_filt), dim=-2)
    den = torch.sum(test_filt, dim=-2)
    lev_corr = (num * num / (den * den))[..., None, :]
    louder_ref = lev_corr > 1.0
    levcorr_ref = torch.where(louder_ref, ref_excitation / lev_corr,
                              ref_excitation)
    levcorr_test = torch.where(louder_ref, test_excitation,
                               test_excitation * lev_corr)
    nd = iir.linear_recurrence_banded(
        a, torch.stack([levcorr_test * levcorr_ref,
                        levcorr_ref * levcorr_ref]), axis=-1)
    filt_num, filt_den = nd[0], nd[1]
    num_ge = filt_num >= filt_den
    pattadapt_ref = torch.where(num_ge, 1.0, filt_num / filt_den)
    pattadapt_test = torch.where(num_ge, filt_den / filt_num, 1.0)
    ra = LA.band_average(torch.stack([pattadapt_ref, pattadapt_test]),
                         avg_matrix)
    pc = iir.linear_recurrence_banded(a, (1.0 - a[:, None]) * ra, axis=-1)
    return levcorr_ref * pc[0], levcorr_test * pc[1]


def factors(k, z, t):
    """The adapter's factors of band_inputs' tensors (plain K1)."""
    avg = torch.as_tensor(LA.sliding_average_matrix(z), dtype=t["exc"].dtype)
    return LA.adapt_stage2_factors(k.adapt_a, avg, t["exc"], t["filt"])


def old_movs(k, site, t, adapted_ref, adapted_test, use_floor, swap):
    """The pipelines' MOV terms as they called movs.py and fft_ear.py before
    M1 (models/basic.py and models/advanced.py at the parent commit)."""
    exc, mod, noise = t["exc"], t["mod"], k.internal_noise
    out = {}
    if site == "basic":
        out["terms"] = (*MOVS.modulation_difference(
            noise, mod[0], mod[1], t["avg"], rms_mode=False, lev_wt=100.0),
            MOVS.noise_loudness(noise, 1.5, 0.15, 0.5, 0.0, mod[0], mod[1],
                                adapted_ref, adapted_test))
        out["loudness"] = FE.loudness(k, exc, axis=-2)
        out["nmr"] = MOVS.nmr_from_bands(k.masking_difference, t["noise"],
                                         exc[0].transpose(-1, -2))
        out["detect"] = MOVS.prob_detect(exc[0], exc[1], use_floor)
    else:
        md1, md2, tw = MOVS.modulation_difference(
            noise, mod[0], mod[1], t["avg"], rms_mode=True, lev_wt=1.0)
        asym = MOVS.noise_loudness(noise, 2.5, 0.3, 1.0, 0.1, mod[0], mod[1],
                                   adapted_ref, adapted_test)
        if swap:
            missing = MOVS.noise_loudness(noise, 1.5, 0.15, 1.0, 0.0, mod[1],
                                          mod[0], adapted_test, adapted_ref)
            lin = MOVS.noise_loudness(noise, 1.5, 0.15, 1.0, 0.0, mod[0],
                                      mod[0], adapted_ref, exc[0])
        else:
            missing = MOVS.noise_loudness(noise, 1.5, 0.15, 1.0, 0.0, mod[0],
                                          mod[1], adapted_test, adapted_ref)
            lin = MOVS.noise_loudness(noise, 1.5, 0.15, 1.0, 0.0, mod[0],
                                      mod[1], adapted_ref, exc[0])
        out["terms"] = (md1, md2, tw, asym, missing, lin)
        out["loudness"] = FE.loudness(k, exc, axis=-2)
    return out


def site_of(z: int) -> str:
    return "fb" if z == C.FB_BAND_COUNT else "basic"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("z", BANDS)
def test_levcorr_and_pattern_adapt_equal_the_old_adapter(z, dtype):
    """L1 and L2's plain versions, with K1's between them, give the old
    adapter's adapted excitations bit for bit; the drives are its."""
    _, k = consts(z, dtype)
    t = band_inputs(z, z, dtype)
    avg = torch.as_tensor(LA.sliding_average_matrix(z), dtype=dtype)
    want = old_adapt_stage2(k.adapt_a, avg, t["exc"][0], t["exc"][1],
                            t["filt"][0], t["filt"][1])
    got = LA.adapt_stage2(k.adapt_a, avg, t["exc"][0], t["exc"][1],
                          t["filt"][0], t["filt"][1])[:2]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(g, w)
    lev, drive = cuda_band.levcorr(t["exc"], t["filt"])
    assert lev.shape == (2, 2, F) and drive.shape == t["exc"].shape
    nd = cuda_iir.recurrence_banded_plain(k.adapt_a, drive)
    out = cuda_band.pattern_adapt(nd, k.adapt_a, avg)
    assert out.shape == nd.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("z", BANDS)
def test_adapter_matches_jax(z):
    """The port's adapter after stage 1 (L1, K1, L2, K1) against JAX's
    adapt_stage2 at 1e-12, and its carried state."""
    jk, k = consts(z)
    t = band_inputs(z, 10 + z)
    exc, filt = (t[n].numpy() for n in ("exc", "filt"))
    avg = LA.sliding_average_matrix(z)
    state2 = tuple(np.random.default_rng(z).uniform(0.1, 2.0, (4, 2, 2, z)))
    want = jit(JLA.adapt_stage2)(jk.adapt_a, jnp.asarray(avg),
                                 *map(jnp.asarray, (*exc, *filt)),
                                 tuple(map(jnp.asarray, state2)))
    got = LA.adapt_stage2(k.adapt_a, tt(avg), *map(tt, (*exc, *filt)),
                          tuple(map(tt, state2)))
    for g, w in zip(got[:2], want[:2]):
        assert rel(g, w) < 1e-12
    for g, w in zip(got[2], want[2]):
        assert rel(g, w) < 1e-12


@pytest.mark.parametrize("dtype", DTYPES)
def test_identical_pair_level_correction_is_one(dtype):
    """For ref = test, sqrt(fl(x x)) == x, so num == den and lev_corr is 1
    bit for bit; the drives' num and den are equal and the adapted
    excitations equal the excitations times pc."""
    t = band_inputs(C.BASIC_BAND_COUNT, 3, dtype)
    exc = torch.stack([t["exc"][0], t["exc"][0]])
    filt = torch.stack([t["filt"][0], t["filt"][0]])
    lev, drive = cuda_band.levcorr(exc, filt)
    assert torch.equal(lev, torch.ones_like(lev))
    assert torch.equal(drive[0], drive[1])
    pc = torch.ones_like(exc) * 0.5
    ar, at = cuda_band.adapted(exc, lev, pc)
    assert torch.equal(ar, at) and torch.equal(ar, exc[0] * 0.5)


@pytest.mark.parametrize("use_floor", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("z", BANDS)
def test_band_movs_equals_the_old_composition(z, dtype, use_floor):
    """M1's plain version at the basic site (109, 80 bands) and the FB site
    (40) gives the pipelines' old MOV terms bit for bit, its adapted
    excitations recomputed from the adapter's factors."""
    _, k = consts(z, dtype)
    t = band_inputs(z, 20 + z, dtype)
    site = site_of(z)
    lev, pc, _ = factors(k, z, t)
    ar, at = cuda_band.adapted(t["exc"], lev, pc)
    want = old_movs(k, site, t, ar, at, use_floor, swap=use_floor)
    got = cuda_band.band_movs(k, site, t["exc"], lev, pc, t["mod"],
                              t["avg"], t["noise"] if site == "basic"
                              else None, use_floor=use_floor,
                              swap=use_floor)
    assert got.terms.shape == (len(cuda_band.TERMS[site]), 2, 2, F)
    for name, parts in want.items():
        mine = getattr(got, name)
        assert mine.shape[0] == len(parts)
        for g, w in zip(mine, parts):
            assert g.dtype == dtype
            assert torch.equal(g, w.to(dtype)), name
    if site == "fb":
        assert got.nmr is None and got.detect is None
    else:
        assert got.detect.shape == (2, 2, F)
        # the disturbed flags take both values on these inputs
        assert 0 < int(got.nmr[1].sum()) < got.nmr[1].numel()


@pytest.mark.parametrize("z", BANDS)
def test_band_movs_matches_jax(z):
    """M1's plain terms against JAX's modulation_difference,
    noise_loudness, loudness and (basic) prob_detect at 1e-12."""
    jk, k = consts(z)
    t = band_inputs(z, 30 + z)
    site = site_of(z)
    lev, pc, _ = factors(k, z, t)
    ar, at = cuda_band.adapted(t["exc"], lev, pc)
    got = cuda_band.band_movs(k, site, t["exc"], lev, pc, t["mod"], t["avg"],
                              t["noise"] if site == "basic" else None)
    exc, mod, avg = (jnp.asarray(t[n].numpy()) for n in ("exc", "mod", "avg"))
    a_r, a_t = jnp.asarray(ar.numpy()), jnp.asarray(at.numpy())
    fb = site == "fb"
    md = jit(JMOVS.modulation_difference, "rms_mode", "lev_wt")(
        jk.internal_noise, mod[0], mod[1], avg, rms_mode=fb,
        lev_wt=1.0 if fb else 100.0)
    nl = jit(JMOVS.noise_loudness)
    if fb:
        nls = [nl(jk.internal_noise, 2.5, 0.3, 1.0, 0.1, mod[0], mod[1],
                  a_r, a_t),
               nl(jk.internal_noise, 1.5, 0.15, 1.0, 0.0, mod[0], mod[1],
                  a_t, a_r),
               nl(jk.internal_noise, 1.5, 0.15, 1.0, 0.0, mod[0], mod[1],
                  a_r, exc[0])]
    else:
        nls = [nl(jk.internal_noise, 1.5, 0.15, 0.5, 0.0, mod[0], mod[1],
                  a_r, a_t)]
    for g, w in zip(got.terms, (*md, *nls)):
        assert rel(g, w) < 1e-12
    loud = jit(JFE.loudness, "axis")(jk, exc, axis=-2)
    assert rel(got.loudness, loud) < 1e-12
    if not fb:
        want = jit(JMOVS.prob_detect, "use_floor")(exc[0], exc[1], False)
        for g, w in zip(got.detect, want):
            assert rel(g, w) < 1e-12


@pytest.mark.parametrize("z", [C.BASIC_BAND_COUNT,
                               C.ADVANCED_FFT_BAND_COUNT, 80])
def test_nmr_band_half_matches_jax(z):
    """M1's NMR (the basic site and the advanced FFT site, NMR alone) from
    the noise per band of the port's nmr_noise_bands against JAX's nmr on
    the same spectra, at 1e-12; the disturbed flags equal."""
    jk, k = consts(z)
    rng = np.random.default_rng(40 + z)
    hi = k.group_bin_hi
    shape = (2, F, hi)
    env = 10.0 ** (8.0 - 10.0 * np.arange(hi) / hi)
    ref = env * rng.uniform(0.1, 1.0, shape)
    test = ref * rng.uniform(0.3, 1.7, shape)
    exc = 10.0 ** rng.uniform(2, 7, (2, z, F))      # [CH, Z, F]
    want = jit(JMOVS.nmr)(jk.group_matrix[:hi], jk.masking_difference,
                          jnp.asarray(ref), jnp.asarray(test),
                          jnp.asarray(np.swapaxes(exc, -1, -2)),
                          delta_weighted=jnp.asarray(ref - test))
    noise = MOVS.nmr_noise_bands(k.group_matrix[:hi], tt(ref), tt(test),
                                 tt(ref - test))
    got = cuda_band.band_movs(k, "fft", tt(exc), noise=noise)
    assert got.terms is None and got.loudness is None
    assert rel(got.nmr[0], want[0]) < 1e-12
    np.testing.assert_array_equal(got.nmr[1], want[1])


@pytest.mark.parametrize("swap", [False, True])
def test_fb_swap_flag_swaps_the_inputs(swap):
    """The FB site's missing components and LinDist follow
    swap_mod_patts_for_noise_loudness_movs as the advanced pipeline did,
    and the two settings differ."""
    z = C.FB_BAND_COUNT
    _, k = consts(z)
    t = band_inputs(z, 50)
    lev, pc, _ = factors(k, z, t)
    ar, at = cuda_band.adapted(t["exc"], lev, pc)
    got = cuda_band.band_movs(k, "fb", t["exc"], lev, pc, t["mod"], t["avg"],
                              swap=swap)
    other = cuda_band.band_movs(k, "fb", t["exc"], lev, pc, t["mod"],
                                t["avg"], swap=not swap)
    want = old_movs(k, "fb", t, ar, at, False, swap)["terms"]
    for g, w in zip(got.terms, want):
        assert torch.equal(g, w)
    assert torch.equal(got.terms[3], other.terms[3])
    assert not torch.equal(got.terms[4:], other.terms[4:])


def window_walk(x: np.ndarray, z: int) -> np.ndarray:
    """csrc/band.cu's pattern_adapt_kernel walk in numpy, on x [z, F]:
    each of the block's band groups [g z / G, (g + 1) z / G) walks its
    bands with a register window of W = m1c + m2c + 1 slots, filled with
    bands lo - m1c .. lo + m2c (0 past the edges), summed slot by slot
    from slot 0, shifted down one slot a band with band k + 1 + m2c
    entering at slot W - 1."""
    src = band_source()
    groups = int(re.search(r"kGroups = (\d+);", src)[1])
    w_max = int(re.search(r"kMaxWindow = (\d+);", src)[1])
    m1c, m2c = z // 36, z // 25
    width = m1c + m2c + 1
    assert width <= w_max

    def value(b):
        return x[b] if 0 <= b < z else np.zeros_like(x[0])

    out = np.full_like(x, np.nan)
    for g in range(groups):
        lo, hi = g * z // groups, (g + 1) * z // groups
        win = [value(lo - m1c + s) for s in range(width)]
        for k in range(lo, hi):
            total = win[0]
            for s in range(1, width):
                total = total + win[s]
            out[k] = total
            win = win[1:] + [value(k + 1 - m1c + width - 1)]
    return out


def band_source() -> str:
    return (_build.CSRC / "band.cu").read_text()


@pytest.mark.parametrize("z", [109, 40, 55, 80, 5, 239])
def test_l2_window_walk_gives_band_average(z):
    """L2's window walk re-enacted in numpy gives band_average's sums bit
    for bit (before its diagonal), at every window width it takes."""
    rng = np.random.default_rng(z)
    x = rng.uniform(0.0, 2.0, (z, F))
    diag = np.ones((z, z))
    want = cuda_band.band_average(torch.from_numpy(x[None]),
                                  torch.from_numpy(diag))[0].numpy()
    np.testing.assert_array_equal(window_walk(x, z), want)


def test_kernel_constants_are_the_models():
    """csrc/band.cu's constants: the s(l) coefficients and the 1.5 dB
    factor of constants.py, the noise loudness sets the pipelines called,
    and M1's part bits the wrapper passes; every C entry is bound."""
    src = band_source()
    coeffs = [float(re.search(rf"kPdS{i} = ([0-9.e+-]+);", src)[1])
              for i in range(8)]
    assert tuple(coeffs) == C.PD_S_COEFFS == JC.PD_S_COEFFS
    assert float(re.search(r"kOnePointFiveDb = ([0-9.e+-]+);", src)[1]) \
        == C.ONE_POINT_FIVE_DB_POWER_FACTOR
    sets = {name: tuple(float(re.search(rf"k{name}{part} = ([0-9.]+)",
                                        src)[1])
                        for part in ("Alpha", "Thres", "S0", "Min"))
            for name in ("Basic", "Asym", "Miss")}
    assert sets == {"Basic": (1.5, 0.15, 0.5, 0.0),
                    "Asym": (2.5, 0.3, 1.0, 0.1),
                    "Miss": (1.5, 0.15, 1.0, 0.0)}
    for name, bit in (("ModBasic", cuda_band.MOD_BASIC),
                      ("ModFb", cuda_band.MOD_FB),
                      ("Loudness", cuda_band.LOUDNESS),
                      ("Nmr", cuda_band.NMR), ("Prob", cuda_band.PROB),
                      ("UseFloor", cuda_band.USE_FLOOR),
                      ("Swap", cuda_band.SWAP)):
        assert int(re.search(rf"k{name} = (\d+);", src)[1]) == bit
    assert re.search(r"kMaxBands = (\d+);", src)[1] == str(
        cuda_band.MAX_BANDS)
    # M1's tiles: the seven staged band inputs, taken from the C entry's
    # in[9] (exc_ref, exc_test, lev_corr, pc_ref, pc_test, mod_ref,
    # mod_test, avg_loud, noise) in MovsArgs::in's order; the per-band
    # constants the table holds; a ring of this band and the next, none
    # (kDirect) for NMR alone in float
    entry = ("exc_ref", "exc_test", "lev_corr", "pc_ref", "pc_test",
             "mod_ref", "mod_test", "avg_loud", "noise")
    ins = int(re.search(r"kIns = (\d+);", src)[1])
    order = [int(i) for i in re.search(
        r"const int order\[kIns\] = \{([0-9, ]+)\};", src)[1].split(",")]
    assert ins == len(order) == 7
    assert [entry[i] for i in order] == [
        "exc_ref", "exc_test", "pc_ref", "pc_test", "mod_ref", "mod_test",
        "avg_loud"]
    rows = {int(j or bool(z)) for j, z in re.findall(
        r"s_c\[(?:(\d) \* )?(z \+ )?b\]", src)}
    assert rows == set(range(int(re.search(r"kConsts = (\d+);", src)[1])))
    assert int(re.search(r"kStages = (\d+);", src)[1]) == 2
    assert int(re.search(r"kDirect = (\d+);", src)[1]) == 0
    assert "sizeof(T) == 4 ? kDirect : kStages" in src
    # the math probe's op codes and chains are the wrapper's
    for name, code in cuda_band.MATH_OPS.items():
        const = {"muladd": "MulAdd"}.get(name, name.capitalize())
        assert int(re.search(rf"kMath{const} = (\d+);", src)[1]) == code
    assert int(re.search(r"kChains = (\d+);", src)[1]) == \
        cuda_band.MATH_CHAINS
    for name in ("levcorr", "pattern_adapt", "band_movs", "band_math_rate"):
        for suffix in ("f32", "f64"):
            assert f"peaq_{name}_{suffix}" in _build.SIGNATURES
            assert f"int peaq_{name}_{suffix}(" in src
    assert _build.SOURCE_FLAGS["band.cu"] == ("-fmad=false",)


@functools.cache
def pair10_movs() -> dict:
    """M1's arguments at each site ("basic", "fft", "fb") by name, as the
    port's plain route gives them for chip_smoke's seeded 10 s pair in
    float64: one basic and one advanced peaq() on the CPU, band_movs
    captured."""
    root = str(_build.PACKAGE.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    seen = {}
    real = cuda_band.band_movs
    signature = inspect.signature(cuda_band.band_movs_plain)

    def capture(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        seen.setdefault(bound.arguments["site"], dict(bound.arguments))
        return real(*args, **kwargs)
    cuda_band.band_movs = capture
    try:
        for advanced in (False, True):
            api.peaq(*chip_smoke.ten_second_pair(), advanced=advanced,
                     device="cpu")
    finally:
        cuda_band.band_movs = real
    return seen


def rel_each(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / |want| over the elements, exact zeros equal."""
    assert got.shape == want.shape
    zero = want == 0
    assert torch.equal(got[zero], want[zero])
    return ((got - want)[~zero] / want[~zero]).abs().max().item()


def fb_leads(arguments: dict, swap: bool) -> list:
    """The lead factors (noise / s_test)^0.23 of the FB site's three noise
    loudness sets, as band_movs_plain forms them (noise_loudness spied)."""
    leads = []
    real = MOVS.noise_loudness

    def spy(noise, alpha, thres_fac, s0, nl_min, mod_ref, mod_test, e_ref,
            e_test):
        leads.append((noise[:, None] / (thres_fac * mod_test + s0)) ** 0.23)
        return real(noise, alpha, thres_fac, s0, nl_min, mod_ref, mod_test,
                    e_ref, e_test)
    MOVS.noise_loudness = spy
    try:
        cuda_band.band_movs_plain(**{**arguments, "swap": swap})
    finally:
        MOVS.noise_loudness = real
    return leads


REFORMS = [("basic", "loudness"), ("basic", "l4"), ("basic", "exp2"),
           ("basic", "one_over_s"), ("fb", "loudness"), ("fb", "lead")]


@pytest.mark.parametrize("site, form", REFORMS)
def test_m1_reformulations_hold_on_the_pairs_inputs(site, form):
    """Each value csrc/band.cu forms with less work than the plain version
    (where no decision reads it), on the float64 inputs the plain route
    gives M1 for the 10 s pair, within 1e-14 of the plain form: the
    loudness's (th e) / et as e (th / et); s(l)'s l^4 as (l l)(l l); 0.5^tb
    as exp2(-tb) (relative where it is a normal number; below that both
    give 1 - 0.5^tb = 1); e / s and |trunc(e)| / s as products with 1 / s.
    The decisions that read the log10 (l > 0, trunc and floor of e) take
    the kernel's l bit for bit.  The FB site's missing-components and
    LinDist sets have one lead factor, bit for bit, under both swap flags:
    the kernel's, (noise / (0.15 x + 1))^0.23 with x the test's modulation,
    or the reference's where swapped."""
    arguments = pair10_movs()[site]
    k, exc = arguments["k"], arguments["exc"]
    assert exc.dtype == torch.float64
    if form == "loudness":
        th = k.threshold[:, None]
        et = k.excitation_threshold[:, None]
        for e in exc:
            assert rel_each(e * (th / et), th * e / et) < 1e-14
        return
    if form == "lead":
        mod_ref, mod_test = arguments["mod2"]
        noise = k.internal_noise[:, None]
        for swap in (False, True):
            _, missing, lin_dist = fb_leads(arguments, swap)
            assert torch.equal(missing, lin_dist)
            x = mod_ref if swap else mod_test
            assert torch.equal(missing, (noise / (0.15 * x + 1.0)) ** 0.23)
        return
    eref_db = 10.0 * exact.log10(exc[0])
    etest_db = 10.0 * exact.log10(exc[1])
    l_plain = 0.3 * torch.maximum(eref_db, etest_db) + 0.7 * etest_db
    l_kernel = (0.3 * torch.where(eref_db > etest_db, eref_db, etest_db)
                + 0.7 * etest_db)
    assert torch.equal(l_plain, l_kernel)
    audible = l_plain > 0.0
    assert audible.any()
    ls = torch.where(audible, l_plain, 1.0)
    e = eref_db - etest_db
    cs = C.PD_S_COEFFS

    def s_of(l4):
        return torch.where(audible, cs[0] * (cs[1] / ls) ** cs[2]
                           + cs[3] * l4 + cs[4] * ls ** 3
                           - cs[5] * ls * ls + cs[6] * ls - cs[7], 1e30)
    s = s_of(ls ** 4)
    if form == "l4":
        l2 = ls * ls
        assert rel_each(l2 * l2, ls ** 4) < 1e-14
        assert rel_each(s_of(l2 * l2), s) < 1e-14
        assert torch.equal(l2 * ls, ls * ls * ls)
    elif form == "exp2":
        t = e / s
        t4 = (t * t) * (t * t)
        tb = torch.where(eref_db > etest_db, t4, t4 * (t * t))
        plain, reform = 0.5 ** tb, torch.exp2(-tb)
        normal = plain >= torch.finfo(torch.float64).tiny
        assert normal.any()
        assert rel_each(reform[normal], plain[normal]) < 1e-14
        for x in (plain, reform):
            assert torch.equal(1.0 - x[~normal],
                               torch.ones_like(x[~normal]))
    else:
        rs = 1.0 / s
        assert rel_each(e * rs, e / s) < 1e-14
        for use_floor in (False, True):
            whole = (torch.floor(e) if use_floor else torch.trunc(e)).abs()
            assert rel_each(whole * rs, whole / s) < 1e-14


def test_cpu_tensors_take_the_plain_versions_and_others_raise(monkeypatch):
    """A CPU tensor runs the plain versions without nvcc and launches
    nothing; a tensor on another device than CUDA raises."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    z = C.BASIC_BAND_COUNT
    _, k = consts(z)
    t = band_inputs(z, 60)
    before = (cuda_band.levcorr_launches, cuda_band.pattern_adapt_launches,
              cuda_band.band_movs_launches)
    lev, pc, _ = factors(k, z, t)
    cuda_band.band_movs(k, "basic", t["exc"], lev, pc, t["mod"], t["avg"],
                        t["noise"])
    assert before == (cuda_band.levcorr_launches,
                      cuda_band.pattern_adapt_launches,
                      cuda_band.band_movs_launches)
    meta = {name: x.to("meta") for name, x in t.items()}
    with pytest.raises(ValueError, match="CUDA"):
        cuda_band.levcorr(meta["exc"], meta["filt"])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_band.pattern_adapt(meta["filt"], k.adapt_a.to("meta"),
                                torch.zeros((z, z), device="meta"))
    km = types.SimpleNamespace(**{
        name: getattr(k, name).to("meta") for name in (
            "internal_noise", "loudness_factor", "threshold",
            "excitation_threshold", "masking_difference")})
    with pytest.raises(ValueError, match="CUDA"):
        cuda_band.band_movs(km, "basic", meta["exc"], lev.to("meta"),
                            pc.to("meta"), meta["mod"], meta["avg"],
                            meta["noise"])
    with pytest.raises(ValueError, match="expected"):
        cuda_band.band_movs(km, "basic", meta["exc"], lev.to("meta"),
                            pc.to("meta"), meta["mod"], meta["avg"], None)


def spy(monkeypatch) -> list:
    """Record each wrapper call: (name, band_movs' site)."""
    calls = []
    for name in ("levcorr", "pattern_adapt", "band_movs"):
        fn = getattr(cuda_band, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, args[1] if _name == "band_movs" else ""))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(cuda_band, name, wrapped)
    return calls


BASIC_CALL = [("levcorr", ""), ("pattern_adapt", ""), ("band_movs", "basic")]
ADVANCED_CALL = [("band_movs", "fft"), ("levcorr", ""),
                 ("pattern_adapt", ""), ("band_movs", "fb")]


def test_every_site_calls_the_wrappers(monkeypatch):
    """peaq() and peaq_batch() (one microbatch) go through L1, L2 and M1
    once per site: basic L1, L2, M1; advanced M1 (FFT NMR), L1, L2, M1
    (FB); and so do the chunk steps: basic L1, L2, M1; advanced FFT M1;
    advanced FB L1, L2, M1."""
    calls = spy(monkeypatch)
    rng = np.random.default_rng(70)
    n = 40 * 1024
    ref = (rng.standard_normal((n, 2)) * 0.1).astype(np.float32)
    test = ref + (rng.standard_normal((n, 2)) * 0.01).astype(np.float32)
    for advanced, want in ((False, BASIC_CALL), (True, ADVANCED_CALL)):
        calls.clear()
        api.peaq(ref, test, advanced=advanced, device="cpu")
        assert calls == want
        calls.clear()
        PB.peaq_batch([ref, ref], [test, ref], advanced=advanced,
                      device="cpu", microbatch=2)
        assert calls == want
    chunk = 4
    fft = (chunk + 1) * C.FFT_STEPSIZE
    pool = PS.PeaqStreamPool(1, chunk_frames=chunk, device="cpu")
    calls.clear()
    pool.feed(ref[None, :fft], test[None, :fft])
    assert calls == BASIC_CALL
    pool = PS.PeaqStreamPool(1, chunk_frames=chunk, device="cpu",
                             advanced=True)
    calls.clear()
    pool.feed(ref[None, :fft], test[None, :fft])
    assert calls == [("band_movs", "fft")]
    calls.clear()
    fb = 16 * chunk * C.FB_FRAMESIZE
    pool.feed(ref[None, fft:fb], test[None, fft:fb])
    assert sorted(calls) == sorted([("band_movs", "fft")] + BASIC_CALL[:2]
                                   + [("band_movs", "fb")])
