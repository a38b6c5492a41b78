"""The band-domain epilogues: CUDA kernels L1 `levcorr`, L2 `pattern_adapt`
and M1 `band_movs` (csrc/band.cu) and their plain PyTorch versions.

None is a TPU kernel.  The JAX package leaves this work to XLA, which fuses
it under `jit` (gstpeaq_tpu/models/level_adapt.py:45 adapt_stage2,
gstpeaq_tpu/models/movs.py:20, :46, :101, :136).  Run eagerly, each line is
a launch over a whole [..., Z, F] tensor, some 100 a call:

  L1  the level adapter's level correction up to its num/den smoothers
      (K1): per frame the correction lev_corr and the smoothers' stacked
      drive;
  L2  the pattern adaptation between the num/den smoothers and the
      pattern-correction smoother (K1): its (1 - a)-scaled drive;
  M1  every per-frame MOV term of a call site that reads the band domain:
      ModDiff and TempWt, the noise loudness (one set basic, three on the
      advanced FB path), the overall loudness of the MOV gates, NMR's band
      half and the binaural detection probability and steps.  It
      recomputes the adapted excitations from the excitations, lev_corr
      and the pattern correction, so they are never written.

The plain versions are the eager code that ran before: the level adapter's
lines (models/level_adapt.py before the kernels) here, and models/movs.py's
and ops/fft_ear.py's functions, which stay where they are.  On the CPU
their float64 bits are those of that code.

Each wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  Each
counts its launches (`levcorr_launches`, `pattern_adapt_launches`,
`band_movs_launches`), one per call.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..models import movs as MOVS
from . import _build
from . import exact
from . import fft_ear as FE

levcorr_launches = 0
pattern_adapt_launches = 0
band_movs_launches = 0

# M1's call sites and the parts of csrc/band.cu each runs (its k* bits)
MOD_BASIC, MOD_FB, LOUDNESS, NMR, PROB, USE_FLOOR, SWAP = (
    1, 2, 4, 8, 16, 32, 64)
SITES = {"basic": MOD_BASIC | LOUDNESS | NMR | PROB,   # models/basic.py
         "fft": NMR,                 # the advanced FFT path (NMR alone)
         "fb": MOD_FB | LOUDNESS}    # the advanced FB path
# the rows of BandMovs.terms per site
TERMS = {"basic": ("md1", "md2", "temp_wt", "nl"),
         "fft": (),
         "fb": ("md1", "md2", "temp_wt", "nl_asym", "missing", "lin_dist")}
# M1's per-band constants live in shared memory (csrc/band.cu kMaxBands);
# L2's band-average window has at most 16 bands (kMaxWindow: Z up to 239)
MAX_BANDS = 256
MAX_WINDOW = 16


# the library calls csrc/band.cu's math_rate_kernel times: name -> its op
# code (kMath*); "muladd" is the loop's own multiply and add; "sqrt" and
# "log1p" are S2's (tools/spectral_ab.py); each thread runs MATH_CHAINS
# independent chains (kChains)
MATH_OPS = {"pow": 0, "exp": 1, "exp2": 2, "log10": 3, "div": 4,
            "muladd": 5, "sqrt": 6, "log1p": 7}
MATH_CHAINS = 8


class BandMovs(NamedTuple):
    """M1's outputs, None where the site does not form them.  terms
    [n, ..., F]: TERMS[site] in order, band dtype; loudness [2, ..., F]:
    the overall loudness of (ref, test); nmr [2, ..., F]: NMR's mean and
    disturbed flag (0 or 1), in the noise's (spectrum) dtype; detect
    [2, ..., F] without the channel axis: p_bin and steps_bin per pair."""
    terms: torch.Tensor | None
    loudness: torch.Tensor | None
    nmr: torch.Tensor | None
    detect: torch.Tensor | None


def band_average(x: torch.Tensor, avg_matrix: torch.Tensor) -> torch.Tensor:
    """The +-M1/M2 band average of x [..., Z, F] (src/leveladapter.c:
    313-325): out[k] = (sum of x[w] for w = k - m1 .. k + m2, ascending)
    times avg_matrix[k, k] = 1 / (m1 + m2 + 1).  Bands past either edge
    enter as exact zeros, so each band's sum has one fixed order."""
    z = x.shape[-2]
    m1c, m2c = z // 36, z // 25
    padded = torch.nn.functional.pad(x, (0, 0, m1c, m2c))
    total = padded[..., :z, :]
    for shift in range(1, m1c + m2c + 1):
        total = total + padded[..., shift:shift + z, :]
    return torch.diagonal(avg_matrix)[:, None] * total


def _levcorr_pair(exc2: torch.Tensor, lev_corr: torch.Tensor):
    """The level-corrected excitations of (ref, test) exc2 [2, ..., Z, F]
    by lev_corr [..., F] (src/leveladapter.c:282-289)."""
    lev = lev_corr[..., None, :]
    louder_ref = lev > 1.0
    return (torch.where(louder_ref, exc2[0] / lev, exc2[0]),
            torch.where(louder_ref, exc2[1], exc2[1] * lev))


def adapted(exc2: torch.Tensor, lev_corr: torch.Tensor, pc: torch.Tensor):
    """The adapted excitations (adapted_ref, adapted_test) from the
    excitations exc2, lev_corr and the pattern correction pc [2, ..., Z, F]
    (src/leveladapter.c:335-338), in plain tensor ops."""
    levcorr_ref, levcorr_test = _levcorr_pair(exc2, lev_corr)
    return levcorr_ref * pc[0], levcorr_test * pc[1]


def levcorr_plain(exc2: torch.Tensor, filt2: torch.Tensor):
    """L1's function: exc2 [2, ..., Z, F] the (ref, test) excitations,
    filt2 their stage-1 smoothed excitations.  Returns (lev_corr [..., F],
    drive [2, ..., Z, F]), the num/den smoothers' drive (levcorr_test
    levcorr_ref, levcorr_ref^2), not scaled by (1 - a) (src/
    leveladapter.c:291-298)."""
    num = torch.sum(exact.sqrt(filt2[0] * filt2[1]), dim=-2)
    den = torch.sum(filt2[1], dim=-2)
    lev_corr = num * num / (den * den)
    levcorr_ref, levcorr_test = _levcorr_pair(exc2, lev_corr)
    return lev_corr, torch.stack([levcorr_test * levcorr_ref,
                                  levcorr_ref * levcorr_ref])


def _check_band(name: str, z: int, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dim() < 3 or t.shape[0] != 2 or t.shape[-2] != z:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)}: expected "
                             f"[2, ..., {z}, F]")


def levcorr(exc2: torch.Tensor, filt2: torch.Tensor):
    """L1: levcorr_plain.  exc2, filt2: [2, ..., Z, F] of one shape."""
    global levcorr_launches
    if exc2.device.type == "cpu":
        return levcorr_plain(exc2, filt2)
    z = exc2.shape[-2] if exc2.dim() >= 2 else -1
    _check_band("levcorr", z, exc2=exc2, filt2=filt2)
    if filt2.shape != exc2.shape:
        raise ValueError(f"levcorr: exc2 {tuple(exc2.shape)} and filt2 "
                         f"{tuple(filt2.shape)} differ")
    exc2, filt2 = exc2.contiguous(), filt2.contiguous()
    _build.require("levcorr", exc2, exc2=exc2, filt2=filt2)
    f = exc2.shape[-1]
    lev = exc2.new_empty((*exc2.shape[1:-2], f))
    drive = torch.empty_like(exc2)
    rows = lev.numel() // f if f else 0
    if rows * f:
        _build.launch("levcorr", exc2, exc2.data_ptr(), filt2.data_ptr(),
                      rows, z, f, lev.data_ptr(), drive.data_ptr())
        levcorr_launches += 1
    return lev, drive


def pattern_adapt_plain(nd: torch.Tensor, a: torch.Tensor,
                        avg_matrix: torch.Tensor) -> torch.Tensor:
    """L2's function: from the num/den smoothers' outputs nd [2, ..., Z, F]
    the pattern adaptation factors (src/leveladapter.c:300-311), their
    band average (band_average, avg_matrix [Z, Z] from
    level_adapt.sliding_average_matrix) and the pattern-correction
    smoother's drive (1 - a) ra, [2(ref, test), ..., Z, F]."""
    filt_num, filt_den = nd[0], nd[1]
    num_ge = filt_num >= filt_den
    pattadapt_ref = torch.where(num_ge, 1.0, filt_num / filt_den)
    pattadapt_test = torch.where(num_ge, filt_den / filt_num, 1.0)
    ra = band_average(torch.stack([pattadapt_ref, pattadapt_test]),
                      avg_matrix)
    return (1.0 - a[:, None]) * ra


def pattern_adapt(nd: torch.Tensor, a: torch.Tensor,
                  avg_matrix: torch.Tensor) -> torch.Tensor:
    """L2: pattern_adapt_plain.  nd [2, ..., Z, F]; a [Z]; avg_matrix
    [Z, Z] (its diagonal is read)."""
    global pattern_adapt_launches
    if nd.device.type == "cpu":
        return pattern_adapt_plain(nd, a, avg_matrix)
    z = nd.shape[-2] if nd.dim() >= 2 else -1
    _check_band("pattern_adapt", z, nd=nd)
    m1c, m2c = z // 36, z // 25
    if (a.shape != (z,) or avg_matrix.shape != (z, z)
            or m1c + m2c + 1 > MAX_WINDOW):
        raise ValueError(f"pattern_adapt: a {tuple(a.shape)}, avg_matrix "
                         f"{tuple(avg_matrix.shape)} for {z} bands: expected "
                         f"[Z] and [Z, Z], a window of at most {MAX_WINDOW}")
    nd = nd.contiguous()
    _build.require("pattern_adapt", nd, nd=nd, a=a, avg_matrix=avg_matrix)
    out = torch.empty_like(nd)
    f = nd.shape[-1]
    rows = nd[0].numel() // (z * f) if f else 0
    if rows * f:
        _build.launch("pattern_adapt", nd, nd.data_ptr(), a.data_ptr(),
                      avg_matrix.data_ptr(), rows, z, f, m1c, m2c,
                      out.data_ptr())
        pattern_adapt_launches += 1
    return out


def band_movs_plain(k, site: str, exc: torch.Tensor, lev_corr=None, pc=None,
                    mod2=None, avg_loud=None, noise=None,
                    use_floor: bool = False, swap: bool = False) -> BandMovs:
    """M1's function at `site` (SITES), as the pipelines formed it before
    the kernel.  k: the site's ear constants (FFTEarConsts or FBEarConsts);
    exc: the (ref, test) excitations [2, ..., CH, Z, F], or the reference's
    [..., CH, Z, F] at the "fft" site; lev_corr [..., CH, F] and pc
    [2, ..., CH, Z, F] the level adapter's factors (level_adapt.*_factors);
    mod2 [2, ..., CH, Z, F] the modulation of (ref, test); avg_loud the
    reference's average loudness [..., CH, Z, F]; noise NMR's noise per
    band [..., CH, F, Z] (S2's, spectrum dtype); use_floor: floor(e) for
    the steps (settings.use_floor_for_steps_above_threshold); swap:
    settings.swap_mod_patts_for_noise_loudness_movs."""
    terms = loud = nmr = detect = None
    ref_e = exc if site == "fft" else exc[0]
    noise_z = k.internal_noise
    if site in ("basic", "fb"):
        ar, at = adapted(exc, lev_corr, pc)
        mod_ref, mod_test = mod2[0], mod2[1]
        md1, md2, temp_wt = MOVS.modulation_difference(
            noise_z, mod_ref, mod_test, avg_loud, rms_mode=site == "fb",
            lev_wt=1.0 if site == "fb" else 100.0)
        if site == "basic":
            nls = [MOVS.noise_loudness(noise_z, 1.5, 0.15, 0.5, 0.0, mod_ref,
                                       mod_test, ar, at)]
        else:
            nl = _fb_noise_loudness(noise_z)
            nls = [nl(2.5, 0.3, 0.1, mod_ref, mod_test, ar, at)]
            if swap:
                nls += [nl(1.5, 0.15, 0.0, mod_test, mod_ref, at, ar),
                        nl(1.5, 0.15, 0.0, mod_ref, mod_ref, ar, ref_e)]
            else:
                nls += [nl(1.5, 0.15, 0.0, mod_ref, mod_test, at, ar),
                        nl(1.5, 0.15, 0.0, mod_ref, mod_test, ar, ref_e)]
        terms = torch.stack([md1, md2, temp_wt, *nls])
        loud = FE.loudness(k, exc, axis=-2)
    if site in ("basic", "fft"):
        nmr = torch.stack(MOVS.nmr_from_bands(
            k.masking_difference, noise, ref_e.transpose(-1, -2)))
    if site == "basic":
        detect = torch.stack(MOVS.prob_detect(exc[0], exc[1], use_floor))
    return BandMovs(terms, loud, nmr, detect)


def _fb_noise_loudness(noise_z: torch.Tensor):
    """The advanced FB path's noise loudness sets (s0 = 1): (alpha,
    thres_fac, nl_min, mod_ref, mod_test, e_ref, e_test) -> [..., F]."""
    def nl(alpha, thres_fac, nl_min, mod_ref, mod_test, e_ref, e_test):
        return MOVS.noise_loudness(noise_z, alpha, thres_fac, 1.0, nl_min,
                                   mod_ref, mod_test, e_ref, e_test)
    return nl


def _data(t):
    return None if t is None else t.data_ptr()


def band_movs(k, site: str, exc: torch.Tensor, lev_corr=None, pc=None,
              mod2=None, avg_loud=None, noise=None, use_floor: bool = False,
              swap: bool = False) -> BandMovs:
    """M1: band_movs_plain.  The band inputs in one float type T, noise in
    T or (T float32) float64; each is made contiguous."""
    global band_movs_launches
    if exc.device.type == "cpu":
        return band_movs_plain(k, site, exc, lev_corr, pc, mod2, avg_loud,
                               noise, use_floor, swap)
    if site not in SITES:
        raise ValueError(f"band_movs: site {site!r}, expected one of "
                         f"{sorted(SITES)}")
    parts = SITES[site] | (USE_FLOOR if use_floor else 0) | (
        SWAP if swap else 0)
    stacked = site != "fft"
    lead_dims = 1 + stacked                     # [2, ...] or [...]; CH
    if exc.dim() < 2 + lead_dims or (stacked and exc.shape[0] != 2):
        want = "[2, ..., CH, Z, F]" if stacked else "[..., CH, Z, F]"
        raise ValueError(f"band_movs: exc {tuple(exc.shape)} at {site!r}: "
                         f"expected {want}")
    band_shape = exc.shape[1:] if stacked else exc.shape
    lead, (z, f) = band_shape[:-2], band_shape[-2:]
    if not 1 <= z <= MAX_BANDS:
        raise ValueError(f"band_movs: {z} bands, expected 1..{MAX_BANDS}")
    need = {"exc": (exc, exc.shape)}
    if parts & (MOD_BASIC | MOD_FB):
        need.update(lev_corr=(lev_corr, (*lead, f)),
                    pc=(pc, (2, *band_shape)), mod2=(mod2, (2, *band_shape)),
                    avg_loud=(avg_loud, band_shape))
    if parts & NMR:
        need["noise"] = (noise, (*lead, f, z))
    for arg, (t, shape) in need.items():
        if t is None or tuple(t.shape) != tuple(shape):
            raise ValueError(f"band_movs: {arg} "
                             f"{None if t is None else tuple(t.shape)} at "
                             f"{site!r}: expected {list(shape)}")
    exc = exc.contiguous()
    band = {arg: need[arg][0].contiguous() for arg in
            ("lev_corr", "pc", "mod2", "avg_loud") if arg in need}
    consts = {"internal_noise": k.internal_noise,
              "loudness_factor": k.loudness_factor,
              "threshold": k.threshold,
              "excitation_threshold": k.excitation_threshold}
    if parts & NMR:
        consts["masking_difference"] = k.masking_difference
    for arg, t in consts.items():
        if t.shape != (z,):
            raise ValueError(f"band_movs: {arg} {tuple(t.shape)}, expected "
                             f"[{z}]")
    _build.require("band_movs", exc, exc=exc, **band, **consts)
    sdtype = exc.dtype
    if parts & NMR:
        noise = need["noise"][0].contiguous()
        sdtype = noise.dtype
        if (noise.device != exc.device or sdtype not in (
                exc.dtype, torch.float64)):
            raise TypeError(f"band_movs: noise is {sdtype} on "
                            f"{noise.device}, expected {exc.dtype} or "
                            f"float64 on {exc.device}")
    channels = lead[-1]
    rows = math.prod(lead)
    like = dict(dtype=exc.dtype, device=exc.device)
    n_terms = len(TERMS[site])
    terms = torch.empty((n_terms, *lead, f), **like) if n_terms else None
    loud = (torch.empty((2, *lead, f), **like) if parts & LOUDNESS
            else None)
    nmr = (torch.empty((2, *lead, f), dtype=sdtype, device=exc.device)
           if parts & NMR else None)
    detect = (torch.empty((2, *lead[:-1], f), **like) if parts & PROB
              else None)
    if rows * f:
        pair = (None, None)
        ins = (ctypes.c_void_p * 9)(*map(_data, (
            *(exc if stacked else (exc, None)), band.get("lev_corr"),
            *band.get("pc", pair), *band.get("mod2", pair),
            band.get("avg_loud"), noise if parts & NMR else None)))
        cst = (ctypes.c_void_p * 5)(
            *(_data(consts.get(name)) for name in (
                "internal_noise", "loudness_factor", "threshold",
                "excitation_threshold", "masking_difference")))
        fb = site == "fb"
        scalars = (ctypes.c_double * 4)(
            1.0 if fb else 100.0,
            100.0 / math.sqrt(z) if fb else 100.0 / z,
            100.0 / z, 24.0 / z)
        _build.launch("band_movs", exc, ins, cst, scalars, rows, channels,
                      z, f, parts, int(sdtype == torch.float64),
                      _data(terms), _data(loud), _data(nmr), _data(detect))
        band_movs_launches += 1
    return BandMovs(terms, loud, nmr, detect)


def math_rate(op: str, iters: int, out: torch.Tensor) -> None:
    """Launch the throughput probe of M1's library call `op` (MATH_OPS) in
    out's dtype on out's card: out.numel() / 256 blocks of 256 threads,
    each running `iters` steps of MATH_CHAINS independent chains in
    registers; out
    [blocks x 256], contiguous, takes each thread's sum.  Not counted: no
    path of the port runs it (chip_smoke.py phase 7 and tools/band_ab.py
    do)."""
    _build.require("band_math_rate", out)
    if out.numel() % 256:
        raise ValueError("math_rate: out must hold 256 values a block")
    _build.launch("band_math_rate", out, MATH_OPS[op], iters,
                  out.numel() // 256, out.data_ptr())
