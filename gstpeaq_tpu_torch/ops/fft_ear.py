"""FFT-based ear model of the basic version (src/fftearmodel.c:432-515).

The stateless part (Hann window, real FFT, playback level, outer/middle-ear
weighting, critical-band grouping, internal noise, frequency spreading) runs
over all frames and channels at once.  On the card the pipelines take it
through stateless_pair_movs: kernel S1 frames both signals, one rDFT
transforms them, kernel S2 forms everything the MOVs read from the spectra
(ops/cuda_spectral.py), and kernel K3 spreads.  The one stateful part,
time-domain smearing, is a banded recurrence over frames: kernel K1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import constants as C
from .. import earparams as EP
from . import cuda_spectral
from . import cuda_spread_fft
from . import iir

# the tensors of FFTEarConsts, in the JAX package's field names
CONST_FIELDS = (
    "hann", "level_factor", "group_matrix", "internal_noise", "a_uc",
    "g_il", "lower_matrix", "spread_norm", "delta_z", "ear_a", "adapt_a",
    "masking_difference", "threshold", "excitation_threshold",
    "loudness_factor", "ehs_zero")

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# the bin-domain fields, in the spectrum dtype (JAX's `fs(...)`); the others
# are in the band dtype
SPECTRUM_FIELDS = ("hann", "level_factor", "group_matrix")


class FFTEarConsts(nn.Module):
    """Constants of the FFT ear model as buffers (CONST_FIELDS): the
    bin-domain SPECTRUM_FIELDS in the spectrum dtype, ehs_zero as bool, the
    rest in the band dtype.

    group_matrix [1025, Z] carries the outer/middle-ear weight folded into
    its rows, so the weighted spectrum never forms; ehs_zero [512] marks
    the bins whose weight is 0 (the DC bin), which EHS must zero because it
    is fed plain power where the reference fed it weighted power (see
    gstpeaq_tpu/ops/fft_ear.py, FFTEarConsts.ehs_zero).  group_bin_hi is
    the last bin the grouping reads, plus one; dz02 = 0.2 * delta_z,
    rounded in the band dtype; a_le = lower_matrix[1, 0], the ratio aLe
    of the lower table lower[i, j] = aLe^(i-j) in the band dtype, which
    K3's wrapper takes in place of the table (0.0 for one band).
    group_span [3, Z] int32 and group_weights (spectrum dtype) are
    group_matrix as S2's compact table (cuda_spectral.group_table), built
    here once."""

    def __init__(self, tensors: dict[str, torch.Tensor], group_bin_hi: int):
        super().__init__()
        for name in CONST_FIELDS:
            self.register_buffer(name, tensors[name])
        span, weights = cuda_spectral.group_table(
            self.group_matrix.cpu().numpy())
        for name, table in (("group_span", span), ("group_weights", weights)):
            self.register_buffer(name, torch.as_tensor(
                table, device=self.group_matrix.device))
        self.band_count = int(self.internal_noise.shape[0])
        self.group_bin_hi = int(group_bin_hi)
        np_dtype = _NUMPY_DTYPE[self.internal_noise.dtype]
        self.dz02 = float(np_dtype(0.2) * np_dtype(self.delta_z.item()))
        self.a_le = (float(self.lower_matrix[1, 0]) if self.band_count > 1
                     else 0.0)


def build_consts(params: EP.FFTEarParams, dtype=torch.float64,
                 device="cpu", spectrum_dtype=None) -> FFTEarConsts:
    """The constants the basic path reads, from EP.fft_ear_params, on
    `device`: SPECTRUM_FIELDS in `spectrum_dtype` (default `dtype`), the
    band-domain rest in `dtype`.  This is gstpeaq_tpu/ops/fft_ear.py::
    build_consts without the TPU's DFT-GEMM and Cooley-Tukey tables."""
    spectrum_dtype = spectrum_dtype or dtype
    z = params.band_count
    idx = np.arange(z)
    expo = idx[None, :] - idx[:, None]  # [i, j] -> j - i
    aLe = params.lower_spreading_exponentiated
    lower = np.where(expo <= 0, aLe ** np.maximum(-expo, 0), 0.0)
    group_bin_hi = int(np.nonzero(
        params.group_matrix.any(axis=1))[0].max() + 1)
    om_weight = params.outer_middle_ear_weight
    values = {
        "hann": params.hann_window,
        "level_factor": params.level_factor,
        "group_matrix": params.group_matrix * om_weight[:, None],
        "internal_noise": params.internal_noise,
        "a_uc": params.a_uc,
        "g_il": params.g_il,
        "lower_matrix": lower,
        "spread_norm": params.spreading_normalization,
        "delta_z": params.delta_z,
        "ear_a": params.ear_time_constants,
        "adapt_a": params.adapt_time_constants,
        "masking_difference": params.masking_difference,
        "threshold": params.threshold,
        "excitation_threshold": params.excitation_threshold,
        "loudness_factor": params.loudness_factor,
    }
    tensors = {name: torch.as_tensor(
        np.asarray(v), device=device,
        dtype=spectrum_dtype if name in SPECTRUM_FIELDS else dtype)
        for name, v in values.items()}
    tensors["ehs_zero"] = torch.as_tensor(
        om_weight[:2 * C.MAXLAG] == 0.0, device=device)
    return FFTEarConsts(tensors, group_bin_hi)


def group_into_bands(k: FFTEarConsts, spectrum: torch.Tensor) -> torch.Tensor:
    """Critical-band grouping with the 1e-12 floor;
    src/fftearmodel.c:603-620.  spectrum: the POWER spectrum [..., bins]
    -> [..., Z] (the ear weight is folded into k.group_matrix)."""
    return torch.clamp_min(spectrum @ k.group_matrix, 1e-12)


def spread(k: FFTEarConsts, pitch_power: torch.Tensor) -> torch.Tensor:
    """Level-dependent frequency spreading, src/fftearmodel.c:636-676, on
    [..., F, Z] (bands last): kernel K3."""
    return cuda_spread_fft.spread_fft(
        pitch_power.contiguous(), k.a_uc, k.g_il, k.a_le, k.spread_norm,
        k.dz02)


def _spectrum_hop(k: FFTEarConsts, blocks: torch.Tensor):
    """Real and imaginary parts of the Hann-windowed rDFT of the frames
    built from hop blocks [..., F + 1, 1024]: [..., F, 1025] each."""
    frames = torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)
    spec = torch.fft.rfft(frames * k.hann, dim=-1)
    return spec.real, spec.imag


def stateless_pair_hop(k: FFTEarConsts, ref_blocks: torch.Tensor,
                       test_blocks: torch.Tensor,
                       spread_ref_only: bool = False):
    """The stateless ear model for a ref/test PAIR of hop blocks
    [..., CH, F + 1, 1024].

    The transform runs on (ref, ref - test): the input difference is exact,
    so the difference spectrum's error scales with the distortion and not
    with the signal.  The test spectrum reconstructs as T = R - D, and the
    NMR power difference is the cross term
        pr - pt = level * (Dre * Sre + Dim * Sim),   S = R + T
    (gstpeaq_tpu/ops/fft_ear.py:484-493, :537-544).

    The frames, the rDFT, power, delta_power and the energy gate are in the
    spectrum dtype (k.hann's); the band powers are cast to the band dtype
    before the internal noise and K3, as gstpeaq_tpu/ops/fft_ear.py:551
    does.

    Returns (power [2, ..., CH, F, 1025], unsmeared [2, ..., CH, F, Z],
    energy_threshold [2, ..., CH, F] bool, delta_power [..., CH, F, hi])
    with hi = k.group_bin_hi.  With spread_ref_only (the advanced path,
    whose NMR masks against the reference alone) only the reference is
    grouped and spread, and unsmeared is [..., CH, F, Z].
    """
    hi = k.group_bin_hi
    ref = ref_blocks.to(k.hann.dtype)
    test = test_blocks.to(k.hann.dtype)
    r_re, r_im = _spectrum_hop(k, ref)
    d_re, d_im = _spectrum_hop(k, ref - test)
    t_re, t_im = r_re - d_re, r_im - d_im
    power = (torch.stack([r_re ** 2 + r_im ** 2, t_re ** 2 + t_im ** 2])
             * k.level_factor)
    delta_power = ((d_re[..., :hi] * (r_re[..., :hi] + t_re[..., :hi])
                    + d_im[..., :hi] * (r_im[..., :hi] + t_im[..., :hi]))
                   * k.level_factor)
    band_power = group_into_bands(
        k, power[0] if spread_ref_only else power).to(k.internal_noise.dtype)
    unsmeared = spread(k, band_power + k.internal_noise)
    energy = torch.sum(torch.stack([ref, test])[..., 1:, :] ** 2, dim=-1)
    threshold_reached = energy >= C.EHS_ENERGY_THRESHOLD
    return power, unsmeared, threshold_reached, delta_power


class PairMovs(NamedTuple):
    """What the pipelines and the streams read of the stateless ear model
    (stateless_pair_movs): unsmeared [2, ..., CH, F, Z] (or [..., CH, F, Z]
    for the reference alone) in the band dtype; threshold [2, ..., CH, F]
    bool, the EHS energy gate of (ref, test); in the spectrum dtype,
    noise_in_bands [..., CH, F, Z] (NMR), ehs_difference [..., CH, F, 512]
    (EHS) and bandwidth, (bw_ref, bw_test, valid) [..., CH, F] or None."""
    unsmeared: torch.Tensor
    threshold: torch.Tensor
    noise_in_bands: torch.Tensor
    ehs_difference: torch.Tensor
    bandwidth: tuple | None


def stateless_pair_movs(k: FFTEarConsts, ref_blocks: torch.Tensor,
                        test_blocks: torch.Tensor,
                        spread_ref_only: bool = False,
                        bandwidth: bool = True) -> PairMovs:
    """stateless_pair_hop and the bin-domain halves of MOVS.bandwidth,
    MOVS.nmr and MOVS.ehs in two kernels around one rDFT: S1 frames (ref,
    ref - test) and takes the hop energies, one batched rfft transforms
    both, S2 forms the band powers, NMR's noise in bands, the bandwidth
    indices and EHS's log-spectral difference, and the band powers, cast
    to the band dtype with the internal noise added, go to K3.  The power
    spectra never form.  spread_ref_only as stateless_pair_hop's;
    bandwidth=False leaves the bandwidth out (the advanced path)."""
    frames, energy = cuda_spectral.pair_frames(ref_blocks, test_blocks,
                                               k.hann)
    spectra = torch.view_as_real(torch.fft.rfft(frames, dim=-1))
    del frames
    s = cuda_spectral.spectral_movs(
        spectra, k.level_factor, k.group_matrix, k.group_bin_hi,
        k.group_span, k.group_weights, k.ehs_zero, spread_ref_only,
        bandwidth)
    unsmeared = spread(
        k, s.band_power.to(k.internal_noise.dtype) + k.internal_noise)
    return PairMovs(unsmeared, energy >= C.EHS_ENERGY_THRESHOLD,
                    s.noise_in_bands, s.ehs_difference, s.bandwidth)


def time_smear(k: FFTEarConsts, unsmeared: torch.Tensor, axis: int = 0,
               state: torch.Tensor | None = None,
               return_state: bool = False):
    """Time-domain smearing E = max(filtered, unsmeared);
    src/fftearmodel.c:496-504.  With axis = -1 the input is the [..., Z, F]
    layout (bands second to last); otherwise the band axis is last.

    state: the filtered excitation before the first frame (unsmeared's
    shape without `axis`), None for zeros; with return_state, also returns
    the filtered excitation at the last frame, the next chunk's state (a
    copy: a view would keep the whole chunk alive)."""
    transposed = axis in (-1, unsmeared.dim() - 1)
    one_minus_a = 1.0 - k.ear_a
    drive = (one_minus_a[:, None] if transposed else one_minus_a) * unsmeared
    filtered = iir.linear_recurrence_banded(
        k.ear_a, drive, axis=axis,
        y0=None if state is None else state.to(drive.dtype))
    out = torch.maximum(filtered, unsmeared)
    if return_state:
        return out, torch.select(filtered, axis, -1).clone()
    return out


def loudness(k: FFTEarConsts, excitation: torch.Tensor,
             axis: int = -1) -> torch.Tensor:
    """Overall loudness per frame; src/earmodel.c:890-907.  Reduces the band
    axis `axis`: -1, or -2 in the [..., Z, F] layout."""
    if axis in (-1, excitation.dim() - 1):
        lf, th, et = k.loudness_factor, k.threshold, k.excitation_threshold
    elif axis in (-2, excitation.dim() - 2):
        lf = k.loudness_factor[:, None]
        th = k.threshold[:, None]
        et = k.excitation_threshold[:, None]
    else:
        raise ValueError("loudness: band axis must be -1 or -2")
    val = lf * ((1.0 - th + th * excitation / et) ** 0.23 - 1.0)
    return (torch.sum(torch.clamp_min(val, 0.0), dim=axis)
            * (24.0 / k.band_count))
