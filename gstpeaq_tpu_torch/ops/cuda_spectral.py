"""The FFT ear's bin-domain stage: CUDA kernels S1 `pair_frames` and S2
`spectral_movs` (csrc/spectral.cu) and their plain PyTorch versions.

Neither is a TPU kernel.  The JAX package leaves this stage to XLA, which
fuses it under `jit` into a few loop fusions around the rDFT:
gstpeaq_tpu/ops/fft_ear.py:473 `stateless_pair_hop` (the frames of (ref,
ref - test), the power and delta-power spectra, the grouping and the
threshold gate's energies) and the bin-domain halves of gstpeaq_tpu/
models/movs.py:65 `bandwidth`, :101 `nmr` and :175 `ehs`.  Run eagerly,
that stage is some seventy launches, each reading and writing a whole
[..., F, 1025] tensor.

S1 writes what the rDFT reads: the Hann-windowed frames of ref and of
ref - test in one [2, ..., F, 2048] tensor, so that one batched
`torch.fft.rfft` (cuFFT, the port's stand-in for XLA's FFT) transforms
both, the hop energies of ref and test that gate EHS, and the energies of
each frame's first half of ref and of ref - test, which the totalsnr
bookkeeping sums (models/basic.py::energy_totals).  S2 reads the
two spectra once and writes only what the MOVs consume: the band powers,
NMR's noise in bands, the bandwidth indices and EHS's 512-bin log-spectral
difference; the power and delta-power spectra never reach device memory.
Both are bound by their bytes; the sources say what their designs do
about it.

The arithmetic that decides a comparison (bandwidth's `> 10 zt` and
`>= 5dB zt`, EHS's `|ratio| <= 0.5` and `rw == 0`) is rounded op for op as
the plain versions round it, so those decisions agree bit for bit; the
band sums run in a fixed order of their own and agree within rounding.

The wrappers take the plain versions only for tensors on the CPU.  For a
CUDA tensor they launch the kernel or raise; there is no fallback.  They
count their launches in `pair_frames_launches` and
`spectral_movs_launches`, one per call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from ..models import movs as MOVS
from . import _build
from . import exact

HOP = C.FFT_STEPSIZE                 # 1024 samples a hop block
FRAME = C.FFT_FRAMESIZE              # 2048 samples a frame
BINS = FRAME // 2 + 1                # 1025 rDFT bins
EHS_BINS = 2 * C.MAXLAG              # 512 bins of the EHS difference
# csrc/spectral.cu's flags of S2
REF_ONLY = 1
BANDWIDTH = 2
pair_frames_launches = 0
spectral_movs_launches = 0


class Spectral(NamedTuple):
    """What S2 gives the MOVs, in the spectrum dtype.  band_power:
    [2, ..., F, Z] (ref, test), or [..., F, Z] for the reference alone;
    noise_in_bands: NMR's noise per band [..., F, Z]; ehs_difference:
    EHS's log-spectral difference [..., F, 512]; bandwidth: (bw_ref,
    bw_test, valid) [..., F], or None where not asked for."""
    band_power: torch.Tensor
    noise_in_bands: torch.Tensor
    ehs_difference: torch.Tensor
    bandwidth: tuple | None


def _framed(blocks: torch.Tensor) -> torch.Tensor:
    """Frames [..., F, 2048] from hop blocks [..., F + 1, 1024]."""
    return torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)


def pair_frames_plain(ref_blocks: torch.Tensor, test_blocks: torch.Tensor,
                      hann: torch.Tensor):
    """The Hann-windowed frames of ref and of ref - test, [2, ..., F, 2048],
    the hop energies [2, ..., F] of ref and test over blocks 1..F, and the
    halves [2, ..., F], the energies of ref and of ref - test over blocks
    0..F-1 (each frame's first half), in hann's dtype (the spectrum
    dtype); the difference is taken in that dtype (gstpeaq_tpu/ops/
    fft_ear.py:527-528, 562; gstpeaq_tpu/models/basic.py:203-211)."""
    ref = ref_blocks.to(hann.dtype)
    test = test_blocks.to(hann.dtype)
    diff = ref - test
    frames = torch.stack([_framed(ref), _framed(diff)]) * hann
    energy = torch.sum(torch.stack([ref, test])[..., 1:, :] ** 2, dim=-1)
    halves = torch.sum(torch.stack([ref, diff])[..., :-1, :] ** 2, dim=-1)
    return frames, energy, halves


def pair_frames(ref_blocks: torch.Tensor, test_blocks: torch.Tensor,
                hann: torch.Tensor):
    """S1: pair_frames_plain.  ref/test_blocks: hop blocks [..., F + 1,
    1024] of one shape, float32 or float64; hann: [2048] in the spectrum
    dtype.  Returns (frames, energy, halves), contiguous."""
    global pair_frames_launches
    if ref_blocks.device.type == "cpu":
        return pair_frames_plain(ref_blocks, test_blocks, hann)
    if (ref_blocks.shape != test_blocks.shape or ref_blocks.dim() < 2
            or ref_blocks.shape[-1] != HOP or ref_blocks.shape[-2] < 1
            or hann.shape != (FRAME,)):
        raise ValueError(f"pair_frames: blocks {tuple(ref_blocks.shape)} / "
                         f"{tuple(test_blocks.shape)} and hann "
                         f"{tuple(hann.shape)}: expected [..., F + 1, {HOP}]"
                         f" each and [{FRAME}]")
    _build.require("pair_frames", hann, hann=hann)
    for arg, t in (("ref_blocks", ref_blocks), ("test_blocks", test_blocks)):
        if (t.device != hann.device or t.dtype != ref_blocks.dtype
                or t.dtype not in (torch.float32, torch.float64)):
            raise TypeError(f"pair_frames: {arg} is {t.dtype} on "
                            f"{t.device}, expected float32 or float64 on "
                            f"{hann.device}, as ref_blocks")
    # the kernel takes 16-byte loads of contiguous blocks: a view (the
    # advanced path's FFT prefix of each signal) is copied
    ref, test = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (ref_blocks, test_blocks))
    if hann.data_ptr() % 16:
        hann = hann.clone()
    lead, n = ref.shape[:-2], ref.shape[-2] - 1
    frames = torch.empty((2, *lead, n, FRAME), dtype=hann.dtype,
                         device=hann.device)
    energy, halves = torch.empty((2, 2, *lead, n), dtype=hann.dtype,
                                 device=hann.device)
    rows = ref.numel() // ((n + 1) * HOP)
    if rows * n == 0:
        return frames, energy, halves
    _build.launch("pair_frames", hann, ref.data_ptr(), test.data_ptr(),
                  int(ref.dtype == torch.float64), hann.data_ptr(),
                  frames.data_ptr(), energy.data_ptr(), halves.data_ptr(),
                  rows, n)
    pair_frames_launches += 1
    return frames, energy, halves


def spectral_movs_plain(spectra: torch.Tensor, level_factor: torch.Tensor,
                        group_matrix: torch.Tensor, group_bin_hi: int,
                        ehs_zero: torch.Tensor, ref_only: bool = False,
                        bandwidth: bool = True) -> Spectral:
    """The bin-domain stage as the JAX package composes it: the power
    spectra of R and T = R - D, the exactly cancelled pr - pt
    = level (Dre Sre + Dim Sim), S = R + T (gstpeaq_tpu/ops/
    fft_ear.py:537-544), grouped (with the 1e-12 floor), and
    MOVS.bandwidth, MOVS.nmr_noise_bands and MOVS.ehs_log_difference on
    them.  spectra: torch.view_as_real of the complex rDFTs [2, ..., F,
    1025] of (ref, ref - test), i.e. [2, ..., F, 1025, 2]."""
    spec = torch.view_as_complex(spectra)
    hi = group_bin_hi
    r_re, r_im = spec[0].real, spec[0].imag
    d_re, d_im = spec[1].real, spec[1].imag
    t_re, t_im = r_re - d_re, r_im - d_im
    power = (torch.stack([r_re ** 2 + r_im ** 2, t_re ** 2 + t_im ** 2])
             * level_factor)
    delta_power = ((d_re[..., :hi] * (r_re[..., :hi] + t_re[..., :hi])
                    + d_im[..., :hi] * (r_im[..., :hi] + t_im[..., :hi]))
                   * level_factor)
    band_power = torch.clamp_min(
        exact.band_sum(power[0] if ref_only else power, group_matrix),
        1e-12)
    noise = MOVS.nmr_noise_bands(group_matrix[:hi], power[0][..., :hi],
                                 power[1][..., :hi], delta_power)
    d = MOVS.ehs_log_difference(power[0], power[1], delta_power, ehs_zero)
    bw = MOVS.bandwidth(power[0], power[1]) if bandwidth else None
    return Spectral(band_power, noise, d, bw)


def spectral_movs(spectra: torch.Tensor, level_factor: torch.Tensor,
                  group_matrix: torch.Tensor, group_bin_hi: int,
                  group_span: torch.Tensor, group_weights: torch.Tensor,
                  ehs_zero: torch.Tensor, ref_only: bool = False,
                  bandwidth: bool = True) -> Spectral:
    """S2: spectral_movs_plain.  spectra: [2, ..., F, 1025, 2] (the real
    view of the complex rDFTs of (ref, ref - test)), contiguous;
    level_factor: 0-d; group_matrix / group_bin_hi: the plain version's
    grouping, group_span / group_weights: the kernel's (exact.group_table
    of the same matrix); ehs_zero: [512] bool.  With ref_only only the reference
    is grouped; bandwidth=False leaves the bandwidth out (None)."""
    global spectral_movs_launches
    if spectra.device.type == "cpu":
        return spectral_movs_plain(spectra, level_factor, group_matrix,
                                   group_bin_hi, ehs_zero, ref_only,
                                   bandwidth)
    z = group_span.shape[-1]
    if (spectra.dim() < 3 or spectra.shape[0] != 2
            or spectra.shape[-2:] != (BINS, 2) or level_factor.numel() != 1
            or group_span.shape != (3, z) or ehs_zero.shape != (EHS_BINS,)):
        raise ValueError(f"spectral_movs: spectra {tuple(spectra.shape)}, "
                         f"span {tuple(group_span.shape)}, ehs_zero "
                         f"{tuple(ehs_zero.shape)}: expected [2, ..., "
                         f"{BINS}, 2], [3, Z] and [{EHS_BINS}]")
    _build.require("spectral_movs", spectra, spectra=spectra,
                   level_factor=level_factor, group_weights=group_weights)
    for arg, t, dtype in (("group_span", group_span, torch.int32),
                          ("ehs_zero", ehs_zero, torch.bool)):
        if t.device != spectra.device or t.dtype != dtype:
            raise TypeError(f"spectral_movs: {arg} is {t.dtype} on "
                            f"{t.device}, expected {dtype} on "
                            f"{spectra.device}")
        if not t.is_contiguous():
            raise ValueError(f"spectral_movs: {arg} must be contiguous")
    if spectra.data_ptr() % (2 * spectra.element_size()):
        spectra = spectra.clone()               # the kernel's pair loads
    lead = spectra.shape[1:-2]                  # [..., F]
    like = dict(dtype=spectra.dtype, device=spectra.device)
    band = torch.empty(((1,) if ref_only else (2,)) + (*lead, z), **like)
    noise = torch.empty((*lead, z), **like)
    d = torch.empty((*lead, EHS_BINS), **like)
    bw = valid = None
    if bandwidth:
        bw = torch.empty((2, *lead), **like)
        valid = torch.empty(lead, dtype=torch.bool, device=spectra.device)
    rows = spectra.numel() // (2 * BINS * 2)
    if rows:
        _build.launch("spectral_movs", spectra, spectra.data_ptr(),
                      level_factor.data_ptr(), group_span.data_ptr(),
                      group_weights.data_ptr(), z, ehs_zero.data_ptr(),
                      (REF_ONLY if ref_only else 0)
                      | (BANDWIDTH if bandwidth else 0),
                      band.data_ptr(), noise.data_ptr(),
                      bw.data_ptr() if bandwidth else None,
                      valid.data_ptr() if bandwidth else None,
                      d.data_ptr(), rows)
        spectral_movs_launches += 1
    return Spectral(band[0] if ref_only else band, noise, d,
                    (bw[0], bw[1], valid) if bandwidth else None)
