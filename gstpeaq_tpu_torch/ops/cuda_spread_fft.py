"""FFT-ear frequency spreading: CUDA kernel K3 and its plain PyTorch version.

K3 `spread_fft` (csrc/spread_fft.cu) replaces the Pallas TPU kernel
gstpeaq_tpu/ops/pallas_spread_fft.py::spread_fft and keeps its layout:
[..., F, Z], bands last, one contiguous row per frame.  What it computes:
src/fftearmodel.c:636-676.

The kernel runs one warp per frame row with BANDS_PER_LANE consecutive
bands a lane.  Its upper part is the TPU kernel's shift-multiply walk; its
lower part uses that the lower table is Toeplitz, lower[i, j] = aLe^(i-j)
for i >= j, and runs the backward recurrence L_j = Ene_j + aLe L_{j+1}.  So
the wrapper takes aLe (FFTEarConsts.a_le) alone: the kernel reads it and
the host's float64 step factors of its warp scan, and the plain version
reads the table `lower_table` forms from it, so both paths compute one
function of one input.

The wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  It
counts its launches in `spread_fft_launches`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

# csrc/spread_fft.cu's kBands: a lane holds BANDS_PER_LANE bands of its
# row, one warp a row, so a row has at most MAX_BANDS bands
BANDS_PER_LANE = 4
LANES = 32
MAX_BANDS = BANDS_PER_LANE * LANES
spread_fft_launches = 0


def spread_fft_plain(pitch_power: torch.Tensor, a_uc: torch.Tensor,
                     g_il: torch.Tensor, lower_matrix: torch.Tensor,
                     spread_norm: torch.Tensor, dz02: float,
                     block: int = 16) -> torch.Tensor:
    """Level-dependent spreading in the exp form of the JAX reference
    (gstpeaq_tpu/ops/fft_ear.py::spread):
        W[i, j] = aUCEe[i]^(j-i)  for j > i   (level-dependent upper slope)
        W[i, j] = lower[i, j]     for j <= i  (constant lower slope)
    E2[j] = sum_i Ene[i] * W[i, j]; out = E2^2.5 / norm.  The upper part is
    formed in blocks of `block` destination bands.

    pitch_power: [..., Z] (> 0); a_uc/g_il/spread_norm: [Z]; lower_matrix:
    [Z, Z]; dz02 = 0.2 * delta_z in the working type."""
    z = pitch_power.shape[-1]
    dtype, device = pitch_power.dtype, pitch_power.device
    a_uce = a_uc * pitch_power ** dz02
    n_up = z - torch.arange(z, dtype=dtype, device=device)
    g_iu = (1.0 - a_uce ** n_up) / (1.0 - a_uce)
    ene = (pitch_power / (g_il + g_iu - 1.0)) ** 0.4
    log_a = (0.4 * torch.log(a_uce))[..., None]           # [..., Z, 1]
    e2 = ene @ lower_matrix
    i_idx = torch.arange(z, dtype=dtype, device=device)[:, None]
    chunks = []
    for jb in range(0, z, block):
        j = torch.arange(jb, min(jb + block, z), dtype=dtype, device=device)
        expo = j - i_idx                                  # [Z, <=block]
        w = torch.where(expo > 0, torch.exp(expo * log_a), 0.0)
        chunks.append(torch.sum(ene[..., None] * w, dim=-2))
    e2 = e2 + torch.cat(chunks, dim=-1)
    return (e2 * e2) * torch.sqrt(e2) / spread_norm


def lower_table(z: int, a_le: float, dtype: torch.dtype,
                device) -> torch.Tensor:
    """The lower table [Z, Z] with lower[i, j] = aLe^(i-j) for i >= j, else
    0: the powers in float64, rounded to `dtype` (FFTEarConsts.lower_matrix
    is the same table of the exact aLe)."""
    i, j = np.indices((z, z))
    table = np.where(i >= j, np.float64(a_le) ** np.maximum(i - j, 0), 0.0)
    return torch.as_tensor(table, dtype=dtype, device=device)


@functools.cache
def lower_factors(a_le: float) -> np.ndarray:
    """K3's lower-part factors, float64, in the order spread_fft.cu reads
    them: aLe, then the backward warp scan's step factors
    (aLe^BANDS_PER_LANE)^(2^e), e = 0..4.  Read-only: it is cached."""
    out = np.array([a_le, *(a_le ** (BANDS_PER_LANE << e) for e in range(5))],
                   dtype=np.float64)
    out.flags.writeable = False
    return out


def spread_fft(pitch_power: torch.Tensor, a_uc: torch.Tensor,
               g_il: torch.Tensor, a_le: float, spread_norm: torch.Tensor,
               dz02: float) -> torch.Tensor:
    """K3: spread_fft_plain with the lower table aLe^(i-j) given by its
    ratio a_le.  pitch_power: contiguous [..., F, Z] with Z <= MAX_BANDS.
    Returns the unsmeared excitation, same shape and dtype."""
    global spread_fft_launches
    z = pitch_power.shape[-1]
    if pitch_power.device.type == "cpu":
        return spread_fft_plain(
            pitch_power, a_uc, g_il,
            lower_table(z, a_le, pitch_power.dtype, pitch_power.device),
            spread_norm, dz02)
    if (not 1 <= z <= MAX_BANDS or a_uc.shape != (z,)
            or g_il.shape != (z,) or spread_norm.shape != (z,)):
        raise ValueError(f"spread_fft: pitch_power {tuple(pitch_power.shape)} "
                         f"and its [Z] constants do not match "
                         f"(Z <= {MAX_BANDS})")
    _build.require("spread_fft", pitch_power, pitch_power=pitch_power,
                   a_uc=a_uc, g_il=g_il, spread_norm=spread_norm)
    out = torch.empty_like(pitch_power)
    if pitch_power.numel() == 0:
        return out
    _build.launch("spread_fft", pitch_power, pitch_power.data_ptr(),
                  a_uc.data_ptr(), g_il.data_ptr(), spread_norm.data_ptr(),
                  float(dz02), lower_factors(float(a_le)).ctypes.data,
                  out.data_ptr(), pitch_power.numel() // z, z)
    spread_fft_launches += 1
    return out
