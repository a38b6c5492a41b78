"""Filter-bank ear model of the advanced version (src/fbearmodel.c:275-435),
on the flat layout.

A signal [..., T] (T = 192 F) runs through
  DC rejection   the two-stage high-pass cascade: kernel D3;
  FIR bank       40 complex bands evaluated every 32nd sample, one stride-1
                 convolution over 32-sample blocks (plain PyTorch: a product
                 the JAX package also leaves to its compiler);
  slope filter   the level-dependent upper slope's smoothed state cu:
                 kernel D1;
  spreading      E0 = |lower(fb + upper(fb, cu))|^2: kernel D2;
  masking        backward masking as two 6-tap frame sums, forward masking
                 a banded recurrence over frames: kernel K1.
The band domain is the JAX package's transposed layout [..., 40, I] (bands
second to last, instants last), and the outputs (excitation, unsmeared)
are [..., 40, F], the MOV tail's layout.

The reference's ring-buffer quirk (the lag-1456 tap reads the newest sample,
gstpeaq_tpu/utils/numpy_ref.py::fb_apply_filter_bank) is kept by folding
that tap into lag 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import constants as C
from .. import earparams as EP
from . import cuda_dc
from . import cuda_fb
from . import iir

# the tensors of FBEarConsts; all but fir_weight carry the JAX package's
# FBEarConsts field names
CONST_FIELDS = (
    "fir_weight", "back_mask", "back_mask_w", "internal_noise", "ear_a",
    "adapt_a", "fc", "lower_matrix", "level_factor", "threshold",
    "excitation_threshold", "loudness_factor")
# the sample-domain fields (DC stage and FIR bank), in the spectrum dtype
# (JAX's `fs(...)`); the others are in the band dtype
SPECTRUM_FIELDS = ("fir_weight", "level_factor")

SUB = C.FB_SUBSAMPLING          # 32: one instant every 32 samples
TAPS = C.FB_BUFFER_LENGTH       # 1456 lags, 0..1455
# the FIR bank as a stride-1 convolution over 32-sample blocks: FIR_BLOCKS
# blocks of window behind FIR_PAD leading zero samples (see fir_weight)
FIR_BLOCKS = 47
FIR_PAD = SUB * (FIR_BLOCKS - 1)


def folded_taps(params: EP.FBEarParams) -> np.ndarray:
    """The FIR taps [80, 1456] in lag order (40 real rows, then 40
    imaginary), with the aliased lag-1456 tap folded into lag 0."""
    h_re = params.h_re[:, :TAPS].copy()
    h_im = params.h_im[:, :TAPS].copy()
    h_re[:, 0] += params.h_re[:, TAPS]
    h_im[:, 0] += params.h_im[:, TAPS]
    return np.concatenate([h_re, h_im], axis=0)


def fir_weight(taps: np.ndarray) -> np.ndarray:
    """The conv1d weight [80, 32, 47] of the FIR bank from the lag-order
    taps [80, 1456].

    With the signal behind FIR_PAD = 1472 zeros cut into 32-sample blocks
    B[m, r] = xpad[32 m + r], the output at instant i (sample 32 i) is
        fb[i] = sum_lag h[lag] x[32 i - lag]
              = sum_{r, k} W[r, k] B[i + k, r],  lag = 1472 - 32 k - r,
    a stride-1 correlation with 32 input channels and a window of 47
    blocks; lags outside 0..1455 get zero weight."""
    k = np.arange(FIR_BLOCKS)[None, :]
    r = np.arange(SUB)[:, None]
    lag = FIR_PAD - SUB * k - r                          # [32, 47]
    valid = (lag >= 0) & (lag < TAPS)
    return np.where(valid[None], taps[:, np.clip(lag, 0, TAPS - 1)], 0.0)


def back_mask_blocks(back_mask: np.ndarray) -> np.ndarray:
    """The 11-tap backward-masking FIR as two 6-instant frame taps (Wa, Wb):
    E1[f] = sum_r Wb[r] e0[6 f + r] + sum_r Wa[r] e0[6 (f - 1) + r] with
    Wb[r] = h[5 - r], Wa[r] = h[11 - r] and Wa[0] = 0
    (gstpeaq_tpu/ops/fb_ear.py::_back_mask_blocks)."""
    wb = back_mask[5::-1]
    wa = np.concatenate([[0.0], back_mask[10:5:-1]])
    return np.stack([wa, wb])


class FBEarConsts(nn.Module):
    """Constants of the FB ear model as buffers (CONST_FIELDS): the
    SPECTRUM_FIELDS in the spectrum dtype, the rest in the band dtype.
    fir_weight [80, 32, 47] is the FIR bank's conv weight; lower_matrix
    [40, 40] holds CL^(j-c) for j >= c; back_mask_w [2, 6] the frame taps
    (Wa, Wb).  level is level_factor as a Python float (rounded in the
    spectrum dtype) for the DC kernel; cl = lower_matrix[1, 0], the ratio
    CL of the lower table in the band dtype, which D2's wrapper takes in
    place of the table; slope_a is the slope smoother's decay:
    1 - SLOPE_FILTER_A, or SLOPE_FILTER_A with swap_slope
    (SWAP_SLOPE_FILTER_COEFFICIENTS, src/settings.h:97)."""

    def __init__(self, tensors: dict[str, torch.Tensor],
                 swap_slope: bool = False):
        super().__init__()
        for name in CONST_FIELDS:
            self.register_buffer(name, tensors[name])
        self.band_count = int(self.internal_noise.shape[0])
        self.swap_slope = bool(swap_slope)
        self.slope_a = (C.SLOPE_FILTER_A if swap_slope
                        else 1.0 - C.SLOPE_FILTER_A)
        self.level = float(self.level_factor.item())
        self.cl = float(self.lower_matrix[1, 0])


def consts_from_taps(taps: np.ndarray, values: dict[str, np.ndarray],
                     dtype=torch.float64, device="cpu",
                     swap_slope: bool = False,
                     spectrum_dtype=None) -> FBEarConsts:
    """FBEarConsts from the lag-order taps [80, 1456] and the other fields
    of CONST_FIELDS (all but fir_weight and back_mask_w) as arrays:
    SPECTRUM_FIELDS in `spectrum_dtype` (default `dtype`), the rest in
    `dtype`."""
    spectrum_dtype = spectrum_dtype or dtype
    arrays = dict(values)
    arrays["fir_weight"] = fir_weight(np.asarray(taps))
    arrays["back_mask_w"] = back_mask_blocks(np.asarray(values["back_mask"]))
    tensors = {name: torch.tensor(
        np.asarray(arrays[name]), device=device,
        dtype=spectrum_dtype if name in SPECTRUM_FIELDS else dtype)
        for name in CONST_FIELDS}
    return FBEarConsts(tensors, swap_slope)


def build_consts(params: EP.FBEarParams, dtype=torch.float64, device="cpu",
                 swap_slope: bool = False,
                 spectrum_dtype=None) -> FBEarConsts:
    """The constants the advanced path reads, from EP.fb_ear_params, on
    `device`: the DC stage's and the FIR bank's (SPECTRUM_FIELDS) in
    `spectrum_dtype` (default `dtype`), the band-domain rest in `dtype`.
    This is gstpeaq_tpu/ops/fb_ear.py::build_consts without the TPU's
    phase-split and window-grouped conv kernels."""
    z = C.FB_BAND_COUNT
    idx = np.arange(z)
    expo = idx[:, None] - idx[None, :]                 # [j, c] -> j - c
    lower = np.where(expo >= 0, C.CL ** np.maximum(expo, 0), 0.0)
    values = {
        "back_mask": params.back_mask,
        "internal_noise": params.internal_noise,
        "ear_a": params.ear_time_constants,
        "adapt_a": params.adapt_time_constants,
        "fc": params.fc,
        "lower_matrix": lower,
        "level_factor": params.level_factor,
        "threshold": params.threshold,
        "excitation_threshold": params.excitation_threshold,
        "loudness_factor": params.loudness_factor,
    }
    return consts_from_taps(folded_taps(params), values, dtype, device,
                            swap_slope, spectrum_dtype)


def filter_bank(k: FBEarConsts, hp2: torch.Tensor):
    """The complex FIR bank at every 32nd sample; src/fbearmodel.c:398-435.
    hp2: [..., T], T divisible by 32.  Returns (re, im), each [..., 40, I]
    with I = T / 32: fb[i] = sum_lag h[lag] hp2[32 i - lag], zero history.
    A stride-1 conv1d over 32-sample blocks (see fir_weight)."""
    lead, t = hp2.shape[:-1], hp2.shape[-1]
    x = F.pad(hp2.reshape(-1, t), (FIR_PAD, 0))
    blocks = x.view(x.shape[0], -1, SUB).transpose(1, 2)   # [n, 32, M]
    out = F.conv1d(blocks, k.fir_weight)                   # [n, 80, I]
    out = out.reshape(*lead, 2, C.FB_BAND_COUNT, t // SUB)
    return out[..., 0, :, :].contiguous(), out[..., 1, :, :].contiguous()


def slope_state(k: FBEarConsts, fb_re: torch.Tensor, fb_im: torch.Tensor,
                cu_state: torch.Tensor | None = None) -> torch.Tensor:
    """The slope filter's state cu [..., 40, I]; src/fbearmodel.c:326-339:
    kernel D1.  cu_state: [..., 40], the state before the first instant."""
    return cuda_fb.slope_state(fb_re, fb_im, 24.0 + 230.0 / k.fc,
                               k.slope_a, cu_state)


def spread(k: FBEarConsts, fb_re: torch.Tensor, fb_im: torch.Tensor,
           cu: torch.Tensor) -> torch.Tensor:
    """Upper and lower frequency spreading, E0 [..., 40, I];
    src/fbearmodel.c:340-360: kernel D2, which takes the lower table by its
    ratio k.cl."""
    return cuda_fb.spread_fb(fb_re, fb_im, cu, k.cl)


def back_and_forward_masking(k: FBEarConsts, e0: torch.Tensor,
                             n_frames: int):
    """Backward masking (11-tap FIR sampled at each frame's last instant,
    src/fbearmodel.c:371-383) as two 6-tap frame sums, the internal noise,
    and forward masking over frames (src/fbearmodel.c:388-395): kernel K1.
    e0: [..., 40, I] with I = 6 F.  Returns (excitation, unsmeared), each
    [..., 40, F]."""
    e0f = e0.reshape(*e0.shape[:-1], n_frames, C.FB_FRAMESIZE // SUB)
    wa, wb = k.back_mask_w[0], k.back_mask_w[1]
    sb = torch.sum(e0f * wb, dim=-1)
    sa = torch.sum(e0f * wa, dim=-1)
    e1 = sb + torch.cat([torch.zeros_like(sa[..., :1]), sa[..., :-1]], -1)
    unsmeared = e1 + k.internal_noise[:, None]
    excitation = iir.linear_recurrence_banded(
        k.ear_a, (1.0 - k.ear_a)[:, None] * unsmeared, axis=-1)
    return excitation, unsmeared


def band_chain(k: FBEarConsts, hp2: torch.Tensor, n_frames: int):
    """Everything after the DC stage: FIR bank, slope filter, spreading and
    masking.  hp2: [..., 192 F] in the spectrum dtype.  The FIR bank's
    outputs are cast to the band dtype before D1, D2 and K1, as
    gstpeaq_tpu/ops/fb_ear.py:845 does.  Returns (excitation, unsmeared),
    each [..., 40, F]."""
    band = k.internal_noise.dtype
    fb_re, fb_im = (x.to(band) for x in filter_bank(k, hp2))
    cu = slope_state(k, fb_re, fb_im)
    return back_and_forward_masking(k, spread(k, fb_re, fb_im, cu),
                                    n_frames)


def process_signal(k: FBEarConsts, signal: torch.Tensor, n_frames: int):
    """The whole FB ear model on [..., 192 F] signals: the DC-rejection
    cascade of the level-scaled signal (src/fbearmodel.c:291-303, kernel
    D3) in the spectrum dtype, then band_chain.  Returns (excitation,
    unsmeared), each [..., 40, F], in the band dtype."""
    hp2, _ = cuda_dc.dc_chain(
        signal.to(k.level_factor.dtype).contiguous(), k.level)
    return band_chain(k, hp2, n_frames)
