"""Filter-bank ear model of the advanced version (src/fbearmodel.c:275-435),
on the flat layout.

A signal [..., T] (T = 192 F) runs through
  DC rejection   the two-stage high-pass cascade: kernel D3;
  FIR bank       40 complex bands evaluated every 32nd sample over each
                 band's nonzero taps: kernel F1 (a product the JAX package
                 leaves to its compiler);
  slope filter   the level-dependent upper slope's smoothed state cu:
                 kernel D1;
  spreading      E0 = |lower(fb + upper(fb, cu))|^2: kernel D2;
  masking        backward masking as two 6-tap frame sums, the internal
                 noise and the forward masking's drive: kernel W1; forward
                 masking a banded recurrence over frames: kernel K1.
The band domain is the JAX package's transposed layout [..., 40, I] (bands
second to last, instants last), and the outputs (excitation, unsmeared)
are [..., 40, F], the MOV tail's layout.

The reference's ring-buffer quirk (the lag-1456 tap reads the newest sample,
gstpeaq_tpu/utils/numpy_ref.py::fb_apply_filter_bank) is kept by folding
that tap into lag 0.

The streams (parallel/stream.py) carry the ear's state between chunks in
the JAX package's tuple (dc_state, hp2_history, cu, (e0_tail, exc)), laid
out as that package lays it out (gstpeaq_tpu/ops/fb_ear.py:757-856), so a
state crosses between the packages unchanged: the DC cascade's D3 state,
the last HIST_LEN samples of hp2, the slope state cu [..., 40] at the last
instant, the last 10 instants of E0 [..., 40, 10] and the forward-masked
excitation [..., 40] at the last frame.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import constants as C
from .. import earparams as EP
from . import cuda_dc
from . import cuda_fb
from . import cuda_fir
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

SUB = cuda_fir.SUB              # 32: one instant every 32 samples
TAPS = cuda_fir.TAPS            # 1456 lags, 0..1455
# the FIR bank as a stride-1 convolution over 32-sample blocks: FIR_BLOCKS
# blocks of window behind FIR_PAD leading zero samples (see fir_weight)
FIR_BLOCKS = cuda_fir.FIR_BLOCKS
FIR_PAD = cuda_fir.FIR_PAD
# the carried FIR history: the JAX package's 1,536 samples (12 blocks of
# 128 for its TPU convs; gstpeaq_tpu/ops/fb_ear.py:72-78), of which the
# bank reads the last FIR_PAD, lags past 1,455 having zero weight
HIST_LEN = 1536
# instants of the e0 tail the backward masking carries
E0_TAIL = 10


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
    fir_weight [80, 32, 47] is the FIR bank's conv weight (its plain
    version's) and fir_plan its kernel's plan (cuda_fir.fir_plan of the
    taps); lower_matrix [40, 40] holds CL^(j-c) for j >= c; back_mask_w
    [2, 6] the frame taps (Wa, Wb).  level is level_factor as a Python
    float (rounded in the spectrum dtype) for the DC kernel; cl =
    lower_matrix[1, 0], the ratio CL of the lower table in the band dtype,
    which D2's wrapper takes in place of the table; slope_a is the slope
    smoother's decay: 1 - SLOPE_FILTER_A, or SLOPE_FILTER_A with
    swap_slope (SWAP_SLOPE_FILTER_COEFFICIENTS, src/settings.h:97)."""

    def __init__(self, tensors: dict[str, torch.Tensor], swap_slope: bool,
                 fir_plan: cuda_fir.FirPlan):
        super().__init__()
        for name in CONST_FIELDS:
            self.register_buffer(name, tensors[name])
        self.fir_plan = fir_plan
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
    return FBEarConsts(tensors, swap_slope, cuda_fir.fir_plan(taps))


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


def filter_bank(k: FBEarConsts, hp2: torch.Tensor,
                history: torch.Tensor | None = None):
    """The complex FIR bank at every 32nd sample; src/fbearmodel.c:398-435:
    kernel F1 (cuda_fir.fir_bank).  hp2: [..., T], T divisible by 32;
    history: [..., HIST_LEN], the samples before hp2, or None for zeros.
    Returns (re, im), each [..., 40, I] with I = T / 32:
    fb[i] = sum_lag h[lag] hp2[32 i - lag]."""
    return cuda_fir.fir_bank(hp2, k.fir_weight, k.fir_plan, history)


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
                             n_frames: int, state=None,
                             return_state: bool = False):
    """Backward masking (11-tap FIR sampled at each frame's last instant,
    src/fbearmodel.c:371-383) as two 6-tap frame sums, the internal noise
    and the forward masking's drive: kernel W1; forward masking over
    frames (src/fbearmodel.c:388-395): kernel K1.
    e0: [..., 40, I] with I = 6 F; state: (e0_tail [..., 40, 10], the
    instants before e0, and exc [..., 40], the excitation before the first
    frame), or None for zeros.  Returns (excitation, unsmeared), each
    [..., 40, F], and with return_state the new state."""
    if state is None:
        e0_tail, exc0 = None, None
    else:
        e0_tail, exc0 = (s.to(e0.dtype) for s in state)
    unsmeared, drive = cuda_fb.mask_frames(
        e0, k.back_mask_w, k.internal_noise, k.ear_a, n_frames, e0_tail)
    excitation = iir.linear_recurrence_banded(k.ear_a, drive, axis=-1,
                                              y0=exc0)
    if not return_state:
        return excitation, unsmeared
    if e0.shape[-1] < E0_TAIL:      # a flush of one frame: 6 instants
        base = (e0_tail if e0_tail is not None
                else e0.new_zeros((*e0.shape[:-1], E0_TAIL)))
        e0 = torch.cat([base, e0], dim=-1)
    return excitation, unsmeared, (e0[..., -E0_TAIL:], excitation[..., -1])


def band_chain(k: FBEarConsts, hp2: torch.Tensor, n_frames: int,
               state=None, return_state: bool = False):
    """Everything after the DC stage: FIR bank, slope filter, spreading and
    masking.  hp2: [..., 192 F] in the spectrum dtype.  The FIR bank's
    outputs are cast to the band dtype before D1, D2 and K1, as
    gstpeaq_tpu/ops/fb_ear.py:845 does.  state: (hp2_history, cu,
    masking_state) as process_signal's, or None.  Returns (excitation,
    unsmeared), each [..., 40, F], and with return_state the new state."""
    band = k.internal_noise.dtype
    history, cu0, mask_state = state if state is not None else (None,) * 3
    fb_re, fb_im = (x.to(band) for x in filter_bank(k, hp2, history))
    cu = slope_state(k, fb_re, fb_im,
                     None if cu0 is None else cu0.to(band))
    out = back_and_forward_masking(k, spread(k, fb_re, fb_im, cu), n_frames,
                                   mask_state, return_state)
    if not return_state:
        return out
    if history is None:
        history = hp2.new_zeros((*hp2.shape[:-1], HIST_LEN))
    history = torch.cat([history.to(hp2.dtype), hp2],
                        dim=-1)[..., -HIST_LEN:]
    return out[0], out[1], (history, cu[..., -1], out[2])


def process_signal(k: FBEarConsts, signal: torch.Tensor, n_frames: int,
                   state=None, return_state: bool = False):
    """The whole FB ear model on [..., 192 F] signals: the DC-rejection
    cascade of the level-scaled signal (src/fbearmodel.c:291-303, kernel
    D3) in the spectrum dtype, then band_chain.  state: the JAX package's
    (dc_state, hp2_history, cu, (e0_tail, exc)) of the samples before
    `signal` (see the module's docstring), or None for a fresh state.
    Returns (excitation, unsmeared), each [..., 40, F], in the band dtype,
    and with return_state the new state."""
    sdtype = k.level_factor.dtype
    dc_state = None if state is None else tuple(
        s.to(sdtype).contiguous() for s in state[0])
    hp2, dc_new = cuda_dc.dc_chain(signal.to(sdtype).contiguous(), k.level,
                                   dc_state)
    out = band_chain(k, hp2, n_frames, None if state is None else state[1:],
                     return_state)
    if not return_state:
        return out
    return out[0], out[1], (dc_new, *out[2])
