"""FB-ear slope filter, frequency spreading and masking sums: CUDA kernels
D1, D2 and W1 and their plain PyTorch versions.

D1 `slope_state` and D2 `spread_fb` (csrc/fb_spread.cu) replace the Pallas
TPU kernels of gstpeaq_tpu/ops/pallas_fb.py: D1 stands for
`slope_prefixes_from_conv` (K5), D2 for both `spread_apply` (K4) and
`spread_from_conv` (K6).  K5's phase prefixes and K6's phase-major
de-interleave exist only because the TPU splits the instant axis into 4
phases; on the flat layout they compute exactly the slope state cu and the
spread excitation E0.  Both keep the JAX package's transposed FB layout
[..., Z, I]: Z = 40 bands, I subsampled instants, instants last.  What they
compute: src/fbearmodel.c:326-360.

D1 cuts each row into tiles of tile_scan.TILE instants, one block each,
and makes two CUDA launches per call (csrc/fb_spread.cu); the launch plan
(ops/tile_scan.py) and every power a^n of the smoother's decay are computed
on the host, in float64.

D2 stages tiles of consecutive instants of the flat leads x instants axis
in shared memory (any number of leads) and runs one thread per part (real,
imaginary) of each instant.  Its lower table is Toeplitz, lower[j, c] = CL^(j-c) for j >= c,
and the kernel runs the backward recurrence B_c = A_c + CL B_{c+1}; so the
wrapper takes CL (FBEarConsts.cl) alone, and on the CPU the plain version
reads the table cuda_spread_fft.lower_table forms from it, so both paths
compute one function of one input.

W1 `mask_frames` (csrc/fb_mask.cu) is not a TPU kernel: it replaces the
port's eager backward-masking frame sums, internal noise and forward-masking
drive (src/fbearmodel.c:371-395), which the JAX package leaves to XLA
(gstpeaq_tpu/ops/fb_ear.py::back_and_forward_masking_t).  It reads each
instant of E0 once and writes the unsmeared excitation and K1's drive.  A
block of MASK_THREADS threads takes a span of consecutive frames of the
flat rows x frames axis, MASK_FRAMES of its dtype a thread (mask_grid).

Each wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  Each
counts its launches in a module-level int (`slope_state_launches`,
`spread_fb_launches`, `mask_frames_launches`), one per call; W1 launches
nothing where there is no frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from . import _build
from . import exact
from . import iir
from . import tile_scan
from .cuda_spread_fft import lower_table

BANDS = C.FB_BAND_COUNT   # a compile-time constant of spread_fb_kernel
# destination bands per step of spread_fb_plain's upper part: bounds its
# [..., Z, block, I] weight tensor; the result does not depend on it
PLAIN_BLOCK = 8
# instants of one FB frame; of a carried e0 tail, the instants the masking
# reads (the previous frame's 1..5, Wa[0] being 0)
FRAME_INSTANTS = C.FB_FRAMESIZE // C.FB_SUBSAMPLING
TAIL_TAPS = FRAME_INSTANTS - 1
# csrc/fb_mask.cu's kThreads, kFrames and kLead (tests/test_torch_mask.py
# holds them equal): threads a block, frames a thread by dtype, staged
# values before a span
MASK_THREADS = 256
MASK_FRAMES = {torch.float32: 2, torch.float64: 1}
MASK_LEAD = 8
slope_state_launches = 0
spread_fb_launches = 0
mask_frames_launches = 0


def slope_state_plain(fb_re: torch.Tensor, fb_im: torch.Tensor,
                      c1_band: torch.Tensor, a: float,
                      y0: torch.Tensor | None = None) -> torch.Tensor:
    """The slope filter's smoothed state along the instant axis:
        level = 10 log10(re^2 + im^2)
        s     = max(4, c1_band - 0.2 level)
        cu_t  = a cu_{t-1} + (1 - a) DIST^s,   cu_{-1} = y0 (or 0)
    as a doubling scan.  A silent instant gives DIST^inf = 0.

    fb_re/fb_im: [..., Z, I]; c1_band = 24 + 230 / fc: [Z]; a: the
    smoother's decay; y0: [..., Z]."""
    level = 10.0 * exact.log10(fb_re * fb_re + fb_im * fb_im)
    s = torch.clamp_min(c1_band[:, None] - 0.2 * level, 4.0)
    drive = (1.0 - a) * C.DIST ** s
    return iir.linear_recurrence(a, drive, axis=-1, y0=y0).contiguous()


@functools.cache
def slope_factors(a: float, seg: int) -> np.ndarray:
    """D1's coefficients, float64, in the order fb_spread.cu reads them: a
    and each a^n of tile_scan.scan_exponents(seg), then 1 - a.  Read-only:
    it is cached."""
    out = np.array([*tile_scan.real_powers(a, seg), 1.0 - a],
                   dtype=np.float64)
    out.flags.writeable = False
    return out


def slope_state(fb_re: torch.Tensor, fb_im: torch.Tensor,
                c1_band: torch.Tensor, a: float,
                y0: torch.Tensor | None = None) -> torch.Tensor:
    """D1: see slope_state_plain.  fb_re/fb_im: contiguous [..., Z, I].
    Returns cu with fb_re's shape and dtype."""
    global slope_state_launches
    if fb_re.device.type == "cpu":
        return slope_state_plain(fb_re, fb_im, c1_band, a, y0)
    if (fb_re.dim() < 2 or fb_im.shape != fb_re.shape
            or c1_band.shape != fb_re.shape[-2:-1]):
        raise ValueError(f"slope_state: fb_re {tuple(fb_re.shape)}, fb_im "
                         f"{tuple(fb_im.shape)}, c1_band "
                         f"{tuple(c1_band.shape)} do not match")
    operands = {"fb_re": fb_re, "fb_im": fb_im, "c1_band": c1_band}
    if y0 is not None:
        y0 = operands["y0"] = y0.expand(fb_re.shape[:-1]).contiguous()
    _build.require("slope_state", fb_re, **operands)
    z, n = fb_re.shape[-2], fb_re.shape[-1]
    cu = torch.empty_like(fb_re)
    if fb_re.numel() == 0:
        return cu
    rows = fb_re.numel() // n
    tiles, seg, _ = tile_scan.launch_plan(rows, n, "slope_state")
    agg = fb_re.new_empty((rows, tiles))     # each tile's zero-entry end
    coef = slope_factors(float(a), seg)
    _build.launch("slope_state", fb_re, fb_re.data_ptr(), fb_im.data_ptr(),
                  c1_band.data_ptr(), None if y0 is None else y0.data_ptr(),
                  cu.data_ptr(), agg.data_ptr(), rows, z, n, tiles, seg,
                  coef.ctypes.data)
    slope_state_launches += 1
    return cu


def spread_fb_plain(fb_re: torch.Tensor, fb_im: torch.Tensor,
                    cu: torch.Tensor,
                    lower_matrix: torch.Tensor) -> torch.Tensor:
    """E0 = |lower(fb + upper(fb, cu))|^2 in the exp form of the JAX XLA
    path (gstpeaq_tpu/ops/fb_ear.py::spread_t):
        A_j  = fb_j + sum_{i<j} fb_i exp((j - i) log cu_i)
        E0_c = |sum_j lower[j, c] A_j|^2
    The upper part is formed in blocks of PLAIN_BLOCK destination bands.

    fb_re/fb_im/cu: [..., Z, I]; lower_matrix: [Z, Z] (CL^(j-c) for
    j >= c)."""
    z = fb_re.shape[-2]
    dtype, device = fb_re.dtype, fb_re.device
    i_idx = torch.arange(z, device=device)
    log_cu = exact.log(cu)[..., :, None, :]              # [..., Z, 1, I]
    ups_re, ups_im = [], []
    for jb in range(0, z, PLAIN_BLOCK):
        j = torch.arange(jb, min(jb + PLAIN_BLOCK, z), device=device)
        expo = (j[None, :] - i_idx[:, None]).to(dtype)[..., None]
        w = torch.where(expo > 0, exact.exp(expo * log_cu), 0.0)
        ups_re.append(torch.sum(fb_re[..., :, None, :] * w, dim=-3))
        ups_im.append(torch.sum(fb_im[..., :, None, :] * w, dim=-3))
    a_re = lower_matrix.T @ (fb_re + torch.cat(ups_re, dim=-2))
    a_im = lower_matrix.T @ (fb_im + torch.cat(ups_im, dim=-2))
    return a_re * a_re + a_im * a_im


def spread_fb(fb_re: torch.Tensor, fb_im: torch.Tensor, cu: torch.Tensor,
              cl: float) -> torch.Tensor:
    """D2: spread_fb_plain with the lower table CL^(j-c) given by its ratio
    cl.  fb_re/fb_im/cu: contiguous [..., 40, I], any number of leads.
    Returns E0 with fb_re's shape and dtype."""
    global spread_fb_launches
    if fb_re.device.type == "cpu":
        return spread_fb_plain(fb_re, fb_im, cu, lower_table(
            BANDS, cl, fb_re.dtype, fb_re.device))
    if (fb_re.dim() < 2 or fb_re.shape[-2] != BANDS
            or fb_im.shape != fb_re.shape or cu.shape != fb_re.shape):
        raise ValueError(f"spread_fb: fb_re {tuple(fb_re.shape)}, fb_im "
                         f"{tuple(fb_im.shape)}, cu {tuple(cu.shape)} must "
                         f"be [..., {BANDS}, I]")
    _build.require("spread_fb", fb_re, fb_re=fb_re, fb_im=fb_im, cu=cu)
    n = fb_re.shape[-1]
    e0 = torch.empty_like(fb_re)
    if fb_re.numel() == 0:
        return e0
    _build.launch("spread_fb", fb_re, fb_re.data_ptr(), fb_im.data_ptr(),
                  cu.data_ptr(), float(cl), e0.data_ptr(),
                  fb_re.numel() // (BANDS * n), n)
    spread_fb_launches += 1
    return e0


def mask_frames_plain(e0: torch.Tensor, back_mask_w: torch.Tensor,
                      internal_noise: torch.Tensor, ear_a: torch.Tensor,
                      n_frames: int, tail: torch.Tensor | None = None):
    """Backward masking (the 11-tap FIR sampled at each frame's last
    instant, src/fbearmodel.c:371-383) as two 6-tap frame sums, the
    internal noise, and the forward masking's drive (1 - a) E
    (src/fbearmodel.c:388-395):
        e1[f] = sum_r Wb[r] e0[6 f + r] + sum_r Wa[r] e0[6 (f - 1) + r]
    with the frame before the first read from `tail`'s instants 1..5 of
    its last frame (or 0 without one).

    e0: [..., Z, 6 F]; back_mask_w: [2, 6] (Wa, Wb); internal_noise and
    ear_a: [Z]; tail: [..., Z, >= 5], the instants before e0, or None.
    Returns (unsmeared, drive), each [..., Z, F]."""
    e0f = e0.reshape(*e0.shape[:-1], n_frames, FRAME_INSTANTS)
    wa, wb = back_mask_w[0], back_mask_w[1]
    sb = torch.sum(e0f * wb, dim=-1)
    sa = torch.sum(e0f * wa, dim=-1)
    if tail is None:
        prev = torch.zeros_like(sa[..., :1])
    else:
        # the previous frame's instants 1..5 (wa[0] = 0)
        prev = torch.sum(tail[..., -TAIL_TAPS:] * wa[1:], dim=-1,
                         keepdim=True)
    e1 = sb + torch.cat([prev, sa[..., :-1]], -1)
    unsmeared = e1 + internal_noise[:, None]
    return unsmeared, (1.0 - ear_a)[:, None] * unsmeared


def mask_span(dtype) -> int:
    """W1's frames a block in `dtype`."""
    return MASK_THREADS * MASK_FRAMES[dtype]


def mask_grid(frames: int, dtype) -> int:
    """W1's blocks for `frames` frames over all rows in `dtype`: a span of
    mask_span(dtype) a block, the last fewer."""
    return -(-frames // mask_span(dtype))


def mask_frames(e0: torch.Tensor, back_mask_w: torch.Tensor,
                internal_noise: torch.Tensor, ear_a: torch.Tensor,
                n_frames: int, tail: torch.Tensor | None = None):
    """W1: mask_frames_plain.  e0: contiguous [..., Z, 6 F]; tail: [..., Z,
    >= 5] in e0's dtype, or None.  Returns (unsmeared, drive), each
    contiguous [..., Z, F] in e0's dtype; no launch where there is no
    frame."""
    global mask_frames_launches
    if e0.device.type == "cpu":
        return mask_frames_plain(e0, back_mask_w, internal_noise, ear_a,
                                 n_frames, tail)
    z = e0.shape[-2] if e0.dim() >= 2 else 0
    if (e0.dim() < 2 or e0.shape[-1] != FRAME_INSTANTS * n_frames
            or back_mask_w.shape != (2, FRAME_INSTANTS)
            or internal_noise.shape != (z,) or ear_a.shape != (z,)
            or (tail is not None and (tail.shape[:-1] != e0.shape[:-1]
                                      or tail.shape[-1] < TAIL_TAPS))):
        raise ValueError(
            f"mask_frames: e0 {tuple(e0.shape)} of {n_frames} frames, "
            f"back_mask_w {tuple(back_mask_w.shape)}, internal_noise "
            f"{tuple(internal_noise.shape)}, ear_a {tuple(ear_a.shape)}, "
            f"tail {None if tail is None else tuple(tail.shape)} do not "
            "match")
    operands = {"e0": e0, "back_mask_w": back_mask_w,
                "internal_noise": internal_noise, "ear_a": ear_a}
    if tail is not None:
        tail = operands["tail"] = tail[..., -TAIL_TAPS:].contiguous()
    _build.require("mask_frames", e0, **operands)
    shape = (*e0.shape[:-1], n_frames)
    uns = e0.new_empty(shape)
    drive = e0.new_empty(shape)
    frames = uns.numel()
    if frames == 0:
        return uns, drive
    if e0.data_ptr() % 16:
        # the kernel stages e0 in 16-byte loads
        e0 = e0.clone()
    _build.launch("mask_frames", e0, e0.data_ptr(), back_mask_w.data_ptr(),
                  internal_noise.data_ptr(), ear_a.data_ptr(),
                  None if tail is None else tail.data_ptr(), uns.data_ptr(),
                  drive.data_ptr(), frames, n_frames, z,
                  mask_grid(frames, e0.dtype))
    mask_frames_launches += 1
    return uns, drive
