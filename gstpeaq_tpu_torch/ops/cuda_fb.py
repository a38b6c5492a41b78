"""FB-ear slope filter and frequency spreading: CUDA kernels D1 and D2 and
their plain PyTorch versions.

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

Each wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  Each
counts its launches in a module-level int (`slope_state_launches`,
`spread_fb_launches`), one per call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from . import _build
from . import iir
from . import tile_scan
from .cuda_spread_fft import lower_table

BANDS = C.FB_BAND_COUNT   # a compile-time constant of spread_fb_kernel
# destination bands per step of spread_fb_plain's upper part: bounds its
# [..., Z, block, I] weight tensor; the result does not depend on it
PLAIN_BLOCK = 8
slope_state_launches = 0
spread_fb_launches = 0


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
    level = 10.0 * torch.log10(fb_re * fb_re + fb_im * fb_im)
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
    log_cu = torch.log(cu)[..., :, None, :]              # [..., Z, 1, I]
    ups_re, ups_im = [], []
    for jb in range(0, z, PLAIN_BLOCK):
        j = torch.arange(jb, min(jb + PLAIN_BLOCK, z), device=device)
        expo = (j[None, :] - i_idx[:, None]).to(dtype)[..., None]
        w = torch.where(expo > 0, torch.exp(expo * log_cu), 0.0)
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
