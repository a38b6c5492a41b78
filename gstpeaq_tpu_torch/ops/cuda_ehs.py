"""EHS's per-frame stage: CUDA kernel E1 `ehs_frames` (csrc/ehs.cu) and its
plain PyTorch version, models/movs.py::ehs_values.

E1 is not a TPU kernel.  The JAX package leaves EHS to XLA, as FFTs or as
its DFT-GEMM form (gstpeaq_tpu/models/movs.py:245-299).  Run eagerly, it
is some 28 launches a call over the log-spectral difference d [..., CH,
F, 512] that S2 writes: four cuFFT transforms (three of them for the
lags), their products, a cumsum, the normalisation, the window, a mean,
the powers and their peak.  E1 reads each row of d once and writes its
EHS value: the lags through one complex 512-point transform a row and a
half-length real inverse, a warp a row, on a persistent grid whose rows
are staged into L2 a round ahead by TMA; the source says what bounds it
and what its design does about it.

The wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  It
counts its launches in `ehs_frames_launches`, one per call with a row.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import constants as C
from ..models import movs as MOVS
from . import _build

# csrc/ehs.cu's constants that the launch needs (tests/test_torch_ehs.py
# holds them equal; the rest of its layout the tests read from the source)
ROW = 2 * C.MAXLAG      # d's bins a row
LAGS = C.MAXLAG         # the lags and the window's length
WARPS = 15              # rows a block at most, a warp each
RESIDENT = 1            # blocks an SM
ehs_frames_launches = 0


class EhsGrid(NamedTuple):
    """E1's launch: `per_block` rows a block and round (a warp each),
    `blocks` persistent blocks."""
    per_block: int
    blocks: int


def ehs_grid(rows: int, sms: int) -> EhsGrid:
    """E1's launch for `rows` rows on a card of `sms` SMs: RESIDENT blocks
    an SM at most, each taking as few rows a round as spread the rows over
    all of them, WARPS at most."""
    per_block = max(1, min(WARPS, -(-rows // (RESIDENT * sms))))
    return EhsGrid(per_block, min(-(-rows // per_block), RESIDENT * sms))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ehs_frames(d: torch.Tensor, window: torch.Tensor,
               subtract_dc: bool) -> torch.Tensor:
    """E1: movs.ehs_values.  d: [..., 512] float32 or float64, the
    log-spectral difference of each frame of each channel; window: the
    [256] correlation window in d's dtype; subtract_dc: Settings'
    ehs_subtract_dc_before_window.  Returns the EHS value (x 1000)
    [...], in d's dtype (the kernel computes it in double for both
    dtypes; csrc/ehs.cu says why); no launch where there is no row."""
    global ehs_frames_launches
    if d.shape[:-1].numel() == 0:
        # no frame (a stream's edge): nothing to launch, and the CPU's FFTs
        # take no empty batch
        return d.new_empty(d.shape[:-1])
    if d.device.type == "cpu":
        return MOVS.ehs_values(d, window, subtract_dc)
    if d.device.type != "cuda":
        raise ValueError(f"ehs_frames: expected a CUDA tensor, got "
                         f"{d.device}")
    if d.dim() < 1 or d.shape[-1] != ROW or window.shape != (LAGS,):
        raise ValueError(f"ehs_frames: d {tuple(d.shape)}, window "
                         f"{tuple(window.shape)}: expected [..., {ROW}] and "
                         f"[{LAGS}]")
    x = d.reshape(-1, ROW)
    window = window.contiguous()
    _build.require("ehs_frames", x, window=window)
    x = x.contiguous()
    if x.data_ptr() % 16:
        # the kernel stages its rows into L2 with TMA prefetches, which
        # take 16-byte aligned rows
        x = x.clone()
    out = torch.empty(d.shape[:-1], dtype=d.dtype, device=d.device)
    rows = x.shape[0]
    grid = ehs_grid(rows, _sms(x.device.index))
    _build.launch("ehs_frames", out, x.data_ptr(), window.data_ptr(), rows,
                  int(bool(subtract_dc)), grid.per_block, grid.blocks,
                  out.data_ptr())
    ehs_frames_launches += 1
    return out
