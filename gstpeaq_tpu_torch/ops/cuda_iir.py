"""Banded first-order recurrences: CUDA kernels K1 and K2 and their plain
PyTorch versions.

K1 `recurrence_banded` and K2 `fused_mod_smoothers` (csrc/recurrence.cu)
replace the Pallas TPU kernels of the same names in
gstpeaq_tpu/ops/pallas_iir.py.  Both keep that module's layout: [..., Z, F],
frames last, one contiguous row per (lead, band).

Each kernel scans one row per block in one launch: a row of F frames gets
`block_threads(F)` threads, each scanning a run of RUN frames, so a block
covers a tile of RUN * block_threads(F) frames (at most MAX_TILE) and walks
a longer row tile by tile (csrc/recurrence.cu).

Each wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  Each
counts its launches in a module-level int (`recurrence_banded_launches`,
`fused_mod_smoothers_launches`), so a run can show it went through the
kernels.
"""

from __future__ import annotations

import torch

from . import _build
from .tile_scan import LANES, RUN

MAX_WARPS = 10      # csrc/recurrence.cu's kMaxWarps
MAX_TILE = RUN * LANES * MAX_WARPS

recurrence_banded_launches = 0
fused_mod_smoothers_launches = 0


def block_threads(f: int) -> int:
    """The threads of a row's block for rows of f frames: the fewest whole
    warps, up to MAX_WARPS, whose runs of RUN frames cover the row."""
    return LANES * min(MAX_WARPS, -(-f // (RUN * LANES)))


def recurrence_banded_plain(a: torch.Tensor, b: torch.Tensor,
                            y0: torch.Tensor | None = None) -> torch.Tensor:
    """y_t = a_z * y_{t-1} + b_t along the last axis, y_{-1} = y0 (or 0),
    as a sequential loop over frames.

    a: [Z]; b: [..., Z, F]; y0: broadcastable to b.shape[:-1]."""
    y = torch.empty_like(b)
    prev = torch.zeros(b.shape[:-1], dtype=b.dtype, device=b.device)
    if y0 is not None:
        prev = prev + y0
    for t in range(b.shape[-1]):
        prev = a * prev + b[..., t]
        y[..., t] = prev
    return y


def recurrence_banded(a: torch.Tensor, b: torch.Tensor,
                      y0: torch.Tensor | None = None) -> torch.Tensor:
    """K1: y_t = a_z * y_{t-1} + b_t along the last axis, y_{-1} = y0.

    a: [Z]; b: [..., Z, F] contiguous; y0: broadcastable to b.shape[:-1].
    Returns y with b's shape and dtype."""
    global recurrence_banded_launches
    if b.device.type == "cpu":
        return recurrence_banded_plain(a, b, y0)
    if b.dim() < 2 or a.shape != b.shape[-2:-1]:
        raise ValueError(f"recurrence_banded: a {tuple(a.shape)} does not "
                         f"match b {tuple(b.shape)}")
    operands = {"a": a, "b": b}
    if y0 is not None:
        y0 = operands["y0"] = y0.expand(b.shape[:-1]).contiguous()
    _build.require("recurrence_banded", b, **operands)
    z, f = b.shape[-2], b.shape[-1]
    y = torch.empty_like(b)
    if b.numel() == 0:
        return y
    _build.launch("recurrence_banded", b, a.data_ptr(), b.data_ptr(),
                  None if y0 is None else y0.data_ptr(), y.data_ptr(),
                  b.numel() // f, z, f)
    recurrence_banded_launches += 1
    return y


def fused_mod_smoothers_plain(a: torch.Tensor, exc2: torch.Tensor,
                              uns2: torch.Tensor, scale: float):
    """The level-adapter stage-1 and modulation smoothers (fresh state):
    loud = uns^0.3, deriv = scale * |loud_t - loud_{t-1}| (loud_{-1} = 0),
    three (1 - a)-scaled recurrences over exc, deriv and loud, and
    mod = filt_deriv / (1 + filt_loud / 0.3).

    a: [Z]; exc2/uns2: [..., Z, F] (> 0).  Returns (exc_filt, mod,
    filt_loud), each exc2's shape."""
    loud = uns2 ** 0.3
    prev = torch.cat([torch.zeros_like(loud[..., :1]), loud[..., :-1]], -1)
    deriv = scale * torch.abs(loud - prev)
    drives = (1.0 - a[:, None]) * torch.stack([exc2, deriv, loud])
    filt = recurrence_banded_plain(a, drives)
    exc_filt, filt_deriv, filt_loud = filt[0], filt[1], filt[2]
    return exc_filt, filt_deriv / (1.0 + filt_loud / 0.3), filt_loud


def fused_mod_smoothers(a: torch.Tensor, exc2: torch.Tensor,
                        uns2: torch.Tensor, scale: float):
    """K2: see fused_mod_smoothers_plain.  exc2/uns2 contiguous
    [..., Z, F]."""
    global fused_mod_smoothers_launches
    if exc2.device.type == "cpu":
        return fused_mod_smoothers_plain(a, exc2, uns2, scale)
    if (exc2.dim() < 2 or uns2.shape != exc2.shape
            or a.shape != exc2.shape[-2:-1]):
        raise ValueError(f"fused_mod_smoothers: a {tuple(a.shape)}, exc2 "
                         f"{tuple(exc2.shape)}, uns2 {tuple(uns2.shape)}")
    _build.require("fused_mod_smoothers", exc2, a=a, exc2=exc2, uns2=uns2)
    z, f = exc2.shape[-2], exc2.shape[-1]
    outs = tuple(torch.empty_like(exc2) for _ in range(3))
    if exc2.numel() == 0:
        return outs
    _build.launch("fused_mod_smoothers", exc2, a.data_ptr(), exc2.data_ptr(),
                  uns2.data_ptr(), *(o.data_ptr() for o in outs),
                  exc2.numel() // f, z, f, float(scale))
    fused_mod_smoothers_launches += 1
    return outs
