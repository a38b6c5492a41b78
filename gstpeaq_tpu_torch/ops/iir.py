"""First-order linear recurrences y_t = a_t * y_{t-1} + b_t.

Every stateful stage of the basic model is one: time-domain smearing
(src/fftearmodel.c:496-504), the level-adaptation and modulation smoothers
(src/leveladapter.c:262-332, src/modpatt.c:233-250) and the MFPD filter
(src/movaccum.c:415-422); so are the FB ear's slope filter and the stages
of its DC-rejection cascade.  The banded form (one coefficient per band)
runs kernel K1 on the card; the general form, real or complex, is a
log-depth doubling scan in plain tensor ops (the plain versions of the FB
kernels D1 and D3 use it).
"""

from __future__ import annotations

import torch

from . import cuda_iir


def linear_recurrence(a, b: torch.Tensor, axis: int = 0,
                      y0: torch.Tensor | None = None) -> torch.Tensor:
    """Solve y_t = a_t * y_{t-1} + b_t along `axis` with y_{-1} = y0 (or 0)
    by log2(T) doubling steps.  `a` (a tensor or a Python number, real or
    complex) broadcasts against `b`; returns y with b's shape."""
    a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    aa = torch.movedim(torch.broadcast_to(a, b.shape), axis, 0)
    bb = torch.movedim(b, axis, 0)
    n = bb.shape[0]
    shift = 1
    while shift < n:
        bb = torch.cat([bb[:shift], bb[shift:] + aa[shift:] * bb[:-shift]])
        aa = torch.cat([aa[:shift], aa[shift:] * aa[:-shift]])
        shift *= 2
    if y0 is not None:
        bb = bb + aa * y0.unsqueeze(0)
    return torch.movedim(bb, 0, axis)


def running_max(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Cumulative maximum along `axis`."""
    return torch.cummax(x, dim=axis).values


def linear_recurrence_banded(a: torch.Tensor, b: torch.Tensor, axis: int = 0,
                             y0: torch.Tensor | None = None) -> torch.Tensor:
    """y_t = a_z * y_{t-1} + b_t along `axis`, one coefficient per band.

    The band axis is b's last axis after the recurrence axis is moved last:
    for axis = -1 (the [..., Z, F] layout) it is axis -2, otherwise b's
    last axis.  y0: b's shape without `axis`.  Runs kernel K1 for a CUDA
    tensor and its plain version for a CPU tensor."""
    b2 = torch.movedim(b, axis, -1).contiguous()
    y = cuda_iir.recurrence_banded(a, b2, y0)
    return torch.movedim(y, -1, axis)
