"""MOV accumulation as masked reductions over the frame axis.

The reference accumulates frame by frame with an INIT / NORMAL / TENTATIVE
state machine per accumulator (src/movaccum.c:304-354).  Over a whole
program that is a closed-form frame mask:

    committed[t] = any(above) & (t_first <= t <= t_last)

with t_first/t_last the first/last above-threshold frames.  Only
MODE_FILTERED_MAX (an IIR) and MODE_AVG_WINDOW (a window over accumulated
frames) keep a trajectory, as a doubling scan and shifted sums below.
"""

from __future__ import annotations

import math

import torch

from ..ops import exact
from ..ops import iir


def activity(above: torch.Tensor):
    """above: [F, ...] bool, one column per pair (and channel) ->
    (has_any [...], active [F, ...], committed [F, ...]), each column on
    its own.

    active[t]:    the accumulator has left INIT at frame t
    committed[t]: frame t's contribution is visible in the final value
    """
    has = torch.any(above, dim=0)
    f = above.shape[0]
    t = torch.arange(f, device=above.device).view(f, *[1] * (above.dim() - 1))
    ints = above.to(torch.int32)          # argmax takes no bool tensor
    t_first = torch.argmax(ints, dim=0)
    t_last = f - 1 - torch.argmax(torch.flip(ints, dims=(0,)), dim=0)
    active = has & (t >= t_first)
    committed = active & (t <= t_last)
    return has, active, committed


def _msum(x, mask):
    """Sum of x over frames where mask, NaN-proof for masked-out entries."""
    return torch.sum(torch.where(mask, x, 0.0), dim=0)


def avg(v, w, mask):
    """MODE_AVG; src/movaccum.c:386-390,450-451.  v/w/mask: [F, ...]."""
    return _msum(w * v, mask) / _msum(w, mask)


def avg_log(v, w, mask):
    """MODE_AVG_LOG; src/movaccum.c:453-455."""
    return 10.0 * exact.log10(_msum(w * v, mask) / _msum(w, mask))


def rms(v, w, mask):
    """MODE_RMS (weight-squared RMS); src/movaccum.c:375-378,458-460."""
    w2 = w * w
    return exact.sqrt(_msum(w2 * v * v, mask) / _msum(w2, mask))


def rms_asym(v, w, mask):
    """MODE_RMS_ASYM (w is the second input);
    src/movaccum.c:380-384,462-466."""
    den = _msum(torch.ones_like(v), mask)
    return (exact.sqrt(_msum(v * v, mask) / den)
            + 0.5 * exact.sqrt(_msum(w * w, mask) / den))


def adb(v, mask):
    """MODE_ADB; src/movaccum.c:471-476.  v/mask: [F, ...]."""
    num = _msum(v, mask)
    den = _msum(torch.ones_like(v), mask)
    value = torch.where(num == 0.0, -0.5,
                        exact.log10(torch.clamp_min(num, 1e-300) / den))
    return torch.where(den > 0, value, 0.0)


def filtered_max(v, called, committed):
    """MODE_FILTERED_MAX; src/movaccum.c:415-422,468-469.

    The 0.9/0.1 IIR advances only on frames where accumulate() is called
    (`called`); the result is the running max of the filter state over
    committed call frames.  v/called/committed: [F, ...].
    """
    a = torch.where(called, v.new_tensor(0.9), v.new_tensor(1.0))
    b = torch.where(called, 0.1 * v, 0.0)
    state = iir.linear_recurrence(a, b, axis=0)
    return torch.amax(torch.where(committed & called, state, 0.0), dim=0)


def avg_window(v, called, committed):
    """MODE_AVG_WINDOW (4-frame sliding window of sqrt, NaN-primed warmup);
    src/movaccum.c:392-413.

    `called` frames must form one contiguous block in each column (true
    for its only user, WinModDiff1B, gated on frame >= 24): the j-th call
    contributes ((sum of the last 4 sqrt values)/4)^4 once j >= 3.  A
    column whose block has gaps would silently mix non-adjacent frames, so
    it gives NaN instead.  v/called/committed: [F, ...].
    """
    rising = (torch.sum((called[1:] & ~called[:-1]).to(torch.int32), dim=0)
              + called[0].to(torch.int32))
    contiguous = rising <= 1
    sq = exact.sqrt(torch.where(called, v, 0.0))

    def shift(x, k):
        return torch.cat([torch.zeros_like(x[:k]), x[:-k]], dim=0)

    winsum = (sq + shift(sq, 1) + shift(sq, 2) + shift(sq, 3)) / 4.0
    contrib = winsum ** 4
    # call index: number of called frames up to t (inclusive) - 1
    call_idx = torch.cumsum(called.to(v.dtype), dim=0) - 1.0
    mask = called & (call_idx >= 3) & committed
    out = exact.sqrt(_msum(contrib, mask) / _msum(torch.ones_like(v), mask))
    return torch.where(contiguous, out, math.nan)
