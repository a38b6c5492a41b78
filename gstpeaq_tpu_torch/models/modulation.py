"""Modulation pattern over all frames at once (src/modpatt.c:222-251), in the
[..., Z, F] layout: per band the loudness E^0.3, its scaled absolute
derivative and the loudness itself, both smoothed by first-order
recurrences, which run as one call of kernel K1 on the stacked pair.

The streams (parallel/stream.py) carry the state between chunks; the
one-shot pipelines fuse this processor with the level adapter's stage 1
(level_adapt.level_adapt_fused_mod, kernel K2).
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops import iir


def modulation(a: torch.Tensor, unsmeared_excitation: torch.Tensor,
               step_size: int, state=None):
    """unsmeared_excitation: [..., Z, F] ->
    (modulation, average_loudness, new_state), each of the first two
    [..., Z, F].

    state: (previous_loudness, filtered_derivative, filtered_loudness),
    each [..., Z], the values at the frame before the first; None starts
    from zeros.  new_state: the same at the last frame."""
    derivative_factor = C.SAMPLING_RATE / step_size
    loud = unsmeared_excitation ** 0.3
    if state is None:
        prev0, y0 = torch.zeros_like(loud[..., 0]), None
    else:
        prev0 = state[0].to(loud.dtype)
        y0 = torch.stack([state[1], state[2]]).to(loud.dtype)
    prev = torch.cat([prev0[..., None], loud[..., :-1]], dim=-1)
    deriv = derivative_factor * torch.abs(loud - prev)
    filt = iir.linear_recurrence_banded(
        a, (1.0 - a[:, None]) * torch.stack([deriv, loud]), axis=-1, y0=y0)
    filt_deriv, filt_loud = filt[0], filt[1]
    mod = filt_deriv / (1.0 + filt_loud / 0.3)
    new_state = (loud[..., -1], filt_deriv[..., -1], filt_loud[..., -1])
    return mod, filt_loud, new_state
