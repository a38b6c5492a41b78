"""Level and pattern adaptation over all frames at once
(src/leveladapter.c:242-340), in the [..., Z, F] layout: bands second to
last, frames last.

Every per-band state of the reference is a first-order linear recurrence
over frames, so the adapter is three banded recurrence calls plus
elementwise math and one [Z, Z] band average: K2 and K1 twice in the
one-shot pipelines (level_adapt_fused_mod), K1 three times with carried
state in the streams (level_adapt).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SAMPLING_RATE
from ..ops import cuda_iir
from ..ops import iir


def sliding_average_matrix(band_count: int) -> np.ndarray:
    """Static [Z, Z] matrix for the +-M1/M2 band average;
    src/leveladapter.c:313-325.  out[k] = sum_w in[w] * mat[w, k]."""
    m1c = band_count // 36
    m2c = band_count // 25
    mat = np.zeros((band_count, band_count))
    for k in range(band_count):
        m1 = min(k, m1c)
        m2 = min(band_count - k - 1, m2c)
        mat[k - m1:k + m2 + 1, k] = 1.0 / (m1 + m2 + 1)
    return mat


def _pair(state, i: int, dtype):
    """The stacked (state[i], state[i + 1]) as a recurrence's y0, or
    None."""
    if state is None:
        return None
    return torch.stack([state[i], state[i + 1]]).to(dtype)


def adapt_stage2(a: torch.Tensor, avg_matrix: torch.Tensor,
                 ref_excitation: torch.Tensor, test_excitation: torch.Tensor,
                 ref_filt: torch.Tensor, test_filt: torch.Tensor,
                 state2=None):
    """The adapter after its stage-1 smoothing (src/leveladapter.c:260-340):
    level correction, the num/den smoothers and the pattern correction.
    state2: (filt_num, filt_den, pattcorr_ref, pattcorr_test), each
    [..., Z], or None for a fresh state.  Returns (adapted_ref,
    adapted_test, new_state2)."""
    num = torch.sum(torch.sqrt(ref_filt * test_filt), dim=-2)
    den = torch.sum(test_filt, dim=-2)
    lev_corr = (num * num / (den * den))[..., None, :]   # [..., 1, F]
    louder_ref = lev_corr > 1.0
    levcorr_ref = torch.where(louder_ref, ref_excitation / lev_corr,
                              ref_excitation)
    levcorr_test = torch.where(louder_ref, test_excitation,
                               test_excitation * lev_corr)
    # (48): the drives of the num/den smoothers are NOT scaled by (1 - a);
    # src/leveladapter.c:291-298
    nd = iir.linear_recurrence_banded(
        a, torch.stack([levcorr_test * levcorr_ref,
                        levcorr_ref * levcorr_ref]), axis=-1,
        y0=_pair(state2, 0, levcorr_ref.dtype))
    filt_num, filt_den = nd[0], nd[1]
    num_ge = filt_num >= filt_den
    pattadapt_ref = torch.where(num_ge, 1.0, filt_num / filt_den)
    pattadapt_test = torch.where(num_ge, filt_den / filt_num, 1.0)
    ra = avg_matrix.T @ torch.stack([pattadapt_ref, pattadapt_test])
    pc = iir.linear_recurrence_banded(a, (1.0 - a[:, None]) * ra, axis=-1,
                                      y0=_pair(state2, 2, ra.dtype))
    new_state2 = (filt_num[..., -1], filt_den[..., -1], pc[0][..., -1],
                  pc[1][..., -1])
    return levcorr_ref * pc[0], levcorr_test * pc[1], new_state2


def level_adapt(a: torch.Tensor, avg_matrix: torch.Tensor,
                ref_excitation: torch.Tensor, test_excitation: torch.Tensor,
                state=None):
    """The whole adapter with its state carried, as the streams run it:
    three K1 calls, each on a stacked pair.

    a: [Z]; avg_matrix: [Z, Z] from sliding_average_matrix; ref/test
    excitation: [..., Z, F]; state: the six per-band states (ref_filt,
    test_filt, filt_num, filt_den, pattcorr_ref, pattcorr_test), each
    [..., Z], or None for a fresh state.  Returns (adapted_ref,
    adapted_test, new_state)."""
    filt = iir.linear_recurrence_banded(
        a, (1.0 - a[:, None]) * torch.stack([ref_excitation,
                                             test_excitation]),
        axis=-1, y0=_pair(state, 0, ref_excitation.dtype))
    ref_filt, test_filt = filt[0], filt[1]
    adapted_ref, adapted_test, state2 = adapt_stage2(
        a, avg_matrix, ref_excitation, test_excitation, ref_filt, test_filt,
        None if state is None else state[2:])
    return (adapted_ref, adapted_test,
            (ref_filt[..., -1], test_filt[..., -1]) + state2)


def level_adapt_fused_mod(a: torch.Tensor, avg_matrix: torch.Tensor,
                          exc2: torch.Tensor, uns2: torch.Tensor,
                          step_size: int):
    """Level adaptation of the (ref, test) excitations plus the modulation
    processor of both unsmeared excitations.  The adapter's stage-1
    smoothers and the modulation smoothers run in one call of kernel K2.

    exc2/uns2: [2(sig), ..., Z, F].  Returns
    (adapted_ref, adapted_test, mod2, avg_loud2)."""
    scale = SAMPLING_RATE / step_size
    exc_filt, mod2, filt_loud = cuda_iir.fused_mod_smoothers(
        a, exc2.contiguous(), uns2.contiguous(), scale)
    adapted_ref, adapted_test, _ = adapt_stage2(
        a, avg_matrix, exc2[0], exc2[1], exc_filt[0], exc_filt[1])
    return adapted_ref, adapted_test, mod2, filt_loud
