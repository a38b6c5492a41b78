"""Level and pattern adaptation over all frames at once
(src/leveladapter.c:242-340), in the [..., Z, F] layout: bands second to
last, frames last.

Every per-band state of the reference is a first-order linear recurrence
over frames, so the adapter is three banded recurrence calls (kernels K2
and K1) plus elementwise math and one [Z, Z] band average.
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


def adapt_stage2(a: torch.Tensor, avg_matrix: torch.Tensor,
                 ref_excitation: torch.Tensor, test_excitation: torch.Tensor,
                 ref_filt: torch.Tensor, test_filt: torch.Tensor):
    """The adapter after its stage-1 smoothing (src/leveladapter.c:260-340):
    level correction, the num/den smoothers and the pattern correction,
    from fresh state.  Returns (adapted_ref, adapted_test)."""
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
                        levcorr_ref * levcorr_ref]), axis=-1)
    filt_num, filt_den = nd[0], nd[1]
    num_ge = filt_num >= filt_den
    pattadapt_ref = torch.where(num_ge, 1.0, filt_num / filt_den)
    pattadapt_test = torch.where(num_ge, filt_den / filt_num, 1.0)
    ra = avg_matrix.T @ torch.stack([pattadapt_ref, pattadapt_test])
    pc = iir.linear_recurrence_banded(a, (1.0 - a[:, None]) * ra, axis=-1)
    return levcorr_ref * pc[0], levcorr_test * pc[1]


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
    adapted_ref, adapted_test = adapt_stage2(
        a, avg_matrix, exc2[0], exc2[1], exc_filt[0], exc_filt[1])
    return adapted_ref, adapted_test, mod2, filt_loud
