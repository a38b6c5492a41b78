"""Level and pattern adaptation over all frames at once
(src/leveladapter.c:242-340), in the [..., Z, F] layout: bands second to
last, frames last.

Every per-band state of the reference is a first-order linear recurrence
over frames, so the adapter is three banded recurrence calls with
the elementwise work between them in kernels L1 (the level correction) and
L2 (the pattern adaptation and its band average; ops/cuda_band.py): K2 and
K1 twice in the one-shot pipelines (level_adapt_fused_mod_factors), K1
three times with carried state in the streams (level_adapt_factors).  The
pipelines take the adapter's two factors, lev_corr and the pattern
correction pc, which kernel M1 multiplies where it reads the adapted
excitations; level_adapt, level_adapt_fused_mod and adapt_stage2 form
those in plain tensor ops.

Every operation here has one result for its inputs, on every run and
device: the band sums' square root is ops/exact.py's IEEE one (torch's CPU
sqrt once returned a worker thread's chunk 3e-11 off, which moved one
pair's adapted excitations by up to 6e-12), and the band average is a sum
of shifted slices in a fixed order, where a matrix product would leave
the order to a library.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SAMPLING_RATE
from ..ops import cuda_band
from ..ops import cuda_iir
from ..ops import iir

# the fixed-order band average, kernel L2's plain version's
band_average = cuda_band.band_average


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


def adapt_stage2_factors(a: torch.Tensor, avg_matrix: torch.Tensor,
                         exc2: torch.Tensor, filt2: torch.Tensor,
                         state2=None):
    """The adapter after its stage-1 smoothing (src/leveladapter.c:260-340)
    up to its two factors: the level correction (kernel L1), the num/den
    smoothers (K1), the pattern adaptation (L2) and the pattern-correction
    smoother (K1).  exc2: the (ref, test) excitations [2, ..., Z, F];
    filt2: their stage-1 smoothed excitations; state2: (filt_num,
    filt_den, pattcorr_ref, pattcorr_test), each [..., Z], or None for a
    fresh state.  Returns (lev_corr [..., F], pc [2, ..., Z, F],
    new_state2); the adapted excitations are cuda_band.adapted of them,
    which kernel M1 forms where it reads them."""
    lev_corr, drive = cuda_band.levcorr(exc2, filt2)
    # (48): the drives of the num/den smoothers are NOT scaled by (1 - a);
    # src/leveladapter.c:291-298
    nd = iir.linear_recurrence_banded(
        a, drive, axis=-1, y0=_pair(state2, 0, drive.dtype))
    pc = iir.linear_recurrence_banded(
        a, cuda_band.pattern_adapt(nd, a, avg_matrix), axis=-1,
        y0=_pair(state2, 2, nd.dtype))
    new_state2 = (nd[0][..., -1], nd[1][..., -1], pc[0][..., -1],
                  pc[1][..., -1])
    return lev_corr, pc, new_state2


def adapt_stage2(a: torch.Tensor, avg_matrix: torch.Tensor,
                 ref_excitation: torch.Tensor, test_excitation: torch.Tensor,
                 ref_filt: torch.Tensor, test_filt: torch.Tensor,
                 state2=None):
    """adapt_stage2_factors on separate (ref, test) tensors, with the
    adapted excitations formed in plain tensor ops.  Returns
    (adapted_ref, adapted_test, new_state2)."""
    exc2 = torch.stack([ref_excitation, test_excitation])
    lev_corr, pc, new_state2 = adapt_stage2_factors(
        a, avg_matrix, exc2, torch.stack([ref_filt, test_filt]), state2)
    return (*cuda_band.adapted(exc2, lev_corr, pc), new_state2)


def level_adapt_factors(a: torch.Tensor, avg_matrix: torch.Tensor,
                        exc2: torch.Tensor, state=None):
    """The whole adapter with its state carried, as the streams run it,
    up to its factors: three K1 calls, each on a stacked pair, with L1
    and L2 between them.

    a: [Z]; avg_matrix: [Z, Z] from sliding_average_matrix; exc2: the
    (ref, test) excitations [2, ..., Z, F]; state: the six per-band states
    (ref_filt, test_filt, filt_num, filt_den, pattcorr_ref,
    pattcorr_test), each [..., Z], or None for a fresh state.  Returns
    (lev_corr, pc, new_state) as adapt_stage2_factors, the new state's
    leaves copies that keep no chunk alive."""
    filt = iir.linear_recurrence_banded(
        a, (1.0 - a[:, None]) * exc2, axis=-1,
        y0=_pair(state, 0, exc2.dtype))
    lev_corr, pc, state2 = adapt_stage2_factors(
        a, avg_matrix, exc2, filt, None if state is None else state[2:])
    return (lev_corr, pc,
            tuple(x.clone() for x in (filt[0][..., -1], filt[1][..., -1])
                  + state2))


def level_adapt(a: torch.Tensor, avg_matrix: torch.Tensor,
                ref_excitation: torch.Tensor, test_excitation: torch.Tensor,
                state=None):
    """level_adapt_factors on separate (ref, test) excitations [..., Z, F],
    with the adapted excitations formed in plain tensor ops.  Returns
    (adapted_ref, adapted_test, new_state)."""
    exc2 = torch.stack([ref_excitation, test_excitation])
    lev_corr, pc, new_state = level_adapt_factors(a, avg_matrix, exc2, state)
    return (*cuda_band.adapted(exc2, lev_corr, pc), new_state)


def level_adapt_fused_mod_factors(a: torch.Tensor, avg_matrix: torch.Tensor,
                                  exc2: torch.Tensor, uns2: torch.Tensor,
                                  step_size: int):
    """The level adapter's factors of the (ref, test) excitations plus the
    modulation processor of both unsmeared excitations.  The adapter's
    stage-1 smoothers and the modulation smoothers run in one call of
    kernel K2.

    exc2/uns2: [2(sig), ..., Z, F].  Returns (lev_corr, pc, mod2,
    avg_loud2), the first two as adapt_stage2_factors."""
    scale = SAMPLING_RATE / step_size
    exc_filt, mod2, filt_loud = cuda_iir.fused_mod_smoothers(
        a, exc2.contiguous(), uns2.contiguous(), scale)
    lev_corr, pc, _ = adapt_stage2_factors(a, avg_matrix, exc2, exc_filt)
    return lev_corr, pc, mod2, filt_loud


def level_adapt_fused_mod(a: torch.Tensor, avg_matrix: torch.Tensor,
                          exc2: torch.Tensor, uns2: torch.Tensor,
                          step_size: int):
    """level_adapt_fused_mod_factors with the adapted excitations formed
    in plain tensor ops.  Returns (adapted_ref, adapted_test, mod2,
    avg_loud2)."""
    lev_corr, pc, mod2, filt_loud = level_adapt_fused_mod_factors(
        a, avg_matrix, exc2, uns2, step_size)
    return (*cuda_band.adapted(exc2, lev_corr, pc), mod2, filt_loud)
