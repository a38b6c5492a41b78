"""Carry constants and weights across from the JAX package.

Both take plain numpy arrays (`np.asarray` of each JAX leaf), so this
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.nn import WEIGHT_NAMES, CognitiveModel
from .ops.fft_ear import CONST_FIELDS, FFTEarConsts


def fft_consts_from_jax(leaves: dict[str, np.ndarray],
                        device="cpu") -> FFTEarConsts:
    """The port's FFT-ear constants from the leaves of the JAX package's
    `FFTEarConsts` (its field names; fields the basic path does not read
    are ignored).  Dtypes are kept."""
    tensors = {name: torch.tensor(np.asarray(leaves[name]), device=device)
               for name in CONST_FIELDS}
    group_matrix = np.asarray(leaves["group_matrix"])
    group_bin_hi = int(np.nonzero(group_matrix.any(axis=1))[0].max() + 1)
    return FFTEarConsts(tensors, group_bin_hi)


def cognitive_from_jax(params: dict[str, np.ndarray],
                       device="cpu") -> CognitiveModel:
    """The port's CognitiveModel from the JAX package's
    `nn.init_cognitive_params()` (or trained) parameters."""
    return CognitiveModel({name: torch.tensor(np.asarray(params[name]),
                                              device=device)
                           for name in WEIGHT_NAMES})
