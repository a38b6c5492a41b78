"""Carry settings, constants, weights and stream states across from the JAX
package.

Each takes plain numpy arrays (`np.asarray` of each JAX leaf) or plain
fields, so this module imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C
from .models.nn import WEIGHT_NAMES, CognitiveModel
from .ops import fb_ear as FB
from .ops.fft_ear import CONST_FIELDS, FFTEarConsts
from .utils.checkpoint import tree_map

# JAX FBEarConsts.h_phase [13, 128, 320]: phase 0's 80 channels hold the
# lag-reversed taps behind this many leading zeros (gstpeaq_tpu/ops/
# fb_ear.py:126-131, _KERNEL_OFF)
_H_PHASE_OFFSET = 81


def settings_from_jax(settings) -> C.Settings:
    """The port's Settings from the JAX package's (any object with the
    same fields): each package takes only its own."""
    return C.Settings(**{f.name: getattr(settings, f.name)
                         for f in dataclasses.fields(C.Settings)})


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


def fb_consts_from_jax(leaves: dict[str, np.ndarray], swap_slope=False,
                       device="cpu") -> FB.FBEarConsts:
    """The port's FB-ear constants from the leaves of the JAX package's
    `FBEarConsts` (its field names; the TPU tilings h_group_kernels and
    back_mask_gemm are not read).  The lag-order FIR taps are recovered
    from h_phase by inverting its phase-0 layout; the dtype is the one of
    internal_noise, the spectrum dtype the one of level_factor."""
    h_phase = np.asarray(leaves["h_phase"])
    n_ch = 2 * C.FB_BAND_COUNT
    kp = h_phase[:, :, :n_ch].transpose(2, 0, 1).reshape(n_ch, -1)
    h_rev = kp[:, _H_PHASE_OFFSET:_H_PHASE_OFFSET + FB.TAPS]
    values = {name: np.asarray(leaves[name]) for name in FB.CONST_FIELDS
              if name not in ("fir_weight", "back_mask_w")}
    dtype = getattr(torch, values["internal_noise"].dtype.name)
    spectrum_dtype = getattr(torch, values["level_factor"].dtype.name)
    return FB.consts_from_taps(h_rev[:, ::-1], values, dtype, device,
                               swap_slope, spectrum_dtype)


def stream_state_from_jax(tree, device="cpu"):
    """A JAX stream's state (`jax.tree.map(np.asarray, stream.state)`: dicts
    and tuples of numpy arrays) as the port's: the same tree of tensors on
    `device`, in the same dtypes.  The layouts are the same, so nothing is
    converted but the arrays."""
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=device),
                    tree)


def stream_state_to_numpy(state):
    """A port stream's state as the same tree of numpy arrays (on the host),
    which a JAX stream takes as its `state`."""
    return tree_map(lambda x: x.detach().cpu().numpy(), state)
