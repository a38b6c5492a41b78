"""Cognitive model: the BS.1387 chapter-6 networks mapping MOVs to DI, and
the ODG squashing (src/nn.c).

`CognitiveModel` holds one network's weights as buffers; `di_basic`,
`di_advanced` and `odg` are the plain functions with the standard's fixed
weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import constants as C

WEIGHT_NAMES = ("amin", "amax", "wx", "wxb", "wy", "wyb")

_STANDARD = {
    False: (C.NN_AMIN_BASIC, C.NN_AMAX_BASIC, C.NN_WX_BASIC, C.NN_WXB_BASIC,
            C.NN_WY_BASIC, C.NN_WYB_BASIC),
    True: (C.NN_AMIN_ADVANCED, C.NN_AMAX_ADVANCED, C.NN_WX_ADVANCED,
           C.NN_WXB_ADVANCED, C.NN_WY_ADVANCED, C.NN_WYB_ADVANCED),
}


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _di(movs, amin, amax, wx, wxb, wy, wyb, clamp):
    m = (movs - amin) / (amax - amin)
    if clamp:
        m = torch.clamp(m, 0.0, 1.0)
    x = wxb + m @ wx
    return wyb + torch.sum(wy * _sigmoid(x), dim=-1)


class CognitiveModel(nn.Module):
    """An M -> H -> 1 sigmoid network: amin/amax [M] scale the MOVs,
    wx [M, H] and wxb [H] feed the hidden layer, wy [H] and the scalar wyb
    the output."""

    def __init__(self, weights: dict[str, torch.Tensor]):
        super().__init__()
        for name in WEIGHT_NAMES:
            self.register_buffer(name, weights[name])

    @classmethod
    def standard(cls, advanced: bool = False, dtype=torch.float64,
                 device="cpu") -> "CognitiveModel":
        """The standard's weights (src/nn.c:40-93)."""
        return cls({name: torch.as_tensor(np.asarray(v), dtype=dtype,
                                          device=device)
                    for name, v in zip(WEIGHT_NAMES, _STANDARD[advanced])})

    def forward(self, movs: torch.Tensor, clamp: bool = False):
        """movs: [..., M] -> DI [...]."""
        return _di(movs, self.amin, self.amax, self.wx, self.wxb, self.wy,
                   self.wyb, clamp)


def di_basic(movs: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """movs: [..., 11] in MOV_BASIC_NAMES order; src/nn.c:186-216."""
    return CognitiveModel.standard(False, movs.dtype, movs.device)(movs, clamp)


def di_advanced(movs: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """movs: [..., 5] in MOV_ADVANCED_NAMES order; src/nn.c:303-335."""
    return CognitiveModel.standard(True, movs.dtype, movs.device)(movs, clamp)


def odg(di: torch.Tensor) -> torch.Tensor:
    """ODG = -3.98 + 4.2 * sigmoid(DI); src/nn.c:371-375."""
    return C.NN_BMIN + (C.NN_BMAX - C.NN_BMIN) * _sigmoid(di)
