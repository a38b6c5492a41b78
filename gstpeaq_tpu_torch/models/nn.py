"""Cognitive model: the BS.1387 chapter-6 networks mapping MOVs to DI, and
the ODG squashing (src/nn.c).

`CognitiveModel` holds one network's weights as buffers; `di_basic`,
`di_advanced` and `odg` are the plain functions with the standard's fixed
weights.  The trainable form (gstpeaq_tpu/models/nn.py:61-105) refits the
mapping to subjective scores: its parameters are a dict of leaf tensors,
`sgd_train_step` takes one SGD step with the gradient from
torch.autograd, and parallel/shard.py spreads the examples over devices.
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
    # torch's exp, not exact.exp: training (sgd_train_step) needs its
    # autograd
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


# ---------------------------------------------------------------------------
# Trainable cognitive model (refit the MOV -> DI mapping to subjective scores)
# ---------------------------------------------------------------------------


def init_cognitive_params(advanced: bool = False, dtype=torch.float64,
                          device="cpu") -> dict[str, torch.Tensor]:
    """The standard's weights as trainable leaves (requires_grad)."""
    return {name: torch.tensor(np.asarray(v), dtype=dtype, device=device,
                               requires_grad=True)
            for name, v in zip(WEIGHT_NAMES, _STANDARD[advanced])}


def cognitive_forward(params: dict[str, torch.Tensor],
                      movs: torch.Tensor) -> torch.Tensor:
    """Differentiable DI from the parameters; movs [..., M] -> [...]: the
    network without the clamp."""
    return _di(movs, *(params[name] for name in WEIGHT_NAMES), clamp=False)


def cognitive_loss(params: dict[str, torch.Tensor], movs: torch.Tensor,
                   target_di: torch.Tensor) -> torch.Tensor:
    """MSE on DI: the objective the chapter-6 weights were fitted to."""
    pred = cognitive_forward(params, movs)
    return torch.mean((pred - target_di) ** 2)


def loss_and_grads(params: dict[str, torch.Tensor], movs: torch.Tensor,
                   target_di: torch.Tensor):
    """(loss, {name: gradient}) at `params`, by torch.autograd, with TF32
    off."""
    from ..api import full_precision_matmuls
    with torch.enable_grad(), full_precision_matmuls():
        leaves = {name: p.detach().requires_grad_()
                  for name, p in params.items()}
        loss = cognitive_loss(leaves, movs, target_di)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def sgd_apply(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
              lr: float) -> dict[str, torch.Tensor]:
    """p - lr * g for each parameter, as new trainable leaves."""
    return {name: (p.detach() - lr * grads[name]).requires_grad_()
            for name, p in params.items()}


def sgd_train_step(params: dict[str, torch.Tensor], movs: torch.Tensor,
                   target_di: torch.Tensor, lr: float = 1e-3):
    """One SGD step on the MSE loss.  Returns (new_params, loss)."""
    loss, grads = loss_and_grads(params, movs, target_di)
    return sgd_apply(params, grads, lr), loss
