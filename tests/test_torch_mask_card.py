"""W1 `mask_frames` (csrc/fb_mask.cu) on a CUDA card against its plain
version, cuda_fb.mask_frames_plain, on the same inputs.

W1 has no CPU form: without a card every test here skips.  This file
imports nothing of JAX or of the JAX package, so that it runs on a machine
with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mask_card.py

(the repository's conftest.py sets JAX up).  Bars: 1e-5 (float32) and
1e-12 (float64) of max|plain|, the kernel's sums rounding in another order
than the plain version's; two launches bit for bit.
"""

import numpy as np
import pytest
import torch

from gstpeaq_tpu_torch import earparams as EP
from gstpeaq_tpu_torch.ops import cuda_fb
from gstpeaq_tpu_torch.ops import fb_ear as FB

pytestmark = pytest.mark.cuda

BARS = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def card() -> str:
    if not torch.cuda.is_available():
        pytest.skip("W1 runs on a CUDA card only; none is present")
    return "cuda"


@pytest.mark.parametrize("frames", [1, 7, 2500])
@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain(card, dtype, with_tail, frames):
    """One launch a call, within BARS of the plain version, the same bits
    twice."""
    rng = np.random.default_rng(frames + with_tail)
    k = FB.build_consts(EP.fb_ear_params(), dtype, card)
    shape = (2, 3, 2, 40)
    e0 = torch.as_tensor(
        rng.uniform(0.1, 10.0, (*shape, 6 * frames))
        * 10.0 ** rng.uniform(-3.0, 3.0, (*shape, 1)), dtype=dtype,
        device=card)
    tail = (torch.as_tensor(rng.uniform(0.1, 10.0, (*shape, FB.E0_TAIL)),
                            dtype=dtype, device=card) if with_tail else None)
    args = (e0, k.back_mask_w, k.internal_noise, k.ear_a, frames, tail)
    before = cuda_fb.mask_frames_launches
    got = cuda_fb.mask_frames(*args)
    assert cuda_fb.mask_frames_launches == before + 1
    want = cuda_fb.mask_frames_plain(*args)
    again = cuda_fb.mask_frames(*args)
    for g, w, a in zip(got, want, again):
        assert g.shape == (*shape, frames) and g.is_contiguous()
        assert torch.isfinite(g).all()
        assert ((g - w).abs().max() / w.abs().max()).item() < BARS[dtype]
        assert torch.equal(g, a)
