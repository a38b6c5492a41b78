"""The data-boundary gate: CUDA kernel G1 `frame_gate` (csrc/gate.cu) and its
plain PyTorch version, framing.above_threshold_signal.

G1 is not a TPU kernel.  The JAX package leaves the gate to XLA, which
fuses it under `jit` (gstpeaq_tpu/ops/framing.py:92 above_threshold_signal).
Run eagerly, it is a cast of the signal to the spectrum dtype and then
passes over the whole signal: |x|, four shifted adds, a max over channels,
a concatenation and two block maxima.  G1 reads each sample once, in its
own dtype, and writes one bool a frame; the source says what bounds it and
what its design does about it.  Its window sums are rounded as the plain
version rounds them and its maxima are exact, so its bits equal the plain
version's.

The wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  It
counts its launches in `frame_gate_launches`, one per call.
"""

from __future__ import annotations

import torch

from .. import constants as C
from . import _build
from . import framing

# csrc/gate.cu's tile: 16 KB of the spectrum dtype, whole hops of it
TILE_BYTES = 16384
frame_gate_launches = 0


def frame_gate_plain(sig: torch.Tensor, n_frames: int, frame_size: int,
                     step_size: int, dtype=None) -> torch.Tensor:
    """framing.above_threshold_signal on sig cast to `dtype` (the spectrum
    dtype; None keeps sig's)."""
    return framing.above_threshold_signal(sig.to(dtype or sig.dtype),
                                          n_frames, frame_size, step_size)


def frame_gate(sig: torch.Tensor, n_frames: int, frame_size: int,
               step_size: int, dtype=None) -> torch.Tensor:
    """G1: frame_gate_plain.  sig: [..., CH, T] float32 or float64, its
    samples contiguous (any strides before them), with T at least the
    (n_frames - 1) * step_size + frame_size samples the frames cover;
    frame_size: step_size (the FB form) or 2 * step_size (the FFT form), a
    hop of 6 samples up to a tile (2,048 in float64, 4,096 in float32);
    dtype: the spectrum dtype the samples are taken in (None keeps sig's).
    Returns bool [..., n_frames]."""
    global frame_gate_launches
    dtype = dtype or sig.dtype
    if sig.device.type == "cpu":
        return frame_gate_plain(sig, n_frames, frame_size, step_size, dtype)
    if sig.device.type != "cuda":
        raise ValueError(f"frame_gate: expected a CUDA tensor, got "
                         f"{sig.device}")
    for arg, t in (("sig", sig.dtype), ("dtype", dtype)):
        if t not in (torch.float32, torch.float64):
            raise TypeError(f"frame_gate: {arg} is {t}, expected float32 "
                            "or float64")
    fft_form = frame_size == 2 * step_size
    need = (n_frames + fft_form) * step_size
    tile = TILE_BYTES * 8 // torch.finfo(dtype).bits
    if (sig.dim() < 2 or sig.shape[-2] < 1 or n_frames < 0
            or frame_size not in (step_size, 2 * step_size)
            or not 6 <= step_size <= tile or sig.shape[-1] < need):
        raise ValueError(f"frame_gate: sig {tuple(sig.shape)}, {n_frames} "
                         f"frames of {frame_size} by {step_size}: expected "
                         f"[..., CH, T >= {need}] and a frame of one or two "
                         f"hops of 6..{tile} samples")
    lead, ch = sig.shape[:-2], sig.shape[-2]
    out = torch.zeros((*lead, n_frames), dtype=torch.bool, device=sig.device)
    # [pairs, CH, T] with the samples contiguous: a view where the leading
    # axes merge (the advanced path's FFT prefix of each signal), else a copy
    x = sig.reshape(-1, ch, sig.shape[-1])
    if x.stride(-1) != 1:
        x = x.contiguous()
    pairs = x.shape[0]
    if pairs * n_frames == 0:
        return out
    _build.launch("frame_gate", out, x.data_ptr(),
                  int(x.dtype == torch.float64), pairs, ch, x.stride(0),
                  x.stride(1), n_frames, step_size, int(fft_form),
                  C.FRAME_THRESHOLD, out.data_ptr(), dtype=dtype)
    frame_gate_launches += 1
    return out
