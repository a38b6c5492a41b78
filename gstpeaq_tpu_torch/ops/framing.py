"""Framing and the data-boundary threshold test.

Frames are views of the padded [..., CH, T] signals (any leading axes, a
batch of pairs among them): the host pads each pair to the frame count of
its bucket (the GstAdapter drain semantics, src/gstpeaq.c:596-611, with
the final zero-padded flush frame of src/gstpeaq.c:715-745), and the
device cuts [..., CH, F + 1, 1024] hop blocks with a free view; frame f is
blocks[..., f, :] | blocks[..., f + 1, :].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C


def dequantize(sig: torch.Tensor) -> torch.Tensor:
    """PCM16 signals -> float32 as the WAV reader converts them (x / 32768,
    a power of two, so device and host conversions agree bit for bit).
    Float inputs pass through unchanged."""
    if not sig.is_floating_point():
        return sig.to(torch.float32) * (1.0 / 32768.0)
    return sig


def num_frames(n_ref: int, n_test: int, frame_size: int,
               step_size: int) -> int:
    """Frame count under GstAdapter semantics: full frames while both
    signals have one, plus one zero-padded flush frame if either has
    leftover; src/gstpeaq.c:596-611,715-745."""
    n = min(n_ref, n_test)
    full = max(0, (n - frame_size) // step_size + 1) if n >= frame_size else 0
    leftover = max(n_ref, n_test) - full * step_size
    return full + (1 if leftover > 0 else 0)


def padded_length(n_frames: int, frame_size: int, step_size: int) -> int:
    """Signal length needed to extract n_frames frames."""
    return (n_frames - 1) * step_size + frame_size if n_frames else 0


def pad_signal(sig: np.ndarray, n_frames: int, frame_size: int,
               step_size: int) -> np.ndarray:
    """Host side: zero-pad or truncate a [T, CH] signal for n_frames
    frames."""
    length = padded_length(n_frames, frame_size, step_size)
    out = np.zeros((length, sig.shape[1]), dtype=sig.dtype)
    take = min(length, sig.shape[0])
    out[:take] = sig[:take]
    return out


def blocks_hop(sig: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[..., T] -> [..., F + 1, 1024] hop blocks, a view."""
    hop = C.FFT_STEPSIZE
    return sig[..., :(n_frames + 1) * hop].unflatten(-1, (n_frames + 1, hop))


def above_threshold_signal(sig: torch.Tensor, n_frames: int, frame_size: int,
                           step_size: int) -> torch.Tensor:
    """Data-boundary test on the signal (src/gstpeaq.c:1080-1099).

    A frame is above threshold when any 5-sample window [i-4..i] with
    i >= 5 (frame-local) in any channel sums to >= 200/32768.  One 5-term
    shifted sum over |sig|, then per-hop-block maxima: no frame is cut out.

    sig: [..., CH, T] with T = (n_frames - 1) * step_size + frame_size and
    frame_size in {step_size, 2 * step_size}; the channels of each pair
    are reduced.  Returns bool [..., n_frames].
    """
    t = sig.shape[-1]
    a = torch.abs(sig)
    w = (a[..., 4:] + a[..., 3:-1] + a[..., 2:-2] + a[..., 1:-3]
         + a[..., :-4])                                # ends at j = 4..T-1
    m = torch.amax(w, dim=-2)                          # [..., T-4]
    g = torch.cat([m.new_zeros((*m.shape[:-1], 4)), m], dim=-1)  # G[j]
    n_hops = t // step_size
    blocks = g[..., :n_hops * step_size].unflatten(-1, (n_hops, step_size))
    tail_any = torch.amax(blocks[..., 5:], dim=-1) >= C.FRAME_THRESHOLD
    if frame_size == step_size:
        return tail_any[..., :n_frames]
    full_any = torch.amax(blocks, dim=-1) >= C.FRAME_THRESHOLD
    return tail_any[..., :n_frames] | full_any[..., 1:n_frames + 1]
