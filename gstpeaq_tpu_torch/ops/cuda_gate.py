"""The data-boundary gate: CUDA kernel G1 `frame_gate` (csrc/gate.cu) and its
plain PyTorch version, framing.above_threshold_signal.

G1 is not a TPU kernel.  The JAX package leaves the gate to XLA, which
fuses it under `jit` (gstpeaq_tpu/ops/framing.py:92 above_threshold_signal).
Run eagerly, it is a cast of the signal to the spectrum dtype and then
passes over the whole signal: |x|, four shifted adds, a max over channels,
a concatenation and two block maxima.  G1 reads each sample once, in its
own dtype, and writes each frame's bool once; the source says what bounds
it and what its design does about it.  Its window sums are rounded as the
plain version rounds them and its maxima are exact, so its bits equal the
plain version's.

`gate_plan` is the kernel's host planner: plain Python, so that the CPU
tests hold it.  The wrapper takes the plain version only for a tensor on
the CPU.  For a CUDA tensor it launches the kernel or raises; there is no
fallback.  It counts its launches in `frame_gate_launches`, one per call.
"""

from __future__ import annotations

import typing

import torch

from .. import constants as C
from . import _build
from . import framing
from .cuda_fir import sm_count

# csrc/gate.cu's constants (tests/test_torch_gate.py holds them equal)
THREADS = 256           # a block's threads
RESIDENT = 3            # blocks an SM the grid is sized for
STAGES = 4              # the ring's stages
TILE_BYTES = 16384      # a tile's bytes of samples at most, whole hops
MAX_TILE_HOPS = 32      # a tile's hops at most (one lane of warp 0 each)
MAX_STEP = 4096         # a hop's samples at most
HALO = 4                # the samples a window reaches back
INT_MAX = 2**31 - 1
frame_gate_launches = 0


class GatePlan(typing.NamedTuple):
    """G1's launch: tiles of `tile_hops` hops, each thread's run of `run`
    positions inside a hop (`runs_per_hop` runs cover a hop, the last one
    shorter where `run` does not divide it), each pair's frames cut into
    `spans` spans of `span` frames (the last one shorter), one block a
    span (`grid` blocks), a ring stage of `stage` samples of the input
    type, and `shared` bytes of shared memory a block."""
    tile_hops: int
    run: int
    runs_per_hop: int
    span: int
    spans: int
    grid: int
    stage: int
    shared: int


def gate_plan(pairs: int, channels: int, n_frames: int, step: int,
              fft_form: bool, in_dtype, sms: int) -> GatePlan:
    """G1's plan for `pairs` pairs of `channels` channels, `n_frames`
    frames of hop `step` (the FFT form's frame is two hops, one more hop
    than frames), samples of `in_dtype`, on a card of `sms` SMs.

    A tile is at most TILE_BYTES of samples in whole hops, and each of its
    hops is cut into runs, one a thread, of a multiple of the 16-byte
    vector where the hop is.  The spans aim at RESIDENT blocks an SM: as
    many a pair as fill that many blocks, none reading less than a tile,
    nor fewer than 4 hops in the FFT form (its one hop past a span is then
    at most a quarter of what a block reads where the pairs are few, and a
    small share where they are many).  Raises where no such launch
    exists."""
    size = torch.empty((), dtype=in_dtype).element_size()
    if not 6 <= step <= MAX_STEP or channels < 1 or sms < 1:
        raise ValueError(f"gate_plan: hop {step} (6..{MAX_STEP}), "
                         f"{channels} channels, {sms} SMs")
    tile_hops = max(1, min(MAX_TILE_HOPS, TILE_BYTES // size // step))
    run = -(-step // (THREADS // tile_hops))
    vector = 16 // size
    if step % vector == 0:
        run = -(-run // vector) * vector
    runs_per_hop = -(-step // run)
    # a stage: the tile and its halo, in whole 128-byte lines
    line = 128 // size
    stage = -(-(tile_hops * step + HALO) // line) * line
    # the ring, two buffers of partial tail and full maxima (8 bytes each),
    # the stages' mbarriers
    shared = STAGES * stage * size + 4 * THREADS * 8 + STAGES * 8
    if pairs * n_frames == 0:
        return GatePlan(tile_hops, run, runs_per_hop, 0, 0, 0, stage, shared)
    if pairs > INT_MAX:
        raise ValueError(f"gate_plan: {pairs} pairs exceed a grid of "
                         f"{INT_MAX} blocks")
    span = max(1, max(tile_hops, 4 * fft_form) - int(fft_form),
               -(-n_frames // max(1, sms * RESIDENT // pairs)))
    spans = -(-n_frames // span)
    # the kernel counts a span's items (channels of its tiles) in 32 bits
    if (span + 1) * channels >= INT_MAX:
        raise ValueError(f"gate_plan: spans of {span} frames of "
                         f"{channels} channels")
    return GatePlan(tile_hops, run, runs_per_hop, span, spans, pairs * spans,
                    stage, shared)


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
    hop of 6 to MAX_STEP samples; dtype: the spectrum dtype the samples
    are taken in (None keeps sig's).  Returns bool [..., n_frames]."""
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
    if (sig.dim() < 2 or sig.shape[-2] < 1 or n_frames < 0
            or frame_size not in (step_size, 2 * step_size)
            or not 6 <= step_size <= MAX_STEP or sig.shape[-1] < need):
        raise ValueError(f"frame_gate: sig {tuple(sig.shape)}, {n_frames} "
                         f"frames of {frame_size} by {step_size}: expected "
                         f"[..., CH, T >= {need}] and a frame of one or two "
                         f"hops of 6..{MAX_STEP} samples")
    lead, ch = sig.shape[:-2], sig.shape[-2]
    # every frame is written by the block that owns it: no fill
    out = torch.empty((*lead, n_frames), dtype=torch.bool, device=sig.device)
    # [pairs, CH, T] with the samples contiguous: a view where the leading
    # axes merge (the advanced path's FFT prefix of each signal), else a copy
    x = sig.reshape(-1, ch, sig.shape[-1])
    if x.stride(-1) != 1:
        x = x.contiguous()
    pairs = x.shape[0]
    if pairs * n_frames == 0:
        return out
    plan = gate_plan(pairs, ch, n_frames, step_size, fft_form, x.dtype,
                     sm_count(x.device.index))
    _build.launch("frame_gate", out, x.data_ptr(),
                  int(x.dtype == torch.float64), pairs, ch, x.stride(0),
                  x.stride(1), n_frames, step_size, int(fft_form),
                  C.FRAME_THRESHOLD, plan.tile_hops, plan.run,
                  plan.runs_per_hop, plan.span, plan.spans, plan.stage,
                  plan.shared, out.data_ptr(), dtype=dtype)
    frame_gate_launches += 1
    return out
