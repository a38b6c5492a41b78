#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PEAQ (gstpeaq_tpu_torch) on one NVIDIA GPU
and check it.  Run from the repository root:

    python3 chip_smoke.py        # needs one CUDA card, nvcc, no JAX

Phases, each on its own lines and ending with its seconds:
  1 card      nvidia-smi's name and power limit
  2 build     nvcc builds the kernels K1-K3, D1-D3, F1, S1, S2, G1, L1, L2,
              M1, E1 and W1 from gstpeaq_tpu_torch/csrc, one process per
              source,
              and ptxas reports each kernel's registers and spills
  3 kernels   each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and edge shapes (K1 and K2: the FB
              ear's [2, 2, 40, 2500] and their tile edges F = 1 .. 5121, K1
              with and without y0 and on an all-zero row, K2 with uns
              jumping at every run edge; D1 and D3: their tile edges; K3:
              band counts 1..128; D2: I = 1, 37, 10, 70,000 leads, counts
              off its tiles, rows off their 16-byte boundary; F1, the FB
              ear's FIR bank, against its plain version, the cuDNN conv1d:
              one instant, one row, instant counts off its tiles, a
              history of nonzeros, and the one-hour one shot [4,
              172,800,000] on three 10 s windows; S1 and S2, the FFT
              ear's bin-domain stage, on the pair's own frames, S1 also on
              float64 blocks, one frame and a view, S2 with each call
              site's flags and on rows that take each of its branches:
              silent, identical, a removed bin, a zero test, bandwidth 0,
              and without the bandwidth flag on spectra whose bins from
              group_bin_hi up hold other values (against the plain
              version on the spectra as they were);
              their bandwidth indices and gate bits equal, S1's halves
              within the bars; G1, the data-boundary gate, bit for bit
              against the plain gate, with float32 and float64 samples,
              on the pair's FFT and FB frames and on edge rows: one ulp
              either side of the threshold, windows across a hop
              boundary and at frame-local i < 5, one channel crossing, a
              NaN, mono and 3 channels, rows one sample off 16 bytes (its
              cp.async path), spans ending at the NaN's hop, one frame,
              views; L1, L2 and M1,
              the band-domain epilogues, on the inputs the 10 s pair
              gives them in one peaq() per mode, at every call site, and
              for float32 in the accurate tier too (M1 with float64 NMR
              noise), M1's decisions equal: the disturbed flags, the noise
              loudness's zeroed frames and, by the steps' bar, the
              truncated parts of e); E1, EHS after S2, on the pair's own
              log-spectral differences under each setting of its two
              flags, on rows all zero, with -inf below 256, above it and
              at 511, +inf and NaN, NaN and +inf at 511 alone, d[0:256]
              zero (d0 = 0; exactly 0 where its plain version is), on
              branch_blocks' rows, on frames scaled 1e-30 .. 1e+30 (1e-6
              .. 1e+6 in float), in mono, in 3 channels and on one frame,
              within 1e-10 / 2e-4 a frame; W1, the FB ear's masking sums,
              on the pair's own E0 per pair, without and with a carried
              tail, at F = 1 (the flush), 2 and 5, in 3 bands of 7
              frames (an odd frame count), one value off 16 bytes, and on
              the one-shot 600 s program's E0; and at the
              batch path's shapes (64 pairs basic, 32 advanced, 10 s
              stereo, in their buckets; M1 there also in mono and in 3
              channels) and the streams' chunk shapes (64
              FFT frames, 1,024 FB frames, and the tools' 1,024 FFT
              frames, 16,384 FB frames, each at one stream and at the
              pool's 16; S1, S2 and E1 on each FFT step's blocks, G1 on
              every step's chunk, W1 at each FB step's E0 shape with a
              tail (on D1's cu there and at the batch, which D2's cases
              hold) and its one-frame flush at chunk 64; L1, L2 and M1 on
              the
              inputs of a real
              batch's first microbatch and of each stream path's first
              chunk step) with
              their carried states (K1 and D1 with y0, D3 with
              its state, D1 and D2 on a second FB chunk of the pair's own
              rows; F1 with the first chunk as history), in float32 and
              float64, the float32 DC cascade's own rounding against
              float64, and two launches of every kernel bit for bit, at
              batch and chunk shapes too (F1 at each of its cases)
  4 float64   the basic path: the pinned ODGs 0.171 / -2.007 / -2.007
              (stereo upmix), and a 10 s stereo pair against the NumPy
              spec's float64 results, frozen with the pair's fingerprint in
              tests/golden/torch_pair10_spec.json
  4b float64  the advanced path: the same 10 s pair against the frozen spec
  5 tiers     the basic float32 and accurate tiers on the same pairs: the
              identical sine pair per tier on the card and on the CPU (the
              float32 rDFT's rounding floor lifts float32's bandwidth MOVs;
              accurate's float64 spectra do not), "mixed" equal to float32
  5b float32  the advanced float32 tier against the card's float64
  5c corpus   drift corpus v2 (20 x 10 s stereo, gstpeaq_tpu_torch/utils/
              corpus.py) through float64, float32 and accurate in both
              modes: each tier's worst |dODG| against float64, its item and
              the worst MOV deviation; accurate held within 1e-3 and
              within 1e-5, a bar that float32 (the control) must miss
  6 counters  one basic and one advanced peaq() of the 10 s pair per tier,
              each with the counts set to 0 just before it: the advanced
              call goes through all ten kernels, no conv1d, no plain
              gate, no plain EHS, no irfft (cuFFT C2R) and no eager
              masking sums on the card (every counted run of phases 6 and
              10-13 is held to none);
              then
              one peaq_batch()
              microbatch of 8 and of 32 pairs per mode and tier, which
              launches each kernel as often as one peaq() does (L1 and L2
              once a level adapter, M1 once basic and twice advanced), and
              one
              chunk step of each stream path (basic, advanced FFT,
              advanced FB) per tier, at one stream and at 16
  7 times     CUDA-event medians of each kernel and its plain version in
              float32 and float64, each kernel's share of its bound (also
              at the advanced path's other call-site shapes and at the
              batch shapes), K1's library call (a grouped causal conv1d)
              at each K1 call site, F1 with a bound of its own (the taps
              inside each channel's nonzero window; the uniform conv's
              beside it) and its plain version, the cuDNN conv1d, as its
              library call too, also at the hour's one shot, at each
              count of parts of its groups, and (fir_mma) the FP64 tensor
              cores' rate per f64 mma shape (m8n8k4, m16n8k4, m16n8k8,
              m16n8k16), the card's rate of each library call M1 makes
              (pow, exp, exp2, log10, a quotient) and S2 makes (sqrt,
              log1p) and M1's math floor at each batch site beside its
              bytes bound, S2's bound over the bins its call reads beside
              the one first counted (all 1,025 bins), each kernel
              at the streams' chunk shapes, K1 and K2 on a 10-minute
              program's one-shot FB rows [2, 1, 2, 40, 150000] with their
              plain versions and K1's library call, and peaq() wall time
              per 10 s stereo pair per mode and tier
  8 profile   torch.profiler over five peaq() calls per mode and tier:
              device time per call, its share of the wall time, each hand
              kernel's share of it, and time by kernel
  9 batch     parallel/batch.py's peaq_batch(): 8 corpus v2 pairs cut to
              6-10 s against per-pair peaq() per mode and tier, the int16
              ship against the float one, then 64 x 10 s stereo pairs
              (bench.py's make_pairs; basic in microbatches of 64,
              advanced of 32) per mode and tier: audio-seconds per second
              (gstpeaq_tpu_torch/tools/bench.py), the phases' wall times,
              peak device memory, and from the profiler over one batch the
              device's busy share and the shares of the FIR bank (F1),
              the bin-domain stage (S1, S2), the gate (G1), the band
              epilogues (L1, L2, M1, each), EHS (E1), the FB masking (W1),
              the other hand kernels and the copies to the card; every
              eager site in a record_function range
              (tools/epilogue_sites.py) with the device ms outside them
              and L1's, L2's, M1's, K1's, E1's and W1's device ms, basic
              and advanced float64;
              then, at the basic
              float64 batch's shape with float32 and float64 samples, G1
              and the energy totals summed from S1's halves beside the
              eager passes over the whole signal they replaced, and each
              side's share of that batch's device time
  10 streams  parallel/stream.py on a 10-minute stereo program (drift
              corpus v2's 20 items at 30 s, end to end) fed in 1 s pieces
              at chunk_frames 64: PeaqStream and PeaqStreamAdvanced per
              tier against the same tier's one-shot peaq() (float64 within
              1e-9 ODG and DI and 1e-8 (1 + |w|) per MOV, float32 and
              accurate 5e-4 ODG), current() after minute 1, wall time,
              audio-s/s, the median wall of a chunk step, the device's
              busy share over a few steps, peak memory over minute 1 and
              minute 10 (within 5%) beside the one-shot call's, and each
              kernel's launches (steps x phase 6's counts); a float64
              checkpoint at 5 minutes (utils/checkpoint.py's npz) resumed
              in a fresh stream, bit for bit; PeaqStreamPool of 16 stereo
              60 s streams per mode in float64 against peaq_batch() of the
              same pairs (1e-9 ODG, 1e-9 (1 + |w|) per MOV)
  11 CLI      cli.main() in-process on WAVs the port's wavio wrote, counted
              from 0 per call: the pinned float64 ODGs 0.171 / -2.007 and
              an advanced call, each launching one peaq()'s kernels; `python
              -m gstpeaq_tpu_torch` as a subprocess on the 10 s stereo WAV
              pair per mode, cold (a fresh copy: the kernels build first)
              and warm, wall from process start to exit, sine/sine (0.171)
              and --precision accurate --totalsnr, each in the CLI's line
              format; conformance.run() on a synthetic two-item dataset per
              mode, conformance.main() without the dataset (exit 77); WAV
              read and resample times, the native library against wavio
  12 shard    peaq_sharded() over every CUDA device against peaq_batch()
              (8 corpus pairs: float64 within 1e-12 ODG and (1 + |w|) MOV,
              counted from 0; float32 1e-4 ODG), and both on bench.py's 64
              pairs (audio-s/s); train_cognitive_sharded() of 4,096 MOV
              vectors on the card against the CPU (each step's loss within
              1e-12 relative, the loss falling), a step's wall; a
              PeaqStreamPool of 4 x 20 s over ["cuda:0", "cuda:0"] against
              the pool on one device (1e-12) and its checkpoint, leaf for
              leaf within 1e-12 of each leaf's largest value
  13 tools    gstpeaq_tpu_torch/tools/ through each tool's main() on the
              card, float64, each run counted from 0 and held to its exact
              launches: codec_sweep.py over a manifest of 16 stereo 10 s
              WAV pairs (12 PCM16, 2 float32, 2 PCM16 at 44.1 kHz) per
              mode, with and without --pcm16, each TSV value within 1e-4
              of per-pair peaq() of the pair as loaded; --demo 1000
              --pcm16 per mode (basic microbatch 64, advanced 32), the
              tool's lines, peak device memory, the first 4 items within
              1e-4 of peaq(); longform_bench.py --minutes 60 (chunk 1,024)
              per mode: the rate, peak memory at minute 60 within 5% of
              minute 1 (and over the last two minutes of the first two),
              and, the stream freed, the result within 1e-9 (ODG, DI,
              MOV x (1 + |w|)) of one-shot peaq() of the same program (the
              longest of 60, 30, 15 minutes that fits); pools of 16 x 10
              minutes per mode, fed and --device-source; optimize_settings.py
              on a synthetic two-item dataset, basic

Two lines before the last is one JSON object with each kernel's error,
times, bound and launches: `max_abs_err`, `ms`, `plain_ms`, `bound_ms`,
`bound_by` and `library_ms` in float32 and the same with `_f64` in float64;
`bound_ms` is the larger of the bytes the kernel's function must move
(each input read once, each output written once) over 3.35 TB/s and its
operations over 67 TFLOP/s (float32) or 34 TFLOP/s (float64; F1 67 on
the FP64 tensor cores), counted from this run's main-shape inputs;
`library_ms` is K1's grouped causal conv1d at its main shape and F1's
cuDNN conv1d (its plain version), and null for the other kernels, S1, S2,
G1, L1, L2, M1, E1 and W1 among them, since no single PyTorch call
computes their functions;
`launches_by_path` holds phase 6's
float32 count per path (basic, advanced, and one microbatch of 32 of
each batch path; 0 where a path does not launch the kernel), `launches`
their sum; `batch` lists the kernel's batch shapes, each with its
`max_abs_err`, `ms`, `plain_ms`, `bound_ms`, `bound_by` and
`library_ms` (K1's conv1d there; null for the others), and the same with
`_f64`; `stream` the same at the streams' chunk shapes (`library_ms`
null); `stream_steps` the kernel's launches per chunk step of each stream
path (phase 6), `chunk_shapes` those steps' shapes of its calls and
`tool_chunk_shapes` the same at the tools' chunk of 1,024 FFT frames;
`launches_by_path` also holds phase 10's float64 10-minute streams
(`stream_basic`, `stream_advanced`), phase 11's in-process CLI calls
(`cli_basic`, `cli_advanced`) and phase 12's float64 sharded calls
(`sharded_basic`, `sharded_advanced`) and phase 13's tool runs
(`tools_...`), and K1 and K2 carry `long_row`, phase 7's reading at
[2, 1, 2, 40, 150000] (`ms`, `plain_ms`, `bound_ms`, `bound_by`,
`library_ms`, K1's conv1d there, and the same with `_f64`); F1 carries
`hour`, the same at the one-hour one shot (the uniform conv's bound, the
one this script gave the FIR bank before F1, is printed in phase 7's lines
only).  The line
before the last is the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  Any failed check exits non-zero without
that last line.  Without CUDA the script exits non-zero at once and prints
no result.  Nothing of JAX or of the JAX package gstpeaq_tpu is imported.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import inspect
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import cli
from gstpeaq_tpu_torch import conformance
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch import earparams as EP
from gstpeaq_tpu_torch.models import basic
from gstpeaq_tpu_torch.models import movs as MOVS
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_band
from gstpeaq_tpu_torch.ops import cuda_dc
from gstpeaq_tpu_torch.ops import cuda_ehs
from gstpeaq_tpu_torch.ops import cuda_fb
from gstpeaq_tpu_torch.ops import cuda_fir
from gstpeaq_tpu_torch.ops import cuda_gate
from gstpeaq_tpu_torch.ops import cuda_iir
from gstpeaq_tpu_torch.ops import cuda_spectral
from gstpeaq_tpu_torch.ops import cuda_spread_fft
from gstpeaq_tpu_torch.ops import fb_ear as FB
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.ops import framing
from gstpeaq_tpu_torch.ops import tile_scan
from gstpeaq_tpu_torch.parallel import batch as PB
from gstpeaq_tpu_torch.parallel import shard
from gstpeaq_tpu_torch.parallel import stream as PS
from gstpeaq_tpu_torch.tools import bench as TB
from gstpeaq_tpu_torch.tools import codec_sweep as CS
from gstpeaq_tpu_torch.tools import epilogue_sites as ES
from gstpeaq_tpu_torch.tools import longform_bench as LB
from gstpeaq_tpu_torch.tools import optimize_settings as OS
from gstpeaq_tpu_torch.utils import checkpoint as CK
from gstpeaq_tpu_torch.utils import corpus
from gstpeaq_tpu_torch.utils import native
from gstpeaq_tpu_torch.utils import testsignals as TS
from gstpeaq_tpu_torch.utils import wavio
from gstpeaq_tpu_torch.utils.benchpairs import make_pairs

# the NumPy spec's float64 results on ten_second_pair(), frozen with the
# pair's fingerprint by tests/test_torch_standalone.py
SPEC = pathlib.Path(__file__).resolve().parent / "tests" / "golden" / \
    "torch_pair10_spec.json"

MAIN = (2, 2, 109, 468)      # [sig, CH, Z, F] of a 10 s stereo pair
FB_MAIN = (2, 2, 40, 15000)  # [sig, CH, Z, I] of its FB ear
# the batch path: bench.py's 64 pairs of 10 s stereo, basic in microbatches
# of 64 and advanced of 32, each in its bucket (batch_shapes)
BATCH_PAIRS = 64
MICROBATCH = {"basic": 64, "advanced": 32}
TIERS = ("float64", "float32", "accurate")
DTYPES = (torch.float32, torch.float64)
DTYPES_NP = {torch.float32: np.float32, torch.float64: np.float64}
MODES = ("basic", "advanced")
KERNELS = {
    "recurrence_banded": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/recurrence.cu",
        replaces="gstpeaq_tpu/ops/pallas_iir.py:102"),
    "fused_mod_smoothers": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/recurrence.cu",
        replaces="gstpeaq_tpu/ops/pallas_iir.py:180"),
    "spread_fft": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/spread_fft.cu",
        replaces="gstpeaq_tpu/ops/pallas_spread_fft.py:106"),
    "slope_state": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/fb_spread.cu",
        replaces="gstpeaq_tpu/ops/pallas_fb.py:234"),
    "spread_fb": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/fb_spread.cu",
        replaces="gstpeaq_tpu/ops/pallas_fb.py:123, "
                 "gstpeaq_tpu/ops/pallas_fb.py:311"),
    "dc_chain": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/dc_chain.cu",
        replaces="gstpeaq_tpu/ops/pallas_dc.py:237"),
    # not a TPU kernel: it replaces the port's cuDNN conv1d, standing for
    # the XLA convs of the JAX package's FIR bank (no pallas_call)
    "fir_bank": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/fir_bank.cu",
        replaces="gstpeaq_tpu/ops/fb_ear.py:426"),
    # not TPU kernels either: they replace the port's eager bin-domain
    # stage of the FFT ear, standing for XLA's fusions of the JAX package's
    # stateless_pair_hop and the bin-domain halves of bandwidth, nmr, ehs
    "pair_frames": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/spectral.cu",
        replaces="gstpeaq_tpu/ops/fft_ear.py:473"),
    "spectral_movs": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/spectral.cu",
        replaces="gstpeaq_tpu/ops/fft_ear.py:473, "
                 "gstpeaq_tpu/models/movs.py:65, "
                 "gstpeaq_tpu/models/movs.py:101, "
                 "gstpeaq_tpu/models/movs.py:175"),
    # not a TPU kernel either: it replaces the port's eager data-boundary
    # gate, standing for XLA's fusion of the JAX package's
    # above_threshold_signal
    "frame_gate": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/gate.cu",
        replaces="gstpeaq_tpu/ops/framing.py:92"),
    # nor are these: they replace the port's eager band-domain epilogues,
    # standing for XLA's fusions of the JAX package's level adapter after
    # its stage-1 smoothing (L1 up to the num/den smoothers, L2 between
    # them and the pattern-correction smoother) and of its per-frame MOV
    # terms (M1)
    "levcorr": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/band.cu",
        replaces="gstpeaq_tpu/models/level_adapt.py:45"),
    "pattern_adapt": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/band.cu",
        replaces="gstpeaq_tpu/models/level_adapt.py:45"),
    "band_movs": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/band.cu",
        replaces="gstpeaq_tpu/models/movs.py:20, "
                 "gstpeaq_tpu/models/movs.py:46, "
                 "gstpeaq_tpu/models/movs.py:101, "
                 "gstpeaq_tpu/models/movs.py:136"),
    # nor is this: it replaces the port's eager EHS after S2, standing for
    # XLA's FFTs (or DFT-GEMMs) of the JAX package's ehs
    "ehs_frames": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/ehs.cu",
        replaces="gstpeaq_tpu/models/movs.py:175"),
    # nor is this: it replaces the port's eager backward-masking frame sums,
    # internal noise and forward-masking drive, standing for XLA's fusion
    # of the JAX package's back_and_forward_masking_t and for the GEMMs of
    # its phase-split form
    "mask_frames": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/fb_mask.cu",
        replaces="gstpeaq_tpu/ops/fb_ear.py:593, "
                 "gstpeaq_tpu/ops/fb_ear.py:698"),
}
# the kernels of the bin-domain stage (S1, S2)
SPECTRAL = ("pair_frames", "spectral_movs")
# the kernels of the band-domain epilogues (L1, L2, M1)
BAND = ("levcorr", "pattern_adapt", "band_movs")
COUNTERS = {
    "recurrence_banded": (cuda_iir, "recurrence_banded_launches"),
    "fused_mod_smoothers": (cuda_iir, "fused_mod_smoothers_launches"),
    "spread_fft": (cuda_spread_fft, "spread_fft_launches"),
    "slope_state": (cuda_fb, "slope_state_launches"),
    "spread_fb": (cuda_fb, "spread_fb_launches"),
    "dc_chain": (cuda_dc, "dc_chain_launches"),
    "fir_bank": (cuda_fir, "fir_bank_launches"),
    "pair_frames": (cuda_spectral, "pair_frames_launches"),
    "spectral_movs": (cuda_spectral, "spectral_movs_launches"),
    "frame_gate": (cuda_gate, "frame_gate_launches"),
    "levcorr": (cuda_band, "levcorr_launches"),
    "pattern_adapt": (cuda_band, "pattern_adapt_launches"),
    "band_movs": (cuda_band, "band_movs_launches"),
    "ehs_frames": (cuda_ehs, "ehs_frames_launches"),
    "mask_frames": (cuda_fb, "mask_frames_launches"),
}
# max|kernel - plain| / max|plain| per dtype.  D3 (dc_chain): both sides
# carry the float32 cascade's intrinsic rounding, which the ~833x DC gain of
# each near-unit pole lifts: test_pallas_kernels.py holds K7 against the
# XLA chain at 2e-3 for it, and on an H100 the kernel read 6.2e-4 against
# its plain version on the pair's own rows and 1.2e-3 on the T=49152 noise
# case.  Phase 3 also prints that rounding's own size, the float32
# kernel against the float64 plain version on the same rows.  So float32
# is held at 2e-3.  float64's rounding rises the same way (2.6e-12 read on
# the noise case), so it is held at 1e-10.
BARS = {torch.float32: 1e-5, torch.float64: 1e-12}
DC_BARS = {torch.float32: 2e-3, torch.float64: 1e-10}
# E1 (ehs_frames) frame by frame, |kernel - plain| <= bar max(1, |plain|):
# its transforms round otherwise than the plain version's three cuFFT
# transforms, a normalisation by sqrt(d0 dk) lifts that, and a peak is a
# maximum over ascending bins; and exactly 0 wherever the plain version
# gives 0 on a row that is all zero, has d0 = 0 or holds a NaN or an
# infinity
EHS_BARS = {torch.float32: 2e-4, torch.float64: 1e-10}
# the bound's rates: an H100 SXM's device memory and its peaks outside the
# tensor cores at its full 700 W (NVIDIA's data sheet)
MEMORY_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# F1's operations run on the tensor cores in double (FP64 tensor cores: 67
# TFLOP/s on an H100 SXM); float32 runs outside them, TF32 being off
FIR_PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
# the FB ear's one-shot rows of the one-hour program (phase 13's one shot),
# [rows, T]: F1's largest shape, whose outputs pass 2^31 bytes
HOUR_ROWS = (4, 60 * 60 * C.SAMPLING_RATE)
# peaq_batch() against per-pair peaq() on the card (phase 9): float64
# within 1e-9 in ODG and 1e-9 (1 + |w|) per MOV; float32 and accurate
# within 1e-4 ODG of the same tier's per-pair result
BATCH_BAR = 1e-9
BATCH_TIER_BAR = 1e-4
# corpus v2's worst |dODG| against float64 (phase 5c): the conformance gate
# JAX's "accurate" is held to, and accurate's own bar, which sits between
# its readings on an H100 (4.4e-7 basic, 1.0e-6 advanced) and float32's
# (4.7e-4, 9.6e-4; PERF.md section 6), so that a tier computing its
# spectra in float32 fails it.  float32 is run through the same bar as a
# control that must fail it.
CONFORMANCE_BAR = 1e-3
ACCURATE_BAR = 1e-5
# the streams (parallel/stream.py): chunks of 64 FFT frames (16 x 64 FB
# frames), one stream and the pool's 16 (phases 3, 6, 7 and 10)
STREAM_CHUNK = 64
POOL = 16
# the tools' chunk (gstpeaq_tpu_torch/tools/longform_bench.py's default,
# 1,024 FFT frames, 16,384 FB frames): phases 3, 7 and 13
TOOL_CHUNK = 1024
# each kernel's launches in one chunk step of each stream path, from the
# code: basic, K1 for the time smear, the level adapter's three stacked
# pairs and the modulation of both signals, K3 once on both signals;
# advanced FFT, K1 for the time smear of both signals and K3; advanced FB,
# D3, F1, D1 and D2 once on both signals, K1 for the forward masking, the
# level adapter's three and the modulation; K2 never (its kernel takes no
# state); S1 and S2 once in each FFT step; G1 once in every step; L1 and
# L2 once in each step with a level adapter (basic, FB), M1 once in every
# step (the FFT step's NMR alone); E1 once in each FFT step; W1 once in
# each FB step
STREAM_STEP_LAUNCHES = {
    "basic": {"recurrence_banded": 5, "fused_mod_smoothers": 0,
              "spread_fft": 1, "slope_state": 0, "spread_fb": 0,
              "dc_chain": 0, "fir_bank": 0, "pair_frames": 1,
              "spectral_movs": 1, "frame_gate": 1, "levcorr": 1,
              "pattern_adapt": 1, "band_movs": 1, "ehs_frames": 1,
              "mask_frames": 0},
    "advanced_fft": {"recurrence_banded": 1, "fused_mod_smoothers": 0,
                     "spread_fft": 1, "slope_state": 0, "spread_fb": 0,
                     "dc_chain": 0, "fir_bank": 0, "pair_frames": 1,
                     "spectral_movs": 1, "frame_gate": 1, "levcorr": 0,
                     "pattern_adapt": 0, "band_movs": 1, "ehs_frames": 1,
                     "mask_frames": 0},
    "advanced_fb": {"recurrence_banded": 5, "fused_mod_smoothers": 0,
                    "spread_fft": 0, "slope_state": 1, "spread_fb": 1,
                    "dc_chain": 1, "fir_bank": 1, "pair_frames": 0,
                    "spectral_movs": 0, "frame_gate": 1, "levcorr": 1,
                    "pattern_adapt": 1, "band_movs": 1, "ehs_frames": 0,
                    "mask_frames": 1}}
# each mode's launches in one peaq() (phase 6; the CLI runs one): G1 gates
# the basic path once and the advanced path's FFT and FB frames once each;
# M1 runs once basic, and twice advanced (the FFT path's NMR, the FB path);
# E1 once in each mode (its FFT path); W1 once advanced (its FB path)
PATH_LAUNCHES = {
    "basic": {"recurrence_banded": 3, "fused_mod_smoothers": 1,
              "spread_fft": 1, "slope_state": 0, "spread_fb": 0,
              "dc_chain": 0, "fir_bank": 0, "pair_frames": 1,
              "spectral_movs": 1, "frame_gate": 1, "levcorr": 1,
              "pattern_adapt": 1, "band_movs": 1, "ehs_frames": 1,
              "mask_frames": 0},
    "advanced": {"recurrence_banded": 4, "fused_mod_smoothers": 1,
                 "spread_fft": 1, "slope_state": 1, "spread_fb": 1,
                 "dc_chain": 1, "fir_bank": 1, "pair_frames": 1,
                 "spectral_movs": 1, "frame_gate": 2, "levcorr": 1,
                 "pattern_adapt": 1, "band_movs": 2, "ehs_frames": 1,
                 "mask_frames": 1}}
# phase 10's bars: a float64 stream against the one-shot peaq() of the same
# program, and the float32 / accurate streams against their own one-shot
# (the JAX package's stream bar, tests/test_stream.py:170-184); the pool
# against peaq_batch() of the same pairs
STREAM_BAR = 1e-9
STREAM_MOV_BAR = 1e-8
STREAM_TIER_BAR = 5e-4
POOL_BAR = 1e-9
# a 10-minute program's one-shot FB rows for K1 and K2 (phase 7)
LONG_ROW = (2, 1, 2, C.FB_BAND_COUNT, 150000)


def ops_of(name: str, inputs) -> float:
    """The operations that one call of kernel `name` on its main-shape
    `inputs` needs (a transcendental counted as one).  K3 per row: Z(Z - 1)
    for the upper part's Z(Z - 1)/2 (source, destination) pairs, a multiply
    and an add each in the shift-multiply walk; 2 Z for the lower part, the
    Toeplitz table's backward recurrence L_j = Ene_j + aLe L_{j+1}; and
    15 Z for the per-band quantities and the output: aUCE (2), g_iu (4),
    Ene (4), the walk's ratio (1), E2^2.5 / norm (4).  D2 per instant:
    2 Z(Z - 1) for the complex upper walk, 4 Z for the complex lower
    recurrence B_c = A_c + CL B_{c+1} and 3 Z for |B_c|^2."""
    if name == "pair_frames":
        # per hop sample in each of its two frames: the window on ref (1)
        # and on ref - test (2); its squares and sums into the energies (4)
        return 10 * inputs[0].numel()
    if name == "spectral_movs":
        # per row, over the bins the call reads (inputs[0] is cut to them,
        # movs_case): T (2), pr and pt (8) at each; dp (6) and the noise
        # spectrum (5) below the band runs' end (group_span's); d (4) at
        # each of EHS's 512; a multiply and an add for each band weight
        # (group_weights: 874 at 109 bands, 820 at 55) in each of the three
        # band sums (6)
        spectra, span, weights = inputs[0], inputs[2], inputs[3]
        bins = spectra.shape[-2]
        rows = spectra.numel() // (4 * bins)
        hi = int((span[0] + span[1]).max())
        return rows * (10 * bins + 11 * hi + 4 * cuda_spectral.EHS_BINS
                       + 6 * weights.numel())
    if name == "frame_gate":
        # per sample and channel: |x| (1), the window's four adds (4), the
        # maximum over channels (1) and its hop's two maxima (2)
        return 8 * inputs[0].numel()
    if name in BAND:
        return band_ops(name, inputs)
    if name == "ehs_frames":
        # per row, the real-input FFT form's work (EHS_ROW_OPS)
        return EHS_ROW_OPS * (inputs[0].numel() // cuda_ehs.ROW)
    if name == "mask_frames":
        # per frame: the two 6-tap sums (12 multiplies, 10 adds), e1 and the
        # noise (2), 1 - a and the drive (2)
        return 26 * (inputs[0].numel() // cuda_fb.FRAME_INSTANTS)
    x = inputs[1] if name in ("recurrence_banded",
                              "fused_mod_smoothers") else inputs[0]
    per_element = {"recurrence_banded": 2,      # a y + b
                   # loud, deriv (3), 3 drives, 3 recurrences (6), mod (3)
                   "fused_mod_smoothers": 16,
                   # re^2 + im^2 (3), log10, 10x, s (3), power, (1 - a)x,
                   # the recurrence (2)
                   "slope_state": 12,
                   # scale, ff1 (3), two real poles (4), ff2 (3), the
                   # complex pole (7), 2 Re(g u) (4)
                   "dc_chain": 22}
    if name in per_element:
        return per_element[name] * x.numel()
    z = x.shape[-1] if name == "spread_fft" else x.shape[-2]
    lines = x.numel() // z                      # frame rows, or instants
    if name == "spread_fft":
        return (z * (z - 1) + 2 * z + 15 * z) * lines
    return (2 * z * (z - 1) + 4 * z + 3 * z) * lines


# E1's operations a row, its inputs being real, 2.5 N log2 N a complex
# N-point transform: the 512-point transform of h + i d, both rows in one;
# the conjugate-symmetry split and R = D conj H (10 a bin of 257); the
# pairing of R[k] with R[256 - k] into the even and odd lags' spectra with
# a twiddle (12 a bin of 256); their 256-point complex inverse; ~10 a lag
# (the running update, the normalisation, the mean, the window); the
# window's 128-point transform; its split and powers (15 a bin of 129)
EHS_ROW_OPS = (2.5 * 512 * 9 + 10 * 257 + 12 * 256 + 2.5 * 256 * 8
               + 10 * C.MAXLAG + 2.5 * 128 * 7 + 15 * 129)


def bound(name: str, dtype, inputs, output) -> tuple[float, str]:
    """The least time in ms that the card could take for kernel `name`'s
    function on `inputs` giving `output`, and what sets it: the bytes
    (each input read once, each output written once) over the memory rate,
    or the operations (ops_of) over the peak rate of `dtype`.  D2 reads cu
    of every band but the top one, from which no source walks.  F1's is
    fir_bound's.  `output` is a tensor or a tuple of them (S1's, S2's)."""
    if name == "fir_bank":
        return fir_bound(dtype, inputs, stacked(output))[:2]
    if name == "spread_fb":
        inputs = (*inputs[:2], inputs[2][..., :-1, :])
    moved = sum(t.numel() * t.element_size()
                for t in (*inputs, *tensors_of(output)))
    by_bytes = moved / MEMORY_BYTES_PER_S * 1e3
    by_ops = ops_of(name, inputs) / PEAK_OPS_PER_S[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def spectral_bound_first(dtype, inputs, output) -> float:
    """S2's bound in ms as this script first counted it: all 1,025 bins
    of both spectra read, and 34 operations a bin (~1.5 band weights a bin
    in each of the three band sums), whatever the call's flags.  bound()
    counts only the bins the call reads; phase 7 prints both."""
    spectra = inputs[0]
    rows = spectra.numel() // (4 * spectra.shape[-2])
    full = rows * 4 * cuda_spectral.BINS
    moved = (full * spectra.element_size()
             + sum(t.numel() * t.element_size()
                   for t in (*inputs[1:], *tensors_of(output))))
    by_bytes = moved / MEMORY_BYTES_PER_S * 1e3
    by_ops = 34 * full / 4 / PEAK_OPS_PER_S[dtype] * 1e3
    return max(by_bytes, by_ops)


def fir_bound(dtype, inputs, out) -> tuple[float, str, float]:
    """F1's bound in ms, as bound() gives a kernel's: its bytes (hp2, its
    history where given, and the packed weights read once; re and im,
    stacked in `out`, written once) over the memory rate, or its
    operations over FIR_PEAK_OPS_PER_S: a multiply-add (2) for each tap
    inside a channel's nonzero window (the plan's, 43,578 of the 80 x 1,456
    an instant) at every instant; and what sets it.  Third, the uniform
    conv's bound, as this script printed it before F1: 2 x 80 x 1,456
    operations an instant, and its [80, 32, 47] weight."""
    plan = cuda_fir.fir_plan(FB.folded_taps(EP.fb_ear_params()))
    item = out.element_size()
    signal = sum(t.numel() for t in inputs)
    instants = out.numel() // (2 * C.FB_BAND_COUNT)     # over every row
    window = int((plan.channel_hi - plan.channel_lo).sum())
    times = []
    for weight, taps in ((plan.weights.size, window),
                         (2 * C.FB_BAND_COUNT * FB.SUB * FB.FIR_BLOCKS,
                          2 * C.FB_BAND_COUNT * FB.TAPS)):
        by_bytes = (signal + weight + out.numel()) * item \
            / MEMORY_BYTES_PER_S * 1e3
        by_ops = 2 * taps * instants / FIR_PEAK_OPS_PER_S[dtype] * 1e3
        times.append((by_bytes, "bytes") if by_bytes >= by_ops
                     else (by_ops, "operations"))
    return (*times[0], times[1][0])


def batch_shapes() -> dict:
    """The batch path's buckets for 10 s pairs (compute_buckets, default
    granularity 64) as the kernels' shapes: K1/K2/K3 on the basic batch,
    K2 on the advanced batch's FB frames, D1/D2 on its instants, D3 on its
    rows of 192 n_fb samples."""
    sig = np.zeros((10 * C.SAMPLING_RATE, 2), np.float32)
    n_fft, n_fb = PB.compute_buckets([sig], [sig], advanced=True)
    b, a = MICROBATCH["basic"], MICROBATCH["advanced"]
    return {"basic": (2, b, 2, C.BASIC_BAND_COUNT, n_fft),
            "fb_frames": (2, a, 2, C.FB_BAND_COUNT, n_fb),
            "fb_instants": (2, a, 2, C.FB_BAND_COUNT,
                            n_fb * C.FB_FRAMESIZE // FB.SUB),
            "dc": (2, a, 2, n_fb * C.FB_FRAMESIZE)}


@dataclasses.dataclass
class Case:
    """One kernel case of phase 3: the kernel's wrapper and its plain
    version as functions returning a tensor or a tuple of tensors, and, for
    the main-shape case, the tensors its function reads (for its bound)."""
    name: str
    case: str
    kernel: object
    plain: object
    inputs: tuple = ()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def tensors_of(out) -> list:
    """The tensors of a kernel's output: a tensor, or a tuple of tensors,
    tuples and Nones (S2's Spectral)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out if x is not None for t in tensors_of(x)]


def stacked(out) -> torch.Tensor:
    """A kernel's output as one tensor: stacked where its tensors share a
    shape and a type, else each flattened to float64 (exact for float32 and
    bool) and concatenated, so that torch.equal compares every bit."""
    parts = tensors_of(out)
    if len(parts) == 1:
        return parts[0]
    if all(p.shape == parts[0].shape and p.dtype == parts[0].dtype
           for p in parts):
        return torch.stack(parts)
    return torch.cat([p.reshape(-1).double() for p in parts])


def sleep_cycles_per_ms() -> float:
    """The rate of torch.cuda._sleep on this card, between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def cuda_ms(fn, calls: int, rounds: int = 10, cover_host: bool = False,
            warmup: int = 3) -> tuple[float, float]:
    """Device time of one fn() in ms between CUDA events: the median over
    `rounds` of the mean of `calls` back-to-back calls, after `warmup`
    calls.
    Each round is queued behind a sleep kernel of ~1 ms, so that the host's
    launch overhead is hidden wherever fn() keeps the device busier than
    the host; a host-bound fn() (the plain recurrences' frame loops) is
    timed at its host-bound rate.  With `cover_host` the sleep outlasts
    the host's enqueue of a whole round, so that the time is the device's
    own (D3's wrapper enqueues five launches and packs a state).  Also
    returns the median host time to enqueue one fn()."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter()
    for _ in range(calls):
        fn()
    round_ms = (time.perf_counter() - host) * 1e3
    torch.cuda.synchronize()
    sleep = 2_000_000
    if cover_host:
        sleep = max(sleep, int(2.0 * round_ms * sleep_cycles_per_ms()))
    times, hosts = [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        host = time.perf_counter()
        for _ in range(calls):
            fn()
        hosts.append((time.perf_counter() - host) * 1e3 / calls)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), statistics.median(hosts)


def phase_card() -> str:
    print("phase 1 card", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {card}")
    return card


def phase_build() -> None:
    print("phase 2 build", flush=True)
    path, seconds = _build.build()
    _build.library()
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}, one process per source: "
          f"{path.name} in {seconds:.1f} s")
    # ptxas: each kernel's registers and spills, per working type and
    # int template argument: D3's five launches per step, D2 per values a
    # copy
    entry, spills = None, ""
    names = "|".join(KERNELS)
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"({names})(?:_([a-z]+))?_kernelI"
                          rf"((?:L[ib]\d+E)*)([fd]+)((?:L[ib]\d+E)*)", line)
            lead = m and re.findall(r"L[ib](\d+)E", m[3])
            ints = m and re.findall(r"L[ib](\d+)E", m[5])
            labels = (("copies of",) if m and m[1] == "spread_fb" else
                      ("window",) if m and m[1] == "pattern_adapt" else
                      ("16-byte loads",) if m and m[1] == "frame_gate" else
                      ("step",))
            # M1: rows a tile, the FB site's sets, the ring's stages
            firsts = (("rows", "fb", "stages") if m and m[1] == "band_movs"
                      else ("arg",) * 8)
            entry = m and " ".join(
                [m[1]] + ([m[2]] if m[2] else [])
                + ["->".join("double" if c == "d" else "float"
                            for c in m[4])]
                + [f"{label} {i}" for label, i in zip(firsts, lead)]
                + [f"{label} {i}" for label, i in zip(labels, ints)])
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "Used" in line:
            print(f"  {entry}: {line.split(':', 1)[1].strip()}; {spills}")
            entry = None


def fb_rows(pair10, k) -> torch.Tensor:
    """The 10 s pair's FB-path input [2(ref, test), CH, 480000] on the card
    in k's spectrum dtype, the DC stage's."""
    return torch.stack([
        torch.as_tensor(np.ascontiguousarray(sig.T), device="cuda")
        for sig in pair10]).to(k.level_factor.dtype)


def dc_out(out) -> torch.Tensor:
    """dc_chain's (hp2, state) as one flat tensor."""
    return torch.cat([out[0].reshape(-1), torch.cat(out[1], -1).reshape(-1)])


def fir_case(k, label: str, x, hist=None, inputs=()) -> Case:
    """F1 on hp2 rows x (with history rows hist, or none) against its plain
    version, the cuDNN conv1d in IEEE float32 (TF32 off) or double."""
    def plain():
        with api.full_precision_matmuls():
            return cuda_fir.fir_bank_plain(x, k.fir_weight, hist)
    return Case("fir_bank", label,
                lambda: cuda_fir.fir_bank(x, k.fir_weight, k.fir_plan,
                                          hist),
                plain, inputs)


def fir_cases(k, hp2, t) -> list:
    """F1 at the per-pair shape (the pair's own hp2, [2, CH, 480000]: 4
    rows, no history) and at its edges, from a generator of their own: one
    instant on one row and on two, instant counts just past a tile of
    either dtype (128 double, 512 float instants) and off both, each with
    a history of nonzeros and without."""
    cases = [fir_case(k, "main", hp2, None, (hp2,))]
    frng = np.random.default_rng(12)
    for rows, n in ((1, 1), (2, 1), (1, 129), (3, 513), (2, 1000)):
        x = t(frng.standard_normal((rows, FB.SUB * n)) * 100.0)
        hist = t(frng.standard_normal((rows, FB.HIST_LEN)) * 100.0)
        for h in (None, hist):
            cases.append(fir_case(k, f"[{rows}, {FB.SUB * n}] history="
                                  f"{h is not None}", x, h))
    return cases


def mask_case(k, label: str, e0, tail=None,
              bands: int = C.FB_BAND_COUNT) -> Case:
    """W1 on E0 [..., Z, 6 F] (with a carried tail [..., Z, >= 5], or
    none) against its plain version, with the FB ear's taps and its first
    `bands` bands' noise and decay; its inputs for the bound."""
    noise, ear_a = k.internal_noise[:bands], k.ear_a[:bands]
    frames = e0.shape[-1] // cuda_fb.FRAME_INSTANTS
    return Case("mask_frames", label + " tail" * (tail is not None),
                lambda: cuda_fb.mask_frames(e0, k.back_mask_w, noise, ear_a,
                                            frames, tail),
                lambda: cuda_fb.mask_frames_plain(e0, k.back_mask_w, noise,
                                                  ear_a, frames, tail),
                (e0, k.back_mask_w, noise, ear_a,
                 *(() if tail is None else (tail[..., -cuda_fb.TAIL_TAPS:],))))


# the one-shot program of phase 7's long rows: its E0 instants a row
ONE_SHOT_INSTANTS = LONG_ROW[-1] * cuda_fb.FRAME_INSTANTS


def one_shot_e0(e0) -> torch.Tensor:
    """E0 [2, 1, 2, 40, ONE_SHOT_INSTANTS] of a 10-minute program: the 10 s
    pair's own E0 (per pair) tiled in time."""
    return e0.repeat(1, 1, 1, 1, ONE_SHOT_INSTANTS // e0.shape[-1])


def mask_cases(k, e0) -> list:
    """W1 per pair on the 10 s pair's own E0 [2, 1, 2, 40, 15000] (the main
    case), with a carried tail (the E0's own last instants), at F = 1 (a
    stream's flush), 2 and 5 with and without a tail, in 3 bands of 7
    frames (21 frames in all: a ragged end of float instants), on rows one
    value off their 16-byte boundary, and at the one-shot 600 s program's
    [2, 1, 2, 40, 900000]."""
    tail = e0[..., -FB.E0_TAIL:].contiguous()
    cases = [mask_case(k, "main", e0),
             mask_case(k, f"{list(e0.shape)}", e0, tail)]
    for f in (1, 2, 5):
        x = e0[..., :cuda_fb.FRAME_INSTANTS * f].contiguous()
        for tl in (None, tail):
            cases.append(mask_case(k, f"F={f} {list(x.shape)}", x, tl))
    x = e0[0, 0, 0, :3, :42].contiguous()
    for tl in (None, tail[0, 0, 0, :3]):
        cases.append(mask_case(k, f"Z=3 {list(x.shape)}", x, tl, 3))
    skew = torch.cat([e0.new_zeros(1), e0.reshape(-1)])[1:].view(e0.shape)
    cases.append(mask_case(k, f"{list(e0.shape)} data 1 value on", skew,
                           tail))
    # the one-shot E0 (1.15 GB in double) is made anew for each call, so
    # that no case holds it through phase 3
    args = (k.back_mask_w, k.internal_noise, k.ear_a, LONG_ROW[-1])
    cases.append(Case("mask_frames", f"one shot 600 s "
                      f"{[*e0.shape[:-1], ONE_SHOT_INSTANTS]}",
                      lambda: cuda_fb.mask_frames(one_shot_e0(e0), *args),
                      lambda: cuda_fb.mask_frames_plain(one_shot_e0(e0),
                                                        *args)))
    return cases


def fb_cases(dtype, rng, pair10, t):
    """D1-D3, F1 and W1 cases: the main path's shapes on the 10 s pair's
    own FB signals (hp2 and fb from the plain DC stage and the FIR bank,
    E0 from D2's plain version), and edges with silent instants, carried
    states and both slope conventions; F1's (fir_cases) and W1's
    (mask_cases)."""
    k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
    c1 = 24.0 + 230.0 / k.fc
    x = fb_rows(pair10, k)
    hp2, _ = cuda_dc.dc_chain_plain(x, k.level)
    cases = fir_cases(k, hp2, t)
    re, im = FB.filter_bank(k, hp2)                     # FB_MAIN
    check(re.shape == FB_MAIN, f"FB shape {tuple(re.shape)}")
    cu = cuda_fb.slope_state_plain(re, im, c1, k.slope_a)
    swap = 1.0 - k.slope_a
    y0 = t(rng.uniform(0.0, 0.5, FB_MAIN[:-1]))
    for case, a, y in (("main", k.slope_a, None), ("main y0 swap", swap, y0)):
        cases.append(Case("slope_state", case,
                          lambda a=a, y=y: cuda_fb.slope_state(
                              re, im, c1, a, y),
                          lambda a=a, y=y: cuda_fb.slope_state_plain(
                              re, im, c1, a, y),
                          (re, im, c1)))
    cases.append(Case("spread_fb", "main",
                      lambda: cuda_fb.spread_fb(re, im, cu, k.cl),
                      lambda: cuda_fb.spread_fb_plain(re, im, cu,
                                                      k.lower_matrix),
                      (re, im, cu)))
    # W1 on the pair's own E0 in the per-pair layout [2, 1, CH, 40, I]
    cases += mask_cases(k, cuda_fb.spread_fb_plain(
        re, im, cu, k.lower_matrix).unsqueeze(1))
    for n in (37, 1):
        er = rng.standard_normal((2, 40, n)) * 100.0
        ei = rng.standard_normal((2, 40, n)) * 100.0
        er[..., 0] = ei[..., 0] = 0.0                  # a silent instant
        er, ei = t(er), t(ei)
        ecu = t(rng.uniform(0.2, 0.9, (2, 40, n)))
        ey0 = t(rng.uniform(0.0, 0.5, (2, 40)))
        for a, y in ((k.slope_a, None), (swap, ey0)):
            cases.append(Case("slope_state", f"I={n} a={a:.4f} "
                              f"y0={y is not None}",
                              lambda a=a, y=y, er=er, ei=ei:
                              cuda_fb.slope_state(er, ei, c1, a, y),
                              lambda a=a, y=y, er=er, ei=ei:
                              cuda_fb.slope_state_plain(er, ei, c1, a, y)))
        cases.append(Case("spread_fb", f"I={n}",
                          lambda er=er, ei=ei, ecu=ecu:
                          cuda_fb.spread_fb(er, ei, ecu, k.cl),
                          lambda er=er, ei=ei, ecu=ecu:
                          cuda_fb.spread_fb_plain(er, ei, ecu,
                                                  k.lower_matrix)))
    # D2's tiles, from a generator of its own: more leads than a grid's y
    # extent holds (65,535); lead x instant counts that are not a multiple
    # of a tile's 64 / 32 instants; copies of two instants (I = 10) and of
    # one (rows that start off their 16-byte boundary)
    grng = np.random.default_rng(8)
    for shape, skew in (((70000, 40, 3), 0), ((5, 40, 7), 0),
                        ((9, 40, 13), 0), ((3, 40, 10), 0), ((2, 40, 12), 1)):
        er, ei, ecu = (t(np.concatenate([np.zeros(skew), x.ravel()]))[skew:]
                       .view(shape) for x in (
                           grng.standard_normal(shape) * 100.0,
                           grng.standard_normal(shape) * 100.0,
                           grng.uniform(0.2, 0.9, shape)))
        cases.append(Case("spread_fb", f"{list(shape)}"
                          + (f" data {skew} value on" if skew else ""),
                          lambda er=er, ei=ei, ecu=ecu:
                          cuda_fb.spread_fb(er, ei, ecu, k.cl),
                          lambda er=er, ei=ei, ecu=ecu:
                          cuda_fb.spread_fb_plain(er, ei, ecu,
                                                  k.lower_matrix)))
    x4 = x.reshape(4, -1)
    state = tuple(t(rng.standard_normal((4, 2))) for _ in range(4))
    noise = t(rng.standard_normal((2, 49152)) * 2500.0)
    for case, xx, lf, st in (("main", x4, k.level, None),
                             ("main state", x4, k.level, state),
                             ("noise T=49152", noise, 0.0357, None)):
        cases.append(Case("dc_chain", case,
                          lambda xx=xx, lf=lf, st=st:
                          dc_out(cuda_dc.dc_chain(xx, lf, st)),
                          lambda xx=xx, lf=lf, st=st:
                          dc_out(cuda_dc.dc_chain_plain(xx, lf, st)),
                          (xx,)))
    for n in (1000, 1):
        xe = t(rng.standard_normal((2, n)) * 2500.0)
        for st in (None, tuple(s[:2] for s in state)):
            cases.append(Case("dc_chain", f"T={n} state={st is not None}",
                              lambda xe=xe, st=st:
                              dc_out(cuda_dc.dc_chain(xe, 0.0357, st)),
                              lambda xe=xe, st=st:
                              dc_out(cuda_dc.dc_chain_plain(xe, 0.0357,
                                                            st))))
    # D3's tile edges, on three rows from a generator of their own (the
    # other cases keep their inputs): below, at and past one tile, a last
    # tile of one or two samples, and 33 tiles, two per lane of the fold of
    # the earlier tiles' carries
    erng = np.random.default_rng(3)
    tile = tile_scan.TILE
    for n in (tile - 1, tile, tile + 1, 2 * tile + 1, 3 * tile + 2,
              32 * tile + 1):
        xe = t(erng.standard_normal((3, n)) * 2500.0)
        for st in (None, tuple(t(erng.standard_normal((3, 2)))
                               for _ in range(4))):
            cases.append(Case("dc_chain", f"T={n} state={st is not None}",
                              lambda xe=xe, st=st:
                              dc_out(cuda_dc.dc_chain(xe, 0.0357, st)),
                              lambda xe=xe, st=st:
                              dc_out(cuda_dc.dc_chain_plain(xe, 0.0357,
                                                            st))))
    return cases + slope_edges(t, c1[:3], k.slope_a)


def slope_edges(t, c1, a):
    """D1's tile edges on 3 rows, from a generator of their own: below, at
    and past one tile, a last tile of one instant, and 34 tiles (folded two
    a lane); each with and without a carried y0, in both slope conventions,
    with a silent instant at the start of every tile."""
    cases = []
    srng = np.random.default_rng(4)
    tile = tile_scan.TILE
    for n in (tile - 1, tile, tile + 1, 2 * tile + 1, 33 * tile + 1):
        er = srng.standard_normal((3, n)) * 100.0
        ei = srng.standard_normal((3, n)) * 100.0
        er[:, ::tile] = ei[:, ::tile] = 0.0
        er, ei = t(er), t(ei)
        ey0 = t(srng.uniform(0.0, 0.5, 3))
        for aa, y in ((a, None), (a, ey0), (1.0 - a, None), (1.0 - a, ey0)):
            cases.append(Case("slope_state", f"I={n} a={aa:.4f} "
                              f"y0={y is not None}",
                              lambda aa=aa, y=y, er=er, ei=ei:
                              cuda_fb.slope_state(er, ei, c1, aa, y),
                              lambda aa=aa, y=y, er=er, ei=ei:
                              cuda_fb.slope_state_plain(er, ei, c1, aa, y)))
    return cases


def spread_consts(z: int, dtype):
    """K3's constants for z bands, (a_uc, g_il, a_le or the lower table,
    spread_norm, dz02) for the kernel and for its plain version: the FFT
    ear's own for its band count (the first band of two for z = 1, whose
    lower table is [[1]])."""
    k = FE.build_consts(EP.fft_ear_params(max(z, 2)), dtype, "cuda")
    a_uc, g_il, norm = k.a_uc[:z], k.g_il[:z], k.spread_norm[:z]
    return ((a_uc, g_il, k.a_le, norm, k.dz02),
            (a_uc, g_il, k.lower_matrix[:z, :z].contiguous(), norm, k.dz02))


def spread_edges(t, dtype):
    """K3 at band counts 1..128 on 3 x 7 = 21 frame rows, not a multiple
    of the rows a block, from a generator of their own."""
    cases = []
    krng = np.random.default_rng(5)
    for z in (1, 2, 31, 32, 33, 55, 64, 109, 128):
        p = t(krng.uniform(1e-6, 1e4, (3, 7, z)))
        c, cp = spread_consts(z, dtype)
        cases.append(Case("spread_fft", f"Z={z} rows=21",
                          lambda p=p, c=c: cuda_spread_fft.spread_fft(p, *c),
                          lambda p=p, cp=cp:
                          cuda_spread_fft.spread_fft_plain(p, *cp)))
    return cases


def row_cases(t):
    """K1 and K2 at the FB ear's [2, 2, 40, 2500] (one tile of 2,560 frames
    a row) and at their tile edges on 3 rows, from a generator of their
    own: one frame; below, at and past one warp's 32 runs and its 256
    frames; below, at and past the largest tile; two of those plus one.  K1
    with and without y0 at each, and on an all-zero row with y0; K2 with
    uns 1000-fold larger on every other run, so that a wrong loud_{t-1} at
    a run, warp or tile edge shows in mod."""
    cases = []
    rrng = np.random.default_rng(7)
    tile = cuda_iir.MAX_TILE
    scale = C.SAMPLING_RATE / C.FB_FRAMESIZE
    for label, shape in [("FB", (2, 2, 40, 2500))] + [
            (f"edge F={f}", (1, 3, f))
            for f in (1, 31, 32, 33, 255, 256, 257, tile - 1, tile,
                      tile + 1, 2 * tile + 1)]:
        z, f = shape[-2:]
        a = t(np.exp(-rrng.uniform(0.01, 0.5, z)))
        b = t(rrng.standard_normal(shape))
        y0 = t(rrng.standard_normal(shape[:-1]))
        for y in (None, y0):
            cases.append(Case("recurrence_banded",
                              f"{label} {list(shape)} y0={y is not None}",
                              lambda a=a, b=b, y=y:
                              cuda_iir.recurrence_banded(a, b, y),
                              lambda a=a, b=b, y=y:
                              cuda_iir.recurrence_banded_plain(a, b, y)))
        exc2 = t(rrng.uniform(0.01, 10.0, shape))
        uns = rrng.uniform(0.01, 10.0, shape)
        uns[..., np.arange(f) // cuda_iir.RUN % 2 == 1] *= 1000.0
        uns2 = t(uns)
        cases.append(Case("fused_mod_smoothers",
                          f"{label} {list(shape)} uns x1000 on odd runs",
                          lambda a=a, exc2=exc2, uns2=uns2:
                          cuda_iir.fused_mod_smoothers(a, exc2, uns2, scale),
                          lambda a=a, exc2=exc2, uns2=uns2:
                          cuda_iir.fused_mod_smoothers_plain(a, exc2, uns2,
                                                             scale)))
    zero = t(np.zeros((1, 3, tile + 1)))
    a = t(np.exp(-rrng.uniform(0.01, 0.5, 3)))
    y0 = t(rrng.standard_normal((1, 3)))
    for y in (None, y0):
        cases.append(Case("recurrence_banded",
                          f"zero rows [1, 3, {tile + 1}] y0={y is not None}",
                          lambda a=a, y=y:
                          cuda_iir.recurrence_banded(a, zero, y),
                          lambda a=a, y=y:
                          cuda_iir.recurrence_banded_plain(a, zero, y)))
    return cases


def fft_blocks(pair10, lead: int, n: int) -> torch.Tensor:
    """Hop blocks [2 (ref, test), lead, CH, n + 1, 1024] float32 on the
    card, as the FFT path cuts them: the 10 s pair's channels tiled to
    (n + 1) x 1024 samples, each of `lead` pairs rolled by an offset of its
    own from a generator of its own (none for one pair)."""
    x = torch.stack([torch.as_tensor(np.ascontiguousarray(sig.T),
                                     device="cuda") for sig in pair10])
    t = (n + 1) * C.FFT_STEPSIZE
    x = x.repeat(1, 1, -(-t // x.shape[-1]))[..., :t]
    offsets = ([0] if lead == 1
               else np.random.default_rng(9).integers(1, t, lead))
    return torch.stack([torch.roll(x, int(o), dims=-1) for o in offsets],
                       dim=1).unflatten(-1, (n + 1, C.FFT_STEPSIZE))


def frames_case(k, label: str, blocks) -> Case:
    """S1 on hop blocks [2 (ref, test), ...] against its plain version."""
    ref, test = blocks[0], blocks[1]
    return Case("pair_frames", label,
                lambda: cuda_spectral.pair_frames(ref, test, k.hann),
                lambda: cuda_spectral.pair_frames_plain(ref, test, k.hann),
                (ref, test, k.hann))


def spectra_of(k, blocks) -> torch.Tensor:
    """The rDFTs S2 reads, [2, ..., F, 1025, 2]: S1's plain frames of
    `blocks` through one torch.fft.rfft."""
    frames = cuda_spectral.pair_frames_plain(blocks[0], blocks[1],
                                             k.hann)[0]
    return torch.view_as_real(torch.fft.rfft(frames, dim=-1))


def movs_case(k, label: str, spectra, ref_only: bool,
              bandwidth: bool, plain_spectra=None) -> Case:
    """S2 on `spectra` with the flags of a call site against its plain
    version (its grouping a float32 GEMM with TF32 off) on
    `plain_spectra` (default `spectra`).  The case's inputs hold the
    spectra cut to the bins the call reads (cuda_spectral.bins_read), so
    that bound() counts those bytes alone."""
    want = spectra if plain_spectra is None else plain_spectra

    def plain():
        with api.full_precision_matmuls():
            return cuda_spectral.spectral_movs_plain(
                want, k.level_factor, k.group_matrix, k.group_bin_hi,
                k.ehs_zero, ref_only, bandwidth)
    bins = cuda_spectral.bins_read(k.group_bin_hi, bandwidth)
    return Case("spectral_movs", label,
                lambda: cuda_spectral.spectral_movs(
                    spectra, k.level_factor, k.group_matrix, k.group_bin_hi,
                    k.group_span, k.group_weights, k.ehs_zero, ref_only,
                    bandwidth),
                plain,
                (spectra[..., :bins, :], k.level_factor, k.group_span,
                 k.group_weights, k.ehs_zero))


def unread_changed(k, spectra, seed: int = 11) -> torch.Tensor:
    """`spectra` with every bin from k.group_bin_hi up replaced by other
    finite values (loud, of either sign, from a generator of its own):
    the bins that S2 reads neither for its band sums nor for EHS, and
    without the bandwidth flag not at all."""
    out = spectra.clone()
    tail = out[..., k.group_bin_hi:, :]
    g = torch.Generator(device=spectra.device).manual_seed(seed)
    tail.copy_(1e3 * torch.randn(tail.shape, generator=g,
                                 device=spectra.device, dtype=spectra.dtype))
    return out


def spectral_check(name: str, got, want, dtype) -> tuple[float, float, bool,
                                                         str]:
    """S1 or S2 against its plain version: each floating output within
    BARS (max|d| / max|ref| over its finite values, each non-finite value
    equal in place and value; S1's frames, energies and halves), S1's
    gate bits (energy >= the EHS threshold) and S2's bandwidth indices and
    validity equal.  Returns the
    largest max|d|, the largest relative error, whether all holds, and a
    note for the case's line."""
    if name == "pair_frames":
        pairs = list(zip(got, want))
        exact = torch.equal(got[1] >= C.EHS_ENERGY_THRESHOLD,
                            want[1] >= C.EHS_ENERGY_THRESHOLD)
        halves = ((got[2] - want[2]).abs().max()
                  / want[2].abs().max().clamp_min(torch.finfo(dtype).tiny))
        note = (f", frames bit-identical: {torch.equal(got[0], want[0])}, "
                f"gate bits equal: {exact}, halves max|d|/max|ref| "
                f"{halves.item():.3e}")
    else:
        pairs = list(zip(got[:3], want[:3]))
        exact = (got.bandwidth is None) == (want.bandwidth is None)
        if exact and want.bandwidth is not None:
            exact = all(torch.equal(g, w) for g, w in zip(got.bandwidth,
                                                          want.bandwidth))
            note = f", bandwidth indices equal: {exact}"
        else:
            note = ""
    err = rel = 0.0
    placed = True
    for g, w in pairs:
        fin = torch.isfinite(w)
        placed = placed and torch.equal(torch.isfinite(g), fin) \
            and torch.equal(g[~fin], w[~fin])
        if fin.any():
            d = (g[fin] - w[fin]).abs().max().item()
            err = max(err, d)
            rel = max(rel, d / max(w[fin].abs().max().item(),
                                   torch.finfo(dtype).tiny))
    note += f", non-finite values equal: {placed}"
    return err, rel, placed and exact and rel < BARS[dtype], note


def ehs_check(got, want, d, dtype) -> tuple[float, float, bool, str]:
    """E1 against its plain version on rows d: every frame within
    EHS_BARS of it (max(1, |plain|) a frame), none NaN, and exactly 0 on
    every row that is all zero, whose d[0:256] is zero (d0 = 0) or that
    holds a NaN or an infinity, as the plain version is there.  Returns
    the largest |d|, the largest relative error, whether all holds, and a
    note for the case's line."""
    err = (got - want).abs()
    rel = (err / want.abs().clamp_min(1.0)).max().item()
    edge = ((d[..., :C.MAXLAG] == 0).all(dim=-1)
            | ~torch.isfinite(d).all(dim=-1))
    zeros = bool((got[edge] == 0).all() and (want[edge] == 0).all())
    finite = bool(torch.isfinite(got).all())
    note = (f", {int(edge.sum())} zero, d0 = 0 or non-finite rows exactly 0: "
            f"{zeros}, {int((want == 0).sum())} of {want.numel()} plain "
            "values 0")
    ok = finite and zeros and rel <= EHS_BARS[dtype]
    return err.max().item() if err.numel() else 0.0, rel, ok, note


def branch_blocks(pair10) -> torch.Tensor:
    """Hop blocks [2, 1, CH, 41, 1024] of the 10 s pair whose rows take
    every branch of S2: blocks 0-4 silent in both signals (pr = pt = 0,
    bandwidth 0), 5-9 identical (d exactly 0), 20-24 a test 60 dB down
    (EHS's log regime), 25-29 a test of zeros (d = -inf), and 30-39 a
    loud tone at bin 1000 in the test (the floor zt so high that bandwidth
    is 0); the rest the pair as it is."""
    b = fft_blocks(pair10, 1, 40).clone()
    b[:, ..., :5, :] = 0.0
    b[1, ..., 5:10, :] = b[0, ..., 5:10, :]
    b[1, ..., 20:25, :] = 1e-3 * b[0, ..., 20:25, :]
    b[1, ..., 25:30, :] = 0.0
    n = torch.arange(10 * C.FFT_STEPSIZE, device=b.device)
    tone = 0.5 * torch.sin(2 * math.pi * 1000 / C.FFT_FRAMESIZE * n)
    b[1, ..., 30:40, :] += tone.view(10, C.FFT_STEPSIZE)
    return b


def spectral_cases(dtype, pair10) -> list:
    """S1 and S2 at the per-pair shapes on the 10 s pair's own blocks (the
    basic path's [2, 1, 2, 469, 1024] as the main cases; S2 also with the
    advanced path's flags, the reference alone without the bandwidth),
    and at edges: S1 on float64 blocks, on one frame, on a view it must
    copy; S2 on branch_blocks' rows with each call site's flags."""
    kb = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT), dtype, "cuda")
    ka = FE.build_consts(EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT), dtype,
                         "cuda")
    blocks = fft_blocks(pair10, 1, MAIN[3])
    spectra = spectra_of(kb, blocks)
    cases = [frames_case(kb, "main", blocks),
             movs_case(kb, "main", spectra, False, True),
             movs_case(ka, f"advanced ref only {list(spectra.shape)}",
                       spectra, True, False),
             frames_case(kb, "float64 blocks", blocks.double()),
             frames_case(kb, "one frame [1, 2, 2, 1024]",
                         blocks[..., :2, :].contiguous()),
             frames_case(kb, "a view [1, 2, 468, 1024]",
                         blocks[..., 1:, :])]
    branches = spectra_of(kb, branch_blocks(pair10))
    for label, k, flags in (("basic", kb, (False, True)),
                            ("advanced", ka, (True, False)),
                            ("advanced FFT step", ka, (False, False))):
        cases.append(movs_case(k, f"branches {label}", branches, *flags))
    # without the bandwidth flag the bins from group_bin_hi up are not
    # needed: S2 on spectra whose such bins hold other finite values,
    # against the plain version on the spectra as they were
    for label, flags in (("advanced", (True, False)),
                         ("advanced FFT step", (False, False))):
        for name, x in (("main", spectra), ("branches", branches)):
            cases.append(movs_case(
                ka, f"{label}, {name} with bins >= {ka.group_bin_hi} "
                "changed", unread_changed(ka, x), *flags, plain_spectra=x))
    return cases


def ehs_difference(k, spectra) -> torch.Tensor:
    """EHS's log-spectral difference d [..., CH, F, 512] that S2's plain
    version gives for `spectra` (spectra_of's) in k's spectrum dtype; its
    temporaries are handed back to the card (the batch's run to GBs)."""
    with api.full_precision_matmuls():
        d = cuda_spectral.spectral_movs_plain(
            spectra, k.level_factor, k.group_matrix, k.group_bin_hi,
            k.ehs_zero, False, False).ehs_difference
    torch.cuda.empty_cache()
    return d


def ehs_case(label: str, d, subtract_dc: bool = False,
             centered: bool = False) -> Case:
    """E1 on d with one setting of the two flags that reach it against
    its plain version; its inputs d and the window."""
    window = torch.as_tensor(EP.ehs_correlation_window(centered),
                             dtype=d.dtype, device=d.device)
    flags = "".join((", subtract_dc" * subtract_dc,
                     ", centered window" * centered))
    return Case("ehs_frames", label + flags,
                lambda: cuda_ehs.ehs_frames(d, window, subtract_dc),
                lambda: MOVS.ehs_values(d, window, subtract_dc),
                (d, window))


def ehs_edges(d) -> torch.Tensor:
    """A copy of d [1, 2, F >= 10, 512] with the rows E1 must give the
    plain version's 0 on: an all-zero row, -inf at a bin below 256, at
    one above and at 511, +inf, and a NaN; a NaN and +inf at 511 alone
    (which no lag reads, but which enters E1's transform); and two rows
    whose d[0:256] is zero (d0 = 0: energy only in d[256:512])."""
    e = d.clone()
    e[0, 0, 0] = 0.0
    e[0, 1, 1, 100] = -math.inf
    e[0, 0, 2, 300] = -math.inf
    e[0, 1, 3, 511] = -math.inf
    e[0, 0, 4, 256] = math.inf
    e[0, 1, 5, 7] = math.nan
    e[0, 0, 6, 511] = math.nan
    e[0, 1, 7, 511] = math.inf
    e[0, 0, 8, :C.MAXLAG] = 0.0
    e[0, 1, 9, :C.MAXLAG] = 0.0
    return e


# the powers of ten ehs_scaled scales frames by: 1e-30 .. 1e+30 in double;
# in float the plain version's own products (d0 dk, its spectra's) leave
# float's range past ~1e-10 .. 1e+8 and it gives 0 there, so 1e-6 .. 1e+6
EHS_SCALES = {torch.float64: range(-30, 31, 5),
              torch.float32: range(-6, 7, 2)}


def ehs_scaled(d) -> torch.Tensor:
    """d's first frames [1, 2, n, 512], frame f scaled by 10^EHS_SCALES[f]
    (computed in double): rows spanning 1e-30 to 1e+30 in magnitude in
    double, each through E1's transform at its own scale."""
    p = torch.tensor(list(EHS_SCALES[d.dtype]), dtype=torch.float64,
                     device=d.device)
    scaled = d[:, :, :len(p)].double() * (10.0 ** p)[:, None]
    return scaled.to(d.dtype).contiguous()


# the powers of ten ehs_lifted scales d[0:256] by against d[256:512]: in
# double 1e-2 .. 1e-4, where E1 lifts h by s = 2^7 .. 2^13 and the plain
# version's own rounding (~eps |d| / |h|) stays far under the bar; in
# float, whose plain version rounds in float, 1e-1 .. 1e-3 (s = 2^3 ..
# 2^10), where that rounding is still well under the bar
EHS_LIFTS = {torch.float64: (-2, -3, -4), torch.float32: (-1, -2, -3)}


def ehs_lifted(d) -> torch.Tensor:
    """A copy of d whose frame f has d[0:256] scaled by 10^EHS_LIFTS[f
    mod n] (computed in double) against d[256:512], as a codec transparent
    at low frequencies and distorting the highs gives: rows on which E1
    lifts h by its power of two s before the transform."""
    p = torch.tensor(EHS_LIFTS[d.dtype], dtype=torch.float64,
                     device=d.device)
    lift = (10.0 ** p)[torch.arange(d.shape[-2], device=d.device) % len(p)]
    x = d.double()
    x = torch.cat([x[..., :C.MAXLAG] * lift[:, None], x[..., C.MAXLAG:]],
                  dim=-1)
    return x.to(d.dtype).contiguous()


def ehs_cases(dtype, pair10) -> list:
    """E1 at the per-pair shape on the 10 s pair's own d (the main case,
    [1, 2, 468, 512]) under each setting of its two flags, on the edge
    rows (ehs_edges), on branch_blocks' rows (silent, identical, a test
    60 dB down, a test of zeros: -inf), on frames scaled 1e-30 .. 1e+30
    (ehs_scaled), on frames whose d[0:256] lies far below d[256:512]
    (ehs_lifted), in mono and in 3 channels, and on one frame."""
    kb = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT), dtype, "cuda")
    d = ehs_difference(kb, spectra_of(kb, fft_blocks(pair10, 1, MAIN[3])))
    cases = [ehs_case("main", d)]
    for flags in ((True, False), (False, True), (True, True)):
        cases.append(ehs_case(f"{list(d.shape)}", d, *flags))
    edges = ehs_edges(d)
    branches = ehs_difference(kb, spectra_of(kb, branch_blocks(pair10)))
    for label, x in (("edges", edges), ("branches", branches),
                     ("scaled", ehs_scaled(d)),
                     ("lifted", ehs_lifted(d)),
                     ("mono", d[:, :1].contiguous()),
                     ("3 channels", torch.cat([d, d[:, :1]], dim=1)),
                     ("one frame", d[..., :1, :].contiguous())):
        for flags in ((False, False), (True, True)):
            cases.append(ehs_case(f"{label} {list(x.shape)}", x, *flags))
    return cases


# G1's two frame forms (frame, hop): the FFT ear's and the FB ear's
GATE_FORMS = {"FFT": (C.FFT_FRAMESIZE, C.FFT_STEPSIZE),
              "FB": (C.FB_FRAMESIZE, C.FB_FRAMESIZE)}
# the FB frames of the 10 s pair (phase 3's per-pair FB case)
FB_PAIR_FRAMES = 10 * C.SAMPLING_RATE // C.FB_FRAMESIZE


# gate_signal's references by (lead, t), made once for both spectrum types
# and dropped after phase 7
GATE_SIGNALS = {}


def gate_signal(pair10, lead: int, t: int) -> torch.Tensor:
    """A reference [lead, CH, t] float32 on the card: the 10 s pair's
    channels tiled to t samples, each of `lead` rows rolled by an offset of
    its own (none for one row), then silenced over one stretch and brought
    near the threshold (x 2.4e-3) over another, each of its own length, so
    that the frames take both bits.  Made once per (lead, t) (the run has
    one 10 s pair) and kept in GATE_SIGNALS."""
    if (lead, t) in GATE_SIGNALS:
        return GATE_SIGNALS[lead, t]
    x = torch.as_tensor(np.ascontiguousarray(pair10[0].T), device="cuda")
    x = x.repeat(1, -(-t // x.shape[-1]))[..., :t]
    rng = np.random.default_rng(13)
    offsets = [0] if lead == 1 else rng.integers(1, t, lead)
    rows = torch.stack([torch.roll(x, int(o), dims=-1) for o in offsets])
    for r in range(lead):
        for scale in (0.0, 2.4e-3):
            start, size = rng.integers(0, t), rng.integers(t // 20, t // 5)
            rows[r, ..., start:start + size] *= scale
    GATE_SIGNALS[lead, t] = rows
    return rows


@contextlib.contextmanager
def gate_spans(span):
    """G1's plan with each pair's frames in spans of `span` frames (None:
    the planner's own), by swapping cuda_gate.gate_plan for the time."""
    plan = cuda_gate.gate_plan
    if span is not None:
        def forced(pairs, channels, n_frames, *args):
            spans = -(-n_frames // span)
            return plan(pairs, channels, n_frames, *args)._replace(
                span=span, spans=spans, grid=pairs * spans)
        cuda_gate.gate_plan = forced
    try:
        yield
    finally:
        cuda_gate.gate_plan = plan


def gate_case(label: str, sig, n: int, form: str, dtype,
              span=None) -> Case:
    """G1 on `sig` ([..., CH, T]) in the spectrum dtype `dtype` (each
    pair's frames in spans of `span` where given) against its plain
    version (framing.above_threshold_signal of sig cast to dtype)."""
    frame, hop = GATE_FORMS[form]

    def kernel():
        with gate_spans(span):
            return cuda_gate.frame_gate(sig, n, frame, hop, dtype)
    return Case("frame_gate", label, kernel,
                lambda: cuda_gate.frame_gate_plain(sig, n, frame, hop,
                                                   dtype),
                (sig,))


def gate_edges(form: str, ship, channels: int, seed: int = 5):
    """Edge rows [3, CH, T] of numpy type `ship` for 23 FFT / 40 FB frames
    (6 or 12 / 2 or 4 of G1's tiles in that type), and the bits pair 1's
    frames must take.
    Pair 0: noise below the threshold with loud bursts, some in one
    channel alone.  Pair 1: silence holding one case every other hop: a
    window exactly at the threshold, one ulp above and one below (a lone
    sample, then five samples whose rounded sum lands there), a loud
    sample 2 before a hop's end (windows straddling i = 1020..1027), five
    samples across a hop boundary whose one window holding them all sums
    to the threshold, a loud sample at frame-local 0 of a tile's first hop
    (windows at i < 5: they count only for the FFT frame before, in the
    tile before) and one at frame-local 1 (its window at i = 5 counts),
    and a NaN beside a loud sample (its frame and the one before stay
    below).  Pair 2: pair 0 negated, its first channel silent."""
    frame, hop = GATE_FORMS[form]
    fft = frame == 2 * hop
    n = 23 if fft else 40
    n_hops = n + fft
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, channels, n_hops * hop)) * 2e-4).astype(ship)
    for h in rng.choice(n_hops, n_hops // 3, replace=False):
        c = rng.integers(channels) if h % 2 else slice(None)
        x[0, c, h * hop + rng.integers(hop)] = ship(0.02)
    x[1] = 0.0
    th = ship(C.FRAME_THRESHOLD)
    up, down = np.nextafter(th, ship(1)), np.nextafter(th, ship(0))

    def five(target):
        # a(j-4) .. a(j), whose window sum (((a(j) + a(j-1)) + ..) + a(j-4))
        # rounds to target
        v = rng.uniform(0.1, 0.2, 4).astype(ship) * th
        part = ((v[0] + v[1]) + v[2]) + v[3]
        last = ship(target - part)
        while part + last < target:
            last = np.nextafter(last, ship(1))
        while part + last > target:
            last = np.nextafter(last, ship(0))
        return [last, v[3], v[2], v[1], v[0]]

    expect = {}
    for k, (samples, bit) in enumerate(
            [([th], True), ([up], True), ([down], False), (five(th), True),
             (five(up), True), (five(down), False)]):
        start = 2 * k * hop + hop // 2
        x[1, -1, start:start + len(samples)] = samples
        expect[2 * k] = bit
    h = 12
    loud = ship(0.05)
    tile = cuda_gate.gate_plan(1, channels, 0, hop, fft, torch.float32,
                               1).tile_hops
    edge = -(-(h + 4) // tile) * tile
    x[1, 0, (h + 1) * hop - 2] = loud
    x[1, 0, (h + 3) * hop - 3:(h + 3) * hop + 2] = five(th)
    x[1, 0, edge * hop] = loud
    x[1, 0, (edge + 2) * hop + 1] = loud
    x[1, 0, (n_hops - 2) * hop + 40] = loud
    x[1, 0, (n_hops - 2) * hop + 42] = np.nan
    expect.update({h - 1: fft, h: True, h + 1: False, h + 2: fft,
                   h + 3: False, edge - 1: fft, edge: False,
                   edge + 2: True, n_hops - 3: False, n_hops - 2: False})
    x[2] = -x[0]
    x[2, 0] = 0.0
    return x, n, expect


def gate_cases(dtype, pair10) -> list:
    """G1 at the per-pair shapes (the 10 s pair's reference: FFT [1, 2,
    469 x 1024] as the main case, FB [1, 2, 480000]) and at edges, with
    float32 samples (as every path ships them) and float64: gate_edges'
    rows in mono, stereo and 3 channels (their expected bits checked
    here where the samples' type is `dtype`), the stereo rows one sample
    off 16 bytes (in place in a wider tensor: all but one of their rows
    start off 16-byte alignment, so their copies take cp.async) and
    across span boundaries (spans of half the NaN hop's index, so that
    the NaN-and-loud hop is one span's first and the span before's one
    more hop), one frame, a view G1 reads in place (the advanced path's
    FFT prefix) and one it copies."""
    cases = []
    t_fft = (MAIN[3] + 1) * C.FFT_STEPSIZE
    for ship in DTYPES:
        name = str(ship)[6:]
        sig = gate_signal(pair10, 1, t_fft).to(ship)
        cases.append(gate_case("main" if ship == torch.float32 else
                               f"per pair FFT {name} samples "
                               f"{list(sig.shape)}", sig, MAIN[3], "FFT",
                               dtype))
        sig = gate_signal(pair10, 1, 10 * C.SAMPLING_RATE).to(ship)
        cases.append(gate_case(f"per pair FB {name} samples "
                               f"{list(sig.shape)}", sig, FB_PAIR_FRAMES,
                               "FB", dtype))
        for form, (frame, hop) in GATE_FORMS.items():
            for channels in (1, 2, 3):
                x, n, expect = gate_edges(form, DTYPES_NP[ship], channels)
                x = torch.as_tensor(x, device="cuda")
                rows = [(f"{channels} ch", x, None)]
                if channels == 2:
                    wide = x.new_zeros((*x.shape[:-1], x.shape[-1] + 1))
                    wide[..., 1:] = x
                    span = (n + (frame == 2 * hop) - 2) // 2
                    rows += [("one sample off 16 bytes", wide[..., 1:], None),
                             (f"in spans of {span}", x, span)]
                for label, sig, span in rows:
                    label = f"edges {form} {label} {name} samples"
                    case = gate_case(f"{label} {list(sig.shape)}", sig, n,
                                     form, dtype, span)
                    if ship == dtype:
                        # the cases sit one ulp from the threshold in the
                        # samples' own type
                        got = case.kernel()[1]
                        held = all(bool(got[f]) == b
                                   for f, b in expect.items())
                        print(f"  frame_gate {label}: the expected bits "
                              f"held: {held}", flush=True)
                        check(held, f"G1 {label}: {got.tolist()}")
                    cases.append(case)
            one = gate_signal(pair10, 1, frame).to(ship)
            cases.append(gate_case(f"one frame {form} {name} samples "
                                   f"{list(one.shape)}", one, 1, form,
                                   dtype))
        wide = gate_signal(pair10, 8, t_fft + C.FFT_STEPSIZE).to(ship)
        view = wide.view(2, 4, 2, -1)[0, ..., :t_fft]
        cases.append(gate_case(f"a view {list(view.shape)} {name} samples",
                               view, MAIN[3], "FFT", dtype))
        view = wide.view(2, 4, 2, -1)[:, :2, ..., :t_fft]
        cases.append(gate_case(f"a view it copies {list(view.shape)} {name} "
                               "samples", view, MAIN[3], "FFT", dtype))
    return cases


def band_ops(name: str, inputs) -> float:
    """The operations of one L1, L2 or M1 call on `inputs` (band_reads'),
    a transcendental counted as one, per band element of one signal (a
    row, a band, a frame).  L1: sqrt(Pr Pt) and the two sums (4), the
    level correction (1) and the drive's two products (2).  L2: the
    comparison and two quotients (3), the window's 2 (W - 1) adds over W
    = m1c + m2c + 1 bands and the four products (4).  M1: ModDiff and
    TempWt (13), the adapted excitations (4), a noise loudness set (23:
    s_ref, s_test, beta, two powers, the excess, its quotient, the sum),
    the loudness of both signals (16), NMR (4) and the detection
    probability and steps (36: two log10, l, s(l), e, t^4 or t^6, 0.5^t,
    trunc, the maxima): basic 96, the FB site 102 (three sets, no NMR or
    detection), the FFT site 4 (NMR alone)."""
    x = inputs[0]
    if name == "levcorr":
        return 7 * x.numel() // 2
    z = x.shape[-2]
    if name == "pattern_adapt":
        width = z // 36 + z // 25 + 1
        return (7 + 2 * (width - 1)) * x.numel() // 2
    if len(inputs) == 2:                        # the FFT site: exc, noise
        return 4 * x.numel()
    per = 102 if z == C.FB_BAND_COUNT else 96
    return per * x.numel() // 2


# M1's library calls per band element of one signal (a row, a band, a
# frame) at each site, as csrc/band.cu's band_movs_kernel makes them
# (band_math_floor).  basic: the noise loudness (exp, two pow, three
# quotients), the two loudnesses (a pow each), ModDiff and TempWt (three
# quotients), the adapted reference (one), NMR (two), the detection (two
# log10, pow(S1 / l, S2), exp2, two quotients); the FB site three noise
# loudness sets, the last two sharing their lead pow and quotient; the FFT
# site NMR alone.
M1_CALLS = {"basic": {"pow": 5, "exp": 1, "exp2": 1, "log10": 2, "div": 11},
            "fb": {"pow": 7, "exp": 3, "div": 12},
            "fft": {"div": 2}}


def band_math_rates(iters: int = 128) -> dict:
    """The card's rate of each of M1's library calls (cuda_band.MATH_OPS),
    calls a second per dtype: cuda_band.math_rate on 132 x 8 blocks of 256
    threads, each `iters` steps of MATH_CHAINS chains in registers (CUDA
    events, median of 5).  A step is the call and one add."""
    rates = {}
    for dtype in DTYPES:
        out = torch.empty(132 * 8 * 256, dtype=dtype, device="cuda")
        rates[dtype] = {}
        for op in cuda_band.MATH_OPS:
            ms, _ = cuda_ms(lambda: cuda_band.math_rate(op, iters, out),
                            calls=1, rounds=5, warmup=1)
            rates[dtype][op] = (cuda_band.MATH_CHAINS * iters
                                * out.numel() / ms * 1e3)
    return rates


def band_math_floor(site: str, inputs, dtype, rates: dict,
                    calls=M1_CALLS) -> float:
    """M1's math floor in ms at `site` on `inputs` (band_reads'): each
    band element's library calls (`calls`) at the card's measured rates
    (band_math_rates), and band_ops' other operations at the peak rate."""
    x = inputs[0]
    elements = x.numel() // (1 if site == "fft" else 2)
    per = band_ops("band_movs", inputs) / elements
    used = calls[site]
    ms = sum(n * elements / rates[dtype][op] for op, n in used.items())
    rest = max(per - sum(used.values()), 0.0) * elements
    return (ms + rest / PEAK_OPS_PER_S[dtype]) * 1e3


def band_calls(run) -> dict:
    """The first call of each band kernel (L1, L2, M1) by (kernel, M1's
    site) that run() makes, as (args, kwargs); the calls run as made."""
    seen = {}
    wrappers = {name: getattr(cuda_band, name) for name in BAND}

    def capture(name):
        def call(*args, **kwargs):
            site = args[1] if name == "band_movs" else ""
            seen.setdefault((name, site), (args, kwargs))
            return wrappers[name](*args, **kwargs)
        return call
    try:
        for name in BAND:
            setattr(cuda_band, name, capture(name))
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in wrappers.items():
            setattr(cuda_band, name, fn)
    return seen


def band_reads(name: str, args, kwargs) -> tuple:
    """The tensors one call of a band kernel reads: L1 exc2 and filt2; L2
    nd (and a); M1 the excitations, lev_corr, pc, the modulations, the
    average loudness and NMR's noise, where the site reads them."""
    if name != "band_movs":
        return tuple(args[:2])
    bound = inspect.signature(cuda_band.band_movs_plain).bind(*args,
                                                               **kwargs)
    return tuple(bound.arguments[arg] for arg in (
        "exc", "lev_corr", "pc", "mod2", "avg_loud", "noise")
        if bound.arguments.get(arg) is not None)


def band_case(label: str, name: str, call) -> Case:
    """A Case of one captured call of a band kernel: the wrapper and the
    plain version on the call's own arguments."""
    args, kwargs = call
    kernel = getattr(cuda_band, name)
    plain = getattr(cuda_band, f"{name}_plain")
    return Case(name, label, lambda: kernel(*args, **kwargs),
                lambda: plain(*args, **kwargs),
                band_reads(name, args, kwargs))


def band_shape(name: str, call) -> list:
    return list(band_reads(name, *call)[0].shape)


def band_check(name: str, got, want, dtype) -> tuple[float, float, bool,
                                                       str]:
    """A band kernel's output against its plain version's: each tensor
    within BARS of its largest value (all finite where the plain version's
    are), and M1's decisions equal: the disturbed flags, the noise
    loudness's zeroed frames (nl < nl_min) and, by the steps' bar (a
    truncation that fell otherwise moves steps_bin by 1 / s, far above
    it), the truncated parts of e.  Returns (max|d|, max|d| / max|ref|,
    ok, note)."""
    err = rel = 0.0
    ok = True
    for g, w in zip(tensors_of(got), tensors_of(want)):
        ok = ok and g.shape == w.shape and g.dtype == w.dtype
        d = (g.double() - w.double()).abs().max().item() if g.numel() else 0
        err = max(err, d)
        rel = max(rel, d / max(w.double().abs().max().item() if w.numel()
                              else 0.0, torch.finfo(dtype).tiny))
        ok = ok and bool(torch.equal(torch.isfinite(g), torch.isfinite(w)))
    note = ""
    if name == "band_movs":
        if got.nmr is not None:
            same = torch.equal(got.nmr[1], want.nmr[1])
            note += (f", disturbed {int(got.nmr[1].sum())} of "
                     f"{got.nmr[1].numel()} equal: {same}")
            ok = ok and same
        if got.terms is not None:
            same = torch.equal(got.terms[3:] == 0, want.terms[3:] == 0)
            note += (f", nl zeroed {int((got.terms[3:] == 0).sum())} equal: "
                     f"{same}")
            ok = ok and same
    return err, rel, ok and rel < BARS[dtype], note


@functools.cache
def bench_pairs():
    """bench.py's 64 pairs of 10 s stereo (phases 3 and 9)."""
    return make_pairs(BATCH_PAIRS, 10.0)


def band_cases(dtype, pair10) -> list:
    """L1, L2 and M1 on the inputs the 10 s pair gives them in one peaq()
    per mode, in dtype's tier (the basic calls the main cases; the advanced
    path's FB level adapter and M1 at its FFT and FB sites), and, for
    float32, in the accurate tier too (M1 with float64 NMR noise)."""
    tiers = [("float64" if dtype == torch.float64 else "float32", "")]
    if dtype == torch.float32:
        tiers.append(("accurate", "accurate tier, "))
    cases = []
    for tier, note in tiers:
        for mode in MODES:
            calls = band_calls(lambda: peaq_call(pair10, mode, tier))
            for (name, site), call in calls.items():
                label = ("main" if mode == "basic" and not note else
                         f"per pair {note}{mode} {site} "
                         f"{band_shape(name, call)}".replace("  ", " "))
                cases.append(band_case(label, name, call))
    return cases


def band_channels(call, pick: list):
    """A captured M1 call with the channels `pick` of its pairs: each band
    input's channel axis (-3 of [..., CH, Z, F] and of the noise's
    [..., CH, F, Z], -2 of lev_corr's [..., CH, F]) indexed by pick."""
    args, kwargs = call
    bound = inspect.signature(cuda_band.band_movs_plain).bind(*args,
                                                               **kwargs)
    axes = {"exc": -3, "lev_corr": -2, "pc": -3, "mod2": -3, "avg_loud": -3,
            "noise": -3}
    for arg, axis in axes.items():
        t = bound.arguments.get(arg)
        if t is not None:
            bound.arguments[arg] = t.index_select(
                t.dim() + axis, torch.tensor(pick, device=t.device))
    return bound.args, bound.kwargs


def band_channel_case(label: str, call, pick: list) -> Case:
    """M1 on a captured call's inputs with the channels `pick`
    (band_channels), derived anew at each run so that the case holds no
    memory of its own; not timed (no inputs for a bound)."""
    def run(fn):
        args, kwargs = band_channels(call, pick)
        return fn(*args, **kwargs)
    shape = band_shape("band_movs", call)
    shape[-3] = len(pick)
    return Case("band_movs", f"{label} at the basic batch shape {shape}",
                lambda: run(cuda_band.band_movs),
                lambda: run(cuda_band.band_movs_plain))


def band_batch_cases(dtype) -> list:
    """L1, L2 and M1 on the inputs of bench's 64 pairs through peaq_batch()
    (basic microbatch 64, advanced 32: the first microbatch's calls), and
    M1 at the basic site on those pairs in mono and in 3 channels (the
    stereo inputs' channels 0, and 0, 1, 0): a pair of one channel is one
    tile's row, three take the detection's blocks of their own."""
    tier = "float64" if dtype == torch.float64 else "float32"
    cases = []
    for mode in MODES:
        calls = band_calls(lambda: PB.peaq_batch(
            *bench_pairs(), advanced=mode == "advanced", dtype=tier,
            microbatch=MICROBATCH[mode]))
        for (name, site), call in calls.items():
            label = f"batch {mode} {site} {band_shape(name, call)}"
            cases.append(band_case(label.replace("  ", " "), name, call))
        if mode == "basic":
            for label, pick in (("mono", [0]), ("3 channels", [0, 1, 0])):
                cases.append(band_channel_case(
                    label, calls["band_movs", "basic"], pick))
    return cases


def band_stream_cases(dtype, pair10, chunk: int, n: int) -> list:
    """L1, L2 and M1 on the inputs of one chunk step of each stream path at
    `chunk` FFT frames and n streams: pools fed the 10 s pair tiled to
    70 s, one basic step, then an advanced pool's first FFT and FB steps."""
    tier = "float64" if dtype == torch.float64 else "float32"
    program = tuple(np.tile(x, (7, 1)) for x in pair10)

    def piece(hi):
        return tuple(np.broadcast_to(x[:hi], (n, hi, 2)) for x in program)
    cases = []
    for mode, need in (("basic", (chunk + 1) * C.FFT_STEPSIZE),
                       ("advanced", 16 * chunk * C.FB_FRAMESIZE)):
        pool = PS.PeaqStreamPool(n, chunk_frames=chunk, dtype=tier,
                                 advanced=mode == "advanced")
        calls = band_calls(lambda: pool.feed(*piece(need)))
        for (name, site), call in calls.items():
            path = {"basic": "basic", "fft": "advanced_fft",
                    "fb": "advanced_fb"}[site] if site else (
                "basic" if mode == "basic" else "advanced_fb")
            cases.append(band_case(f"stream N={n} chunk {chunk} {path} "
                                   f"{band_shape(name, call)}", name, call))
        del pool
    return cases


def kernel_cases(dtype, rng, pair10):
    """Every Case of phase 3, at main-path and edge shapes."""
    dev = "cuda"
    cases = []
    z = MAIN[2]

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    a = t(np.exp(-rng.uniform(0.01, 0.5, z)))
    for f in (MAIN[3], 37, 1):
        b = t(rng.standard_normal((*MAIN[:3], f)))
        y0 = t(rng.standard_normal(MAIN[:3]))
        cases.append(Case("recurrence_banded", f"F={f}",
                          lambda a=a, b=b: cuda_iir.recurrence_banded(a, b),
                          lambda a=a, b=b:
                          cuda_iir.recurrence_banded_plain(a, b),
                          (a, b)))
        cases.append(Case("recurrence_banded", f"F={f} y0",
                          lambda a=a, b=b, y0=y0:
                          cuda_iir.recurrence_banded(a, b, y0),
                          lambda a=a, b=b, y0=y0:
                          cuda_iir.recurrence_banded_plain(a, b, y0)))
    exc2 = t(rng.uniform(0.01, 10.0, MAIN))
    uns2 = t(rng.uniform(0.01, 10.0, MAIN))
    scale = C.SAMPLING_RATE / C.FFT_STEPSIZE
    cases.append(Case("fused_mod_smoothers", "main",
                      lambda: cuda_iir.fused_mod_smoothers(a, exc2, uns2,
                                                           scale),
                      lambda: cuda_iir.fused_mod_smoothers_plain(
                          a, exc2, uns2, scale),
                      (a, exc2, uns2)))
    for bc in (109, 55):
        c, cp = spread_consts(bc, dtype)
        p = t(rng.uniform(1e-6, 1e4, (*MAIN[:2], MAIN[3], bc)))
        cases.append(Case("spread_fft", f"Z={bc}",
                          lambda p=p, c=c: cuda_spread_fft.spread_fft(p, *c),
                          lambda p=p, cp=cp:
                          cuda_spread_fft.spread_fft_plain(p, *cp),
                          (p, c[0], c[1], c[3])))
    return (cases + row_cases(t) + spread_edges(t, dtype)
            + fb_cases(dtype, rng, pair10, t) + spectral_cases(dtype, pair10)
            + gate_cases(dtype, pair10) + band_cases(dtype, pair10)
            + ehs_cases(dtype, pair10))


def batch_fb_pair(pair10, k, shape) -> torch.Tensor:
    """An FB-path input of the advanced batch, [2(ref, test), B, CH, T] on
    the card in k's spectrum dtype: the 10 s pair's FB rows rolled by B
    distinct offsets from a generator of its own (one pair per offset, so
    no two pairs of the batch are alike) and zero-padded to the bucket's
    T samples, as the batch pads them."""
    x = fb_rows(pair10, k)                              # [2, CH, 480000]
    offsets = np.random.default_rng(9).integers(1, x.shape[-1], shape[1])
    rolled = torch.stack([torch.roll(x, int(o), dims=-1) for o in offsets],
                         dim=1)
    return torch.nn.functional.pad(rolled, (0, shape[-1] - x.shape[-1]))


def batch_cases(dtype, rng, pair10):
    """Each kernel at the batch path's shapes (batch_shapes), the batch in
    the row count: K1, K2 and K3 on random inputs at the basic batch, K1
    and K2 also at the advanced batch's FB frames and K3 on its reference
    alone; D3 on batch_fb_pair's rows, F1 on their plain DC stage's
    output, D1 and D2 on the FIR bank's outputs of it, W1 on D1's cu
    there."""
    shapes = batch_shapes()

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    cases = []
    basic = shapes["basic"]
    for label, shape, step in (("basic", basic, C.FFT_STEPSIZE),
                               ("advanced", shapes["fb_frames"],
                                C.FB_FRAMESIZE)):
        az = t(np.exp(-rng.uniform(0.01, 0.5, shape[-2])))
        b = t(rng.standard_normal(shape))
        cases.append(Case("recurrence_banded", f"batch {label} {list(shape)}",
                          lambda az=az, b=b: cuda_iir.recurrence_banded(az, b),
                          lambda az=az, b=b:
                          cuda_iir.recurrence_banded_plain(az, b),
                          (az, b)))
        exc2, uns2 = (t(rng.uniform(0.01, 10.0, shape)) for _ in range(2))
        scale = C.SAMPLING_RATE / step
        cases.append(Case("fused_mod_smoothers",
                          f"batch {label} {list(shape)}",
                          lambda az=az, e=exc2, u=uns2, sc=scale:
                          cuda_iir.fused_mod_smoothers(az, e, u, sc),
                          lambda az=az, e=exc2, u=uns2, sc=scale:
                          cuda_iir.fused_mod_smoothers_plain(az, e, u, sc),
                          (az, exc2, uns2)))
    # K3 on both signals of the basic batch, and on the advanced batch's
    # reference alone (55 bands)
    for label, lead, z in (("basic", basic[:3], basic[-2]),
                           ("advanced ref only",
                            shapes["fb_frames"][1:3],
                            C.ADVANCED_FFT_BAND_COUNT)):
        c, cp = spread_consts(z, dtype)
        p = t(rng.uniform(1e-6, 1e4, (*lead, basic[-1], z)))
        cases.append(Case("spread_fft", f"batch {label} {list(p.shape)}",
                          lambda p=p, c=c: cuda_spread_fft.spread_fft(p, *c),
                          lambda p=p, cp=cp:
                          cuda_spread_fft.spread_fft_plain(p, *cp),
                          (p, c[0], c[1], c[3])))
    # S1 and S2 on the basic and the advanced batch's FFT frames (the
    # advanced one's reference alone grouped, no bandwidth)
    for label, lead, z, flags in (
            ("basic", basic[1], C.BASIC_BAND_COUNT, (False, True)),
            ("advanced", shapes["fb_frames"][1], C.ADVANCED_FFT_BAND_COUNT,
             (True, False))):
        kf = FE.build_consts(EP.fft_ear_params(z), dtype, "cuda")
        blocks = fft_blocks(pair10, lead, basic[-1])
        cases.append(frames_case(kf, f"batch {label} "
                                 f"{list(blocks.shape[1:])}", blocks))
        spectra = spectra_of(kf, blocks)
        del blocks
        cases.append(movs_case(kf, f"batch {label} {list(spectra.shape)}",
                               spectra, *flags))
        # E1 on S2's d of the same spectra, with and without the mean
        # subtracted
        d = ehs_difference(kf, spectra)
        cases.append(ehs_case(f"batch {label} {list(d.shape)}", d))
        cases.append(ehs_case(f"batch {label} {list(d.shape)}", d, True))
    k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
    x = batch_fb_pair(pair10, k, shapes["dc"])
    cases.append(Case("dc_chain", f"batch {list(x.shape)}",
                      lambda: dc_out(cuda_dc.dc_chain(x, k.level)),
                      lambda: dc_out(cuda_dc.dc_chain_plain(x, k.level)),
                      (x,)))
    hp2, _ = cuda_dc.dc_chain_plain(x, k.level)
    cases.append(fir_case(k, f"batch {list(hp2.shape)}", hp2, None, (hp2,)))
    re, im = FB.filter_bank(k, hp2)
    check(re.shape == shapes["fb_instants"], f"FB batch shape {re.shape}")
    c1 = 24.0 + 230.0 / k.fc
    cu = cuda_fb.slope_state_plain(re, im, c1, k.slope_a)
    cases.append(Case("slope_state", f"batch {list(re.shape)}",
                      lambda: cuda_fb.slope_state(re, im, c1, k.slope_a),
                      lambda: cuda_fb.slope_state_plain(re, im, c1,
                                                        k.slope_a),
                      (re, im, c1)))
    cases.append(Case("spread_fb", f"batch {list(re.shape)}",
                      lambda: cuda_fb.spread_fb(re, im, cu, k.cl),
                      lambda: cuda_fb.spread_fb_plain(re, im, cu,
                                                      k.lower_matrix),
                      (re, im, cu)))
    # W1 at the batch's E0 shape on D1's cu, which D2's case holds, so that
    # phase 3 keeps no E0 of its own (its sums do not depend on the values)
    cases.append(mask_case(k, f"batch {list(cu.shape)}", cu))
    # G1 on the references of the basic batch and of the advanced batch's
    # FFT and FB paths, in float32 samples (as the batch ships them; the
    # batch cases) and float64 (checked only)
    n_fb = shapes["dc"][-1] // C.FB_FRAMESIZE
    for ship in DTYPES:
        for label, lead, n, form in (
                ("basic FFT", basic[1], basic[-1], "FFT"),
                ("advanced FFT", shapes["dc"][1], basic[-1], "FFT"),
                ("advanced FB", shapes["dc"][1], n_fb, "FB")):
            length = (n + (form == "FFT")) * GATE_FORMS[form][1]
            sig = gate_signal(pair10, lead, length).to(ship)
            label = f"batch {label} {list(sig.shape)}"
            cases.append(gate_case(label if ship == torch.float32 else
                                   f"float64 samples, {label}", sig, n, form,
                                   dtype))
    return cases + band_batch_cases(dtype)


def stream_shapes(n: int, chunk: int = STREAM_CHUNK) -> dict:
    """The stream path's chunk shapes at n streams of stereo (`chunk` FFT
    frames, 16 x `chunk` FB frames): K1 and K3 on the basic step's
    [2, n, CH, 109, chunk] and the advanced FFT step's 55 bands, K1 on the
    FB step's frames, D1 and D2 on its instants, D3 on its samples."""
    fb = 16 * chunk
    return {"basic": (2, n, 2, C.BASIC_BAND_COUNT, chunk),
            "advanced_fft": (2, n, 2, C.ADVANCED_FFT_BAND_COUNT, chunk),
            "fb_frames": (2, n, 2, C.FB_BAND_COUNT, fb),
            "fb_instants": (2, n, 2, C.FB_BAND_COUNT,
                            fb * C.FB_FRAMESIZE // FB.SUB),
            "dc": (2, n, 2, fb * C.FB_FRAMESIZE)}


def chunk_shapes(name: str, chunk: int = STREAM_CHUNK) -> dict:
    """The shapes of kernel `name`'s calls in one chunk step of each stream
    path, at one stream and `chunk` FFT frames (K3's [..., F, Z], the
    others' band or sample layouts)."""
    sh = stream_shapes(1, chunk)
    fb = {"advanced_fb": sh["fb_instants"]}
    return {"recurrence_banded": {"basic": sh["basic"],
                                  "advanced_fft": sh["advanced_fft"],
                                  "advanced_fb": sh["fb_frames"]},
            "fused_mod_smoothers": {},
            "spread_fft": {path: (*sh[path][:3], sh[path][4], sh[path][3])
                           for path in ("basic", "advanced_fft")},
            "slope_state": fb, "spread_fb": fb,
            "dc_chain": {"advanced_fb": sh["dc"]},
            "fir_bank": {"advanced_fb": sh["dc"]},
            # S1's hop blocks [N, CH, F + 1, 1024], S2's spectra
            "pair_frames": dict.fromkeys(
                ("basic", "advanced_fft"), (1, 2, chunk + 1, C.FFT_STEPSIZE)),
            "spectral_movs": dict.fromkeys(
                ("basic", "advanced_fft"),
                (2, 1, 2, chunk, C.FFT_FRAMESIZE // 2 + 1, 2)),
            # G1's reference [N, CH, T]
            "frame_gate": {**dict.fromkeys(
                ("basic", "advanced_fft"),
                (1, 2, (chunk + 1) * C.FFT_STEPSIZE)),
                "advanced_fb": sh["dc"][1:]},
            # L1's and L2's stacked band tensors, M1's excitations (the
            # FFT step's reference alone)
            "levcorr": {"basic": sh["basic"], "advanced_fb": sh["fb_frames"]},
            "pattern_adapt": {"basic": sh["basic"],
                              "advanced_fb": sh["fb_frames"]},
            "band_movs": {"basic": sh["basic"],
                          "advanced_fft": sh["advanced_fft"][1:],
                          "advanced_fb": sh["fb_frames"]},
            # E1's d [N, CH, F, 512]
            "ehs_frames": dict.fromkeys(
                ("basic", "advanced_fft"), (1, 2, chunk, cuda_ehs.ROW)),
            # W1's E0
            "mask_frames": fb}[name]


def stream_cases(dtype, pair10) -> list:
    """Each kernel of the stream path at its chunk shapes, at the streams'
    chunk (STREAM_CHUNK) and the tools' (TOOL_CHUNK), at one stream and at
    the pool's POOL, from a generator of their own: K1 with y0 at the
    basic, advanced FFT and FB sites, K3 on both signals (109 and 55
    bands); the FB chunk on the 10 s pair's own rows (batch_fb_pair's,
    cut or tiled to two chunks): D3 on the second chunk with the state the
    first leaves, F1 on its output with the first's samples as history,
    D1 on F1's outputs with y0 = the first chunk's last cu, D2 on them,
    W1 at E0's shape on that cu with the first chunk's last 10 instants of
    cu as its tail (and at STREAM_CHUNK the one-frame flush).
    At the tools' chunk D2's plain version runs one stream at a time, which
    bounds its [..., Z, 8, I] temporaries."""
    srng = np.random.default_rng(10)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    def spread_fb_plain(re, im, cu, whole):
        if whole:
            return cuda_fb.spread_fb_plain(re, im, cu, k.lower_matrix)
        return torch.cat([cuda_fb.spread_fb_plain(
            re[:, i:i + 1], im[:, i:i + 1], cu[:, i:i + 1], k.lower_matrix)
            for i in range(re.shape[1])], 1)

    cases = []
    k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
    c1 = 24.0 + 230.0 / k.fc
    kb, ka = (FE.build_consts(EP.fft_ear_params(z), dtype, "cuda")
              for z in (C.BASIC_BAND_COUNT, C.ADVANCED_FFT_BAND_COUNT))
    for chunk, n in ((STREAM_CHUNK, 1), (STREAM_CHUNK, POOL),
                     (TOOL_CHUNK, 1), (TOOL_CHUNK, POOL)):
        shapes = stream_shapes(n, chunk)
        label = f"stream N={n}"
        cases += band_stream_cases(dtype, pair10, chunk, n)
        # S1 and S2 on the FFT steps' blocks: one S1 shape for both
        # steps, S2 with the basic step's flags and the advanced FFT
        # step's (both signals grouped, no bandwidth)
        blocks = fft_blocks(pair10, n, chunk)
        cases.append(frames_case(kb, f"{label} basic, advanced_fft "
                                 f"{list(blocks.shape[1:])}", blocks))
        spectra = spectra_of(kb, blocks)
        del blocks
        # E1 in each FFT step
        d = ehs_difference(kb, spectra)
        cases.append(ehs_case(f"{label} basic, advanced_fft "
                              f"{list(d.shape)}", d))
        for site, kf, flags in (("basic", kb, (False, True)),
                                ("advanced_fft", ka, (False, False))):
            cases.append(movs_case(kf, f"{label} {site} "
                                   f"{list(spectra.shape)}", spectra,
                                   *flags))
        # G1 in every step: the FFT steps' chunk of chunk + 1 hops and the
        # FB step's of 16 chunk frames, float32 samples (as the streams
        # ship them; the stream cases) and float64 (checked only)
        for ship in DTYPES:
            for form, n_frames in (("FFT", chunk), ("FB", 16 * chunk)):
                length = (n_frames + (form == "FFT")) * GATE_FORMS[form][1]
                sig = gate_signal(pair10, n, length).to(ship)
                case = f"{label} chunk {chunk} {form} {list(sig.shape)}"
                cases.append(gate_case(
                    case if ship == torch.float32
                    else f"float64 samples, {case}", sig, n_frames, form,
                    dtype))
        for site in ("basic", "advanced_fft", "fb_frames"):
            shape = shapes[site]
            a = t(np.exp(-srng.uniform(0.01, 0.5, shape[-2])))
            b = t(srng.standard_normal(shape))
            y0 = t(srng.standard_normal(shape[:-1]))
            cases.append(Case("recurrence_banded",
                              f"{label} {site} {list(shape)} y0",
                              lambda a=a, b=b, y0=y0:
                              cuda_iir.recurrence_banded(a, b, y0),
                              lambda a=a, b=b, y0=y0:
                              cuda_iir.recurrence_banded_plain(a, b, y0),
                              (a, b, y0)))
        for site in ("basic", "advanced_fft"):
            shape = shapes[site]
            c, cp = spread_consts(shape[-2], dtype)
            p = t(srng.uniform(1e-6, 1e4, (*shape[:3], shape[-1],
                                            shape[-2])))
            cases.append(Case("spread_fft", f"{label} {site} "
                              f"{list(p.shape)}",
                              lambda p=p, c=c:
                              cuda_spread_fft.spread_fft(p, *c),
                              lambda p=p, cp=cp:
                              cuda_spread_fft.spread_fft_plain(p, *cp),
                              (p, c[0], c[1], c[3])))
        t_fb = shapes["dc"][-1]
        x = batch_fb_pair(pair10, k, (*shapes["dc"][:-1],
                                      10 * C.SAMPLING_RATE))
        x = x.repeat(1, 1, 1, -(-2 * t_fb // x.shape[-1]))[..., :2 * t_fb]
        first, second = (x[..., :t_fb].contiguous(),
                         x[..., t_fb:].contiguous())
        del x
        hp1, st = cuda_dc.dc_chain_plain(first, k.level)
        del first
        cases.append(Case("dc_chain", f"{label} {list(second.shape)} state",
                          lambda x=second, st=st:
                          dc_out(cuda_dc.dc_chain(x, k.level, st)),
                          lambda x=second, st=st:
                          dc_out(cuda_dc.dc_chain_plain(x, k.level, st)),
                          (second, *st)))
        hp2, _ = cuda_dc.dc_chain_plain(second, k.level, st)
        hist = hp1[..., -FB.HIST_LEN:].contiguous()
        cases.append(fir_case(k, f"{label} {list(hp2.shape)} history", hp2,
                              hist, (hp2, hist)))
        re1, im1 = FB.filter_bank(k, hp1)
        re, im = FB.filter_bank(k, hp2, hist)
        del hp1
        check(re.shape == shapes["fb_instants"], f"FB chunk {re.shape}")
        cu1 = cuda_fb.slope_state_plain(re1, im1, c1, k.slope_a)
        y0 = cu1[..., -1].contiguous()
        tail = cu1[..., -FB.E0_TAIL:].contiguous()
        del re1, im1, cu1
        cu = cuda_fb.slope_state_plain(re, im, c1, k.slope_a, y0)
        cases.append(Case("slope_state", f"{label} {list(re.shape)} y0",
                          lambda re=re, im=im, y0=y0:
                          cuda_fb.slope_state(re, im, c1, k.slope_a, y0),
                          lambda re=re, im=im, y0=y0:
                          cuda_fb.slope_state_plain(re, im, c1, k.slope_a,
                                                    y0),
                          (re, im, c1, y0)))
        cases.append(Case("spread_fb", f"{label} {list(re.shape)}",
                          lambda re=re, im=im, cu=cu:
                          cuda_fb.spread_fb(re, im, cu, k.cl),
                          lambda re=re, im=im, cu=cu,
                          whole=chunk == STREAM_CHUNK:
                          spread_fb_plain(re, im, cu, whole),
                          (re, im, cu)))
        # W1 at the chunk's E0 shape on D1's cu, which D2's case holds (as
        # at the batch), carrying the first chunk's last 10 instants, and at
        # chunk 64 the one-frame flush after it
        cases.append(mask_case(k, f"{label} {list(cu.shape)}", cu, tail))
        if chunk == STREAM_CHUNK:
            flush = cu[..., :cuda_fb.FRAME_INSTANTS].contiguous()
            cases.append(mask_case(
                k, f"{label} flush {list(flush.shape)}", flush,
                cu[..., -FB.E0_TAIL:].contiguous()))
    return cases


def phase_kernels(rng, pair10) -> tuple[dict, dict, dict]:
    """Each kernel against its plain version; returns the main-shape
    error and the (kernel, plain) functions per kernel and dtype, per
    dtype the batch-shape cases (each with its error and bound) and per
    dtype the chunk-shape cases of the streams.  F1 also gives two
    launches bit for bit at each of its cases, and is checked at the
    hour's one shot (hour_fir)."""
    print("phase 3 kernels against their plain versions", flush=True)
    # first, while no case holds memory: its double outputs take 28 GB
    hour_fir(pair10)
    main = {name: {} for name in KERNELS}
    batch, stream = {}, {}
    for dtype in DTYPES:
        cases = batch_cases(dtype, rng, pair10)
        batch[dtype] = {"cases": []}
        stream[dtype] = []
        for c in (kernel_cases(dtype, rng, pair10) + cases
                  + stream_cases(dtype, pair10)):
            name, case = c.name, c.case
            bar = (DC_BARS if name == "dc_chain" else BARS)[dtype]
            out = c.kernel()
            got = stacked(out)
            torch.cuda.synchronize()
            if name in SPECTRAL:
                err, rel, ok, note = spectral_check(name, out, c.plain(),
                                                    dtype)
                line = (f"  {name} {case} {dtype}: max|d|/max|ref| "
                        f"{rel:.3e}{note}")
            elif name in BAND:
                err, rel, ok, note = band_check(name, out, c.plain(), dtype)
                line = (f"  {name} {case} {dtype}: max|d|/max|ref| "
                        f"{rel:.3e}{note}")
            elif name == "ehs_frames":
                err, rel, ok, note = ehs_check(got, c.plain(), c.inputs[0],
                                               dtype)
                line = (f"  {name} {case} {dtype}: max|d|/max(1, |ref|) "
                        f"{rel:.3e}{note}")
            elif name == "frame_gate":
                want = c.plain()
                ok = got.shape == want.shape and torch.equal(got, want)
                err = float(got.shape != want.shape or (got ^ want).any())
                line = (f"  {name} {case} {dtype}: {int(got.sum())} of "
                        f"{got.numel()} frames above, bits equal: {ok}")
                del want
            else:
                want = stacked(c.plain())
                err = (got - want).abs().max().item()
                # an all-zero reference (a silent edge case) is held
                # absolutely
                rel = err / max(want.abs().max().item(),
                                torch.finfo(dtype).tiny)
                line = f"  {name} {case} {dtype}: max|d|/max|ref| {rel:.3e}"
                ok = torch.isfinite(got).all().item() and rel < bar
                if name == "spread_fft" and dtype == torch.float32:
                    elem = ((got - want).abs() / want.abs()).max().item()
                    line += f", elementwise rel {elem:.3e}"
                    ok = ok and elem < 1e-4
                del want
            if name in ("fir_bank", "frame_gate", "ehs_frames", "mask_frames",
                        *SPECTRAL, *BAND):
                same = torch.equal(got, stacked(c.kernel()))
                line += f", two launches bit-identical: {same}"
                ok = ok and same
            print(line, flush=True)
            check(ok, f"{name} {case} {dtype} disagrees with its plain "
                      "version")
            extra = ({"padded_bound_ms": fir_bound(dtype, c.inputs, got)[2]}
                     if name == "fir_bank" and c.inputs else {})
            if name == "spectral_movs":
                extra["first_count_bound_ms"] = spectral_bound_first(
                    dtype, c.inputs, out)
            if name == "ehs_frames" and dtype == torch.float32:
                # E1 computes float rows in double: its bound at the
                # FP64 rate beside the float one
                extra["double_rate_bound_ms"] = bound(
                    name, torch.float64, c.inputs, out)[0]
            if case in ("F=468", "main", "Z=109"):
                bound_ms, bound_by = bound(name, dtype, c.inputs, out)
                main[name][dtype] = dict(max_abs_err=err, kernel=c.kernel,
                                         plain=c.plain, inputs=c.inputs,
                                         bound_ms=bound_ms,
                                         bound_by=bound_by, **extra)
            elif case.startswith(("batch", "stream")):
                bound_ms, bound_by = bound(name, dtype, c.inputs, out)
                (batch[dtype]["cases"] if case.startswith("batch")
                 else stream[dtype]).append(dict(
                    name=name, case=case, kernel=c.kernel, plain=c.plain,
                    inputs=c.inputs, max_abs_err=err, bound_ms=bound_ms,
                    bound_by=bound_by, **extra))
            del got, out
    dc_float32_rounding(rng, pair10)
    determinism(main)
    for dtype in DTYPES:
        for c in batch[dtype]["cases"] + stream[dtype]:
            first, second = (stacked(c["kernel"]()) for _ in range(2))
            same = torch.equal(first, second)
            print(f"  {c['name']} {c['case']} {dtype}: two launches "
                  f"bit-identical: {same}", flush=True)
            check(same, f"{c['name']} {c['case']} {dtype}: two launches "
                  "differ")
    return main, batch, stream


def hour_rows(pair10, k) -> torch.Tensor:
    """HOUR_ROWS of hp2 on the card in k's spectrum dtype: the 10 s pair's
    four FB rows through the plain DC stage, tiled 360 times."""
    hp2, _ = cuda_dc.dc_chain_plain(fb_rows(pair10, k).reshape(4, -1),
                                    k.level)
    return hp2.repeat(1, HOUR_ROWS[1] // hp2.shape[-1])


def hour_fir(pair10) -> None:
    """F1 at the hour's one shot, HOUR_ROWS (each part's outputs 6.9 GB in
    double, their offsets past 2^31 bytes), in both dtypes: its outputs
    over the first, middle and last 10 s of all four rows against
    fir_bank_plain on those windows (the 1,536 samples before each as its
    history; none at the start), held to BARS; two launches bit for
    bit."""
    span = 10 * C.SAMPLING_RATE
    for dtype in DTYPES:
        k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
        x = hour_rows(pair10, k)
        re, im = cuda_fir.fir_bank(x, k.fir_weight, k.fir_plan)
        torch.cuda.synchronize()
        err = ref = 0.0
        for a in (0, x.shape[-1] // 2, x.shape[-1] - span):
            hist = None if a == 0 else x[:, a - FB.HIST_LEN:a]
            with api.full_precision_matmuls():
                want = torch.stack(cuda_fir.fir_bank_plain(
                    x[:, a:a + span], k.fir_weight, hist))
            cut = slice(a // FB.SUB, (a + span) // FB.SUB)
            got = torch.stack([re[..., cut], im[..., cut]])
            err = max(err, (got - want).abs().max().item())
            ref = max(ref, want.abs().max().item())
            del got, want
        again = cuda_fir.fir_bank(x, k.fir_weight, k.fir_plan)
        same = torch.equal(re, again[0]) and torch.equal(im, again[1])
        del again, re, im, x
        print(f"  fir_bank hour {list(HOUR_ROWS)} {dtype}: three 10 s "
              f"windows against plain: max|d|/max|ref| {err / ref:.3e}, "
              f"two launches bit-identical: {same}", flush=True)
        check(err / ref < BARS[dtype] and same,
              f"fir_bank hour {dtype}: {err / ref}, bit-identical {same}")
        gc.collect()
        torch.cuda.empty_cache()


def hour_times(pair10) -> dict:
    """F1 at HOUR_ROWS (hour_rows) per dtype: the kernel's device time
    (cuda_ms, 3 rounds of one call) and its plain version's (one call, TF32
    off: the cuDNN conv1d, its library call too) beside fir_bound's
    bounds.  Returns them per dtype."""
    out = {}
    for dtype in DTYPES:
        k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
        x = hour_rows(pair10, k)
        ms, _ = cuda_ms(lambda: cuda_fir.fir_bank(
            x, k.fir_weight, k.fir_plan), calls=1, rounds=3, warmup=1)
        with api.full_precision_matmuls():
            result, plain_ms = once_ms(lambda: cuda_fir.fir_bank_plain(
                x, k.fir_weight))
        del result
        n = x.shape[-1] // FB.SUB
        outputs = torch.empty((2, x.shape[0], C.FB_BAND_COUNT, n),
                              dtype=dtype, device="meta")
        bound_ms, bound_by, padded = fir_bound(dtype, (x,), outputs)
        out[dtype] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=plain_ms)
        print(f"  fir_bank hour {list(HOUR_ROWS)} {dtype}: kernel "
              f"{ms:.4f} ms, {bound_ms / ms:.1%} of its bound "
              f"{bound_ms:.4f} ms ({bound_by}; {padded / ms:.1%} of the "
              f"uniform conv's {padded:.4f} ms), plain = library (cuDNN "
              f"conv1d, one call) {plain_ms:.4f} ms", flush=True)
        del x
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dc_float32_rounding(rng, pair10) -> None:
    """The float32 DC cascade's own rounding, which D3's float32 bar
    allows for: the float32 kernel against the float64 plain version on
    the pair's FB rows and on white noise, max|d| / max|hp2|."""
    k = FB.build_consts(EP.fb_ear_params(), torch.float64, "cuda")
    rows = {"main": (fb_rows(pair10, k).reshape(4, -1), k.level),
            "noise T=49152": (torch.as_tensor(
                rng.standard_normal((2, 49152)) * 2500.0, device="cuda"),
                0.0357)}
    for case, (x64, lf) in rows.items():
        got, _ = cuda_dc.dc_chain(x64.float(), float(np.float32(lf)))
        want, _ = cuda_dc.dc_chain_plain(x64, lf)
        rel = (got.double() - want).abs().max() / want.abs().max()
        print(f"  dc_chain {case} float32 kernel against float64 plain: "
              f"max|d|/max|hp2| {rel.item():.3e}", flush=True)


def determinism(main: dict) -> None:
    """Two launches of each kernel at its main shape (D1 and D3 on the
    pair's own FB rows) give the same bits, in both dtypes: no atomics, and
    every carry is folded in one fixed order."""
    for name in KERNELS:
        for dtype in DTYPES:
            kernel = main[name][dtype]["kernel"]
            first, second = (stacked(kernel()) for _ in range(2))
            same = torch.equal(first, second)
            print(f"  {name} main {dtype}: two launches bit-identical: "
                  f"{same}", flush=True)
            check(same, f"{name} {dtype}: two launches differ")


def ten_second_pair() -> tuple[np.ndarray, np.ndarray]:
    """A 10 s stereo pair from a seed: a 440 Hz sine plus noise below
    16 kHz, and the same plus small white noise.  The content past bin 346
    keeps the bandwidth MOVs' validity gate open."""
    n = 10 * C.SAMPLING_RATE
    rng = np.random.default_rng(0)
    spec = np.fft.rfft(rng.standard_normal((n, 2)), axis=0)
    spec[16000 * n // C.SAMPLING_RATE:] = 0
    noise = np.fft.irfft(spec, n=n, axis=0)
    ref = (0.5 * TS.sine(n, 440)[:, None] + 0.05 * noise).astype(np.float32)
    test = (ref + 0.005 * rng.standard_normal((n, 2))).astype(np.float32)
    return ref, test


def check_fingerprint(spec: dict, pair) -> None:
    """The frozen spec belongs to this pair: the same shape, each channel's
    sum of squares within 1e-7 relative and the picked samples within 1e-6
    (another numpy may round a float32 sample of the pair differently)."""
    fp = spec["pair"]
    for sig, sum_sq, samples in zip(pair, fp["sum_sq"], fp["samples"]):
        got_sq = np.sum(np.square(sig, dtype=np.float64), axis=0)
        check(list(sig.shape) == fp["shape"]
              and np.allclose(got_sq, sum_sq, rtol=1e-7, atol=0.0)
              and np.allclose(sig[fp["picks"]], samples, rtol=0.0,
                              atol=1e-6),
              "the 10 s pair does not match the frozen spec's fingerprint "
              f"({SPEC.name}): the spec belongs to another pair")


def load_spec(pair) -> dict:
    spec = json.loads(SPEC.read_text())
    check_fingerprint(spec, pair)
    return spec


def pinned_pairs() -> dict:
    n = 128 * 1024
    sine, saw, tri = TS.sine(n), TS.saw(n), TS.triangle(n)
    return {"sine/sine": (sine, sine), "saw/tri": (saw, tri),
            "saw/tri stereo": (np.stack([saw, saw], 1),
                               np.stack([tri, tri], 1))}


def against_spec(got, want: dict, mode: str) -> None:
    """One mode's float64 result on the 10 s pair against the frozen NumPy
    spec: the ODG within 1e-6 and each MOV within 1e-6 (1 + |w|)."""
    names = C.MOV_BASIC_NAMES if mode == "basic" else C.MOV_ADVANCED_NAMES
    worst = max(abs(got.movs[n] - want["movs"][n]) / (1 + abs(want["movs"][n]))
                for n in names)
    print(f"  10 s stereo pair: ODG {got.odg:.9f}, NumPy spec "
          f"{want['odg']:.9f} ({SPEC.name}); MOVs within {worst:.2e} "
          f"(1 + |w|)")
    check(abs(got.odg - want["odg"]) <= 1e-6, f"float64 {mode} 10 s pair ODG")
    for name in names:
        w, g = want["movs"][name], got.movs[name]
        ok = np.isnan(g) if np.isnan(w) else abs(g - w) <= 1e-6 * (1 + abs(w))
        check(ok, f"float64 {mode} 10 s pair {name}: {g} against {w}")


def phase_float64(pair10, spec: dict) -> float:
    print("phase 4 main path, float64", flush=True)
    pinned = {"sine/sine": "0.171", "saw/tri": "-2.007",
              "saw/tri stereo": "-2.007"}
    for label, (ref, test) in pinned_pairs().items():
        odg = api.peaq(ref, test, dtype="float64").odg
        print(f"  {label}: ODG {odg:.6f}")
        check(f"{odg:.3f}" == pinned[label],
              f"float64 {label} ODG {odg:.6f} is not {pinned[label]}")
    got = api.peaq(*pair10, dtype="float64")
    against_spec(got, spec["basic"], "basic")
    return got.odg


def phase_tiers(pair10, odg64: float) -> None:
    """The basic float32 and accurate tiers: saw/tri within 2e-3 of -2.007
    and the 10 s pair within 2e-3 of float64 in each.  The identical sine
    pair: accurate (the float32 band chain on float64 spectra) within 1e-2
    of 0.171; float32 misses that bar, since its bandwidth MOVs compare
    bins against the float32 rDFT's rounding floor, and is bounded at 0.05
    from 0.171, set from the readings of PERF.md section 6.  The phase
    prints the sine pair's bandwidth MOVs and ODG per tier on the card and
    on the CPU, and checks that "mixed" gives float32's result."""
    print("phase 5 main path, tiers", flush=True)
    pairs = pinned_pairs()
    sine_pair = pairs["sine/sine"]
    readings = {}
    for label, dtype, device in (("float64 card", "float64", "cuda"),
                                 ("float32 card", "float32", "cuda"),
                                 ("float32 cpu", "float32", "cpu"),
                                 ("accurate card", "accurate", "cuda"),
                                 ("accurate cpu", "accurate", "cpu")):
        readings[label] = api.peaq(*sine_pair, dtype=dtype, device=device)
    for label, res in readings.items():
        others = max(abs(res.movs[n] - readings["float64 card"].movs[n])
                     / (1 + abs(readings["float64 card"].movs[n]))
                     for n in C.MOV_BASIC_NAMES if "Bandwidth" not in n)
        print(f"  sine/sine {label}: ODG {res.odg:.6f}, BandwidthRefB "
              f"{res.movs['BandwidthRefB']:.4f}, BandwidthTestB "
              f"{res.movs['BandwidthTestB']:.4f}, other MOVs within "
              f"{others:.2e} of float64 card")
    accurate = readings["accurate card"].odg
    check(abs(accurate - 0.171) <= 1e-2, f"accurate sine/sine ODG {accurate}")
    sine = readings["float32 card"].odg
    check(abs(sine - 0.171) <= 0.05, f"float32 sine/sine ODG {sine}")
    mixed = api.peaq(*sine_pair, dtype="mixed")
    check(mixed.odg == sine and mixed.movs == readings["float32 card"].movs,
          "mixed differs from float32")
    for tier in ("float32", "accurate"):
        saw = api.peaq(*pairs["saw/tri"], dtype=tier).odg
        ten = api.peaq(*pair10, dtype=tier).odg
        print(f"  {tier}: saw/tri {saw:.6f}, 10 s pair {ten:.6f} (float64 "
              f"{odg64:.6f})")
        check(abs(saw + 2.007) <= 2e-3, f"{tier} saw/tri ODG {saw}")
        check(abs(ten - odg64) <= 2e-3, f"{tier} 10 s pair ODG {ten}")


def phase_adv_float64(pair10, spec: dict):
    """The advanced path in float64 on the 10 s pair against the frozen
    NumPy spec, each MOV within 1e-6 (1 + |w|) and the ODG within 1e-6."""
    print("phase 4b advanced path, float64", flush=True)
    got = api.peaq(*pair10, advanced=True, dtype="float64")
    against_spec(got, spec["advanced"], "advanced")
    return got


def phase_adv_float32(pair10, adv64) -> None:
    """The advanced float32 tier within 2e-3 ODG of the card's float64
    (adv64: phase 4b's result) on the 10 s pair and on saw/triangle at
    128 x 1024 samples; each MOV's deviation is printed."""
    print("phase 5b advanced path, float32", flush=True)
    n = 128 * 1024
    saw_tri = (TS.saw(n), TS.triangle(n))
    pairs = {"10 s pair": (pair10, adv64),
             "saw/tri": (saw_tri, api.peaq(*saw_tri, advanced=True,
                                           dtype="float64"))}
    for label, (pair, f64) in pairs.items():
        f32 = api.peaq(*pair, advanced=True, dtype="float32")
        devs = ", ".join(f"{m} {f32.movs[m] - f64.movs[m]:+.2e}"
                         for m in C.MOV_ADVANCED_NAMES)
        print(f"  {label}: float32 ODG {f32.odg:.6f}, float64 "
              f"{f64.odg:.6f}; MOVs float32 - float64: {devs}")
        check(abs(f32.odg - f64.odg) <= 2e-3,
              f"advanced float32 {label} ODG {f32.odg} against {f64.odg}")


@functools.cache
def corpus_v2(items: int = 20, seconds: float = 10.0):
    """corpus.realistic_pairs(items, seconds), made once (phases 5c and
    10)."""
    return corpus.realistic_pairs(items, seconds)


def phase_corpus(items: int = 20, seconds: float = 10.0) -> dict:
    """Drift corpus v2 (realistic_pairs(20, 10.0): seed 3, stereo 10 s)
    through float64, float32 and accurate in both modes.  Per tier and mode:
    the worst |dODG| against the card's float64 and the item that sets it,
    and the worst MOV deviation |d| / (1 + |w|) with its MOV and item.
    accurate is held within CONFORMANCE_BAR and ACCURATE_BAR in both modes;
    float32, the control, must miss ACCURATE_BAR, so that the bar tells the
    tiers apart.  A NaN in both tiers counts as agreement, in one alone as
    inf.  "mixed" equals float32 on the first item.  Returns the worst
    |dODG| per (mode, tier)."""
    print("phase 5c drift corpus v2", flush=True)
    refs, tests = corpus_v2(items, seconds)
    worst = {}
    for mode in MODES:
        advanced = mode == "advanced"
        names = C.MOV_ADVANCED_NAMES if advanced else C.MOV_BASIC_NAMES
        res = {tier: [api.peaq(r, t, advanced=advanced, dtype=tier)
                      for r, t in zip(refs, tests)] for tier in TIERS}

        def dev(g, w, scale=0.0):
            if np.isnan(w) or np.isnan(g):
                return 0.0 if np.isnan(w) and np.isnan(g) else math.inf
            return abs(g - w) / (1.0 + scale * abs(w))

        for tier in TIERS[1:]:
            odg = [dev(g.odg, w.odg) for g, w in zip(res[tier],
                                                     res["float64"])]
            movs = [(dev(g.movs[n], w.movs[n], 1.0), n, i)
                    for i, (g, w) in enumerate(zip(res[tier], res["float64"]))
                    for n in names]
            i = int(np.argmax(odg))
            mov = max(movs)
            worst[mode, tier] = odg[i]
            print(f"  {mode} {tier}: worst |dODG| {odg[i]:.3e} at item "
                  f"{i + 1} (float64 ODG {res['float64'][i].odg:.6f}); "
                  f"worst MOV |d|/(1 + |w|) {mov[0]:.3e} ({mov[1]}, item "
                  f"{mov[2] + 1}); within {CONFORMANCE_BAR:g}: "
                  f"{odg[i] <= CONFORMANCE_BAR}, within {ACCURATE_BAR:g}: "
                  f"{odg[i] <= ACCURATE_BAR}", flush=True)
        mixed = api.peaq(refs[0], tests[0], advanced=advanced, dtype="mixed")
        check(mixed.odg == res["float32"][0].odg
              and mixed.movs == res["float32"][0].movs,
              f"{mode} mixed differs from float32")
        for bar in (CONFORMANCE_BAR, ACCURATE_BAR):
            check(worst[mode, "accurate"] <= bar,
                  f"{mode} accurate drifts {worst[mode, 'accurate']} ODG "
                  f"from float64 on corpus v2, past {bar:g}")
        check(not worst[mode, "float32"] <= ACCURATE_BAR,
              f"{mode} float32 drifts only {worst[mode, 'float32']} ODG on "
              f"corpus v2: the bar {ACCURATE_BAR:g} does not tell it from "
              "accurate")
    return worst


# torch.nn.functional.conv1d calls since reset_counts(): count_conv1d()
# wraps it, so that a main path's run shows it left no cuDNN conv
CONV1D_CALLS = [0]


def count_conv1d() -> None:
    conv1d = torch.nn.functional.conv1d

    def counted(*args, **kwargs):
        CONV1D_CALLS[0] += 1
        return conv1d(*args, **kwargs)

    torch.nn.functional.conv1d = counted


# framing.above_threshold_signal calls on a CUDA tensor since reset_counts():
# count_plain_gate() wraps it, so that a main path's run shows that each of
# its gates went through G1
PLAIN_GATE_CALLS = [0]


def count_plain_gate() -> None:
    plain = framing.above_threshold_signal

    def counted(sig, *args, **kwargs):
        if sig.is_cuda:
            PLAIN_GATE_CALLS[0] += 1
        return plain(sig, *args, **kwargs)

    framing.above_threshold_signal = counted


# movs.ehs_values (E1's plain version) and torch.fft.irfft calls on a CUDA
# tensor since reset_counts(): count_plain_ehs() wraps both, so that a main
# path's run shows that its EHS went through E1 and that no cuFFT C2R
# transform is left on it
PLAIN_EHS_CALLS = [0]
C2R_CALLS = [0]


def count_plain_ehs() -> None:
    plain, irfft = MOVS.ehs_values, torch.fft.irfft

    def counted(d, *args, **kwargs):
        if d.is_cuda:
            PLAIN_EHS_CALLS[0] += 1
        return plain(d, *args, **kwargs)

    def counted_irfft(x, *args, **kwargs):
        if x.is_cuda:
            C2R_CALLS[0] += 1
        return irfft(x, *args, **kwargs)

    MOVS.ehs_values = counted
    torch.fft.irfft = counted_irfft


# cuda_fb.mask_frames_plain (W1's plain version, the eager masking sums)
# calls on a CUDA tensor since reset_counts(): count_plain_mask() wraps it,
# so that a main path's run shows that its masking went through W1
PLAIN_MASK_CALLS = [0]


def count_plain_mask() -> None:
    plain = cuda_fb.mask_frames_plain

    def counted(e0, *args, **kwargs):
        if e0.is_cuda:
            PLAIN_MASK_CALLS[0] += 1
        return plain(e0, *args, **kwargs)

    cuda_fb.mask_frames_plain = counted


def reset_counts() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)
    CONV1D_CALLS[0] = 0
    PLAIN_GATE_CALLS[0] = 0
    PLAIN_EHS_CALLS[0] = 0
    C2R_CALLS[0] = 0
    PLAIN_MASK_CALLS[0] = 0


def read_counts() -> dict:
    """Each kernel's launches since reset_counts(); fails if a conv1d ran
    (the FIR bank's plain version: a main path runs F1), the plain gate,
    EHS's plain version or the eager masking sums ran on the card (a main
    path runs G1, E1 and W1), or a C2R transform (torch.fft.irfft) did."""
    check(CONV1D_CALLS[0] == 0, f"{CONV1D_CALLS[0]} conv1d call(s) on a "
          "main path")
    check(PLAIN_GATE_CALLS[0] == 0, f"{PLAIN_GATE_CALLS[0]} plain gate "
          "call(s) on the card on a main path")
    check(PLAIN_EHS_CALLS[0] == 0, f"{PLAIN_EHS_CALLS[0]} plain EHS "
          "call(s) on the card on a main path")
    check(C2R_CALLS[0] == 0, f"{C2R_CALLS[0]} irfft call(s) on the card "
          "on a main path")
    check(PLAIN_MASK_CALLS[0] == 0, f"{PLAIN_MASK_CALLS[0]} eager masking "
          "sum call(s) on the card on a main path")
    return {name: getattr(module, attr)
            for name, (module, attr) in COUNTERS.items()}


def phase_counters(pair10, pairs) -> dict:
    """Each mode's peaq() of the 10 s pair in each tier, with every count
    set to 0 just before it and read just after.  Each tier makes the same
    launches: 3/1/1/0/0/0/0/1/1/1 (basic) and 4/1/1/1/1/1/1/1/1/2
    (advanced) of K1, K2, K3, D1, D2, D3, F1, S1, S2, G1 (PATH_LAUNCHES
    for every kernel), and no conv1d, no plain gate, no plain EHS and no
    eager masking sums on the card (read_counts).
    Then one peaq_batch() of the first 8 and of the first
    32 of `pairs` (one microbatch each) per mode and tier, counted the
    same way: a microbatch launches each kernel as often as one pair does.
    Returns each kernel's counts per path in float32 (0 where a path does
    not launch it; the batch paths at microbatch 32)."""
    print("phase 6 launch counters", flush=True)
    want = PATH_LAUNCHES
    counts = {name: {} for name in COUNTERS}
    for tier in TIERS:
        for mode in MODES:
            reset_counts()
            result = api.peaq(*pair10, advanced=mode == "advanced",
                              dtype=tier)
            got = read_counts()
            print(f"  {tier} {mode} peaq() of the 10 s pair: ODG "
                  f"{result.odg:.6f}, launches {got}")
            check(np.isfinite(result.odg), f"{tier} {mode} ODG is not finite")
            check(got == want[mode], f"{tier} {mode}: launches {got}, "
                  f"expected {want[mode]}")
            if tier == "float32":
                for name, n in got.items():
                    counts[name][mode] = n
    for mb in (8, 32):
        refs, tests = (x[:mb] for x in pairs)
        for tier in TIERS:
            for mode in MODES:
                reset_counts()
                out = PB.peaq_batch(refs, tests, advanced=mode == "advanced",
                                    dtype=tier, microbatch=mb)
                got = read_counts()
                print(f"  {tier} {mode} peaq_batch() of {mb} pairs in one "
                      f"microbatch: ODGs {out['odg'].min():.6f}.."
                      f"{out['odg'].max():.6f}, launches {got}")
                check(np.isfinite(out["odg"]).all(),
                      f"{tier} {mode} batch ODG is not finite")
                check(got == want[mode], f"{tier} {mode} batch of {mb}: "
                      f"launches {got}, expected {want[mode]}")
                if tier == "float32" and mb == 32:
                    for name, n in got.items():
                        counts[name][f"batch_{mode}"] = n
    stream_step_counts(pair10)
    return counts


def stream_step_counts(pair10) -> None:
    """One chunk step of each stream path per tier, at one stream and at
    POOL, each counted from 0 as a call is: a pool fed (STREAM_CHUNK + 1)
    x 1024 samples of the 10 s pair runs one step (basic) or one FFT step
    (advanced); an advanced pool then fed up to 16 STREAM_CHUNK FB frames
    runs one more FFT step and one FB step, whose counts less the first
    feed's are the FB step's.  Each is held to STREAM_STEP_LAUNCHES."""
    fft_need = (STREAM_CHUNK + 1) * C.FFT_STEPSIZE
    fb_need = 16 * STREAM_CHUNK * C.FB_FRAMESIZE
    for tier in TIERS:
        for n in (1, POOL):
            def piece(lo, hi):
                return tuple(np.broadcast_to(x[lo:hi], (n, hi - lo, 2))
                             for x in pair10)
            for mode in MODES:
                pool = PS.PeaqStreamPool(n, chunk_frames=STREAM_CHUNK,
                                         dtype=tier,
                                         advanced=mode == "advanced")
                reset_counts()
                pool.feed(*piece(0, fft_need))
                first = read_counts()
                if mode == "basic":
                    got = {"basic": first}
                else:
                    reset_counts()
                    pool.feed(*piece(fft_need, fb_need))
                    second = read_counts()
                    got = {"advanced_fft": first,
                           "advanced_fb": {name: second[name] - first[name]
                                           for name in second}}
                for path, counts in got.items():
                    print(f"  {tier} stream {path} chunk step, {n} "
                          f"stream(s): launches {counts}")
                    check(counts == STREAM_STEP_LAUNCHES[path],
                          f"{tier} stream {path} at {n}: launches {counts}, "
                          f"expected {STREAM_STEP_LAUNCHES[path]}")


def peaq_call(pair10, mode: str, tier: str):
    return api.peaq(*pair10, advanced=mode == "advanced", dtype=tier)


def site_cases(dtype, pair10) -> list:
    """The call sites of the advanced path whose shapes differ from the
    main-shape cases (those of the basic path, for K1-K3, S1, S2 and G1),
    on inputs from a generator of their own: K1 smears the reference's 55
    FFT bands in time once and runs three times over the 40 FB bands of
    2,500 frames (forward masking and the level adapter's two smoothers),
    K2 runs over the FB bands, K3 spreads the reference alone, S2 groups
    it alone, without the bandwidth, on the 10 s pair's spectra, G1
    gates the FB frames of the 10 s pair's reference (float32 samples),
    and W1 forms the one-shot 10-minute program's masking sums."""
    srng = np.random.default_rng(6)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    cases = []
    for z, shape, label in ((55, (2, 55, 468), "time smear"),
                            (40, (2, 2, 40, 2500), "FB, 3 sites")):
        a = t(np.exp(-srng.uniform(0.01, 0.5, z)))
        b = t(srng.standard_normal(shape))
        cases.append(Case("recurrence_banded", f"advanced {label} "
                          f"{list(shape)}",
                          lambda a=a, b=b: cuda_iir.recurrence_banded(a, b),
                          lambda a=a, b=b:
                          cuda_iir.recurrence_banded_plain(a, b),
                          (a, b)))
    a = t(np.exp(-srng.uniform(0.01, 0.5, 40)))
    exc2, uns2 = (t(srng.uniform(0.01, 10.0, (2, 2, 40, 2500)))
                  for _ in range(2))
    scale = C.SAMPLING_RATE / C.FB_FRAMESIZE
    cases.append(Case("fused_mod_smoothers", "advanced [2, 2, 40, 2500]",
                      lambda: cuda_iir.fused_mod_smoothers(a, exc2, uns2,
                                                           scale),
                      lambda: cuda_iir.fused_mod_smoothers_plain(
                          a, exc2, uns2, scale),
                      (a, exc2, uns2)))
    c, cp = spread_consts(55, dtype)
    p = t(srng.uniform(1e-6, 1e4, (2, 468, 55)))
    cases.append(Case("spread_fft", "advanced ref only [2, 468, 55]",
                      lambda: cuda_spread_fft.spread_fft(p, *c),
                      lambda: cuda_spread_fft.spread_fft_plain(p, *cp),
                      (p, c[0], c[1], c[3])))
    ka = FE.build_consts(EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT), dtype,
                         "cuda")
    spectra = spectra_of(ka, fft_blocks(pair10, 1, MAIN[3]))
    cases.append(movs_case(ka, f"advanced ref only {list(spectra.shape)}",
                           spectra, True, False))
    sig = gate_signal(pair10, 1, 10 * C.SAMPLING_RATE)
    cases.append(gate_case(f"advanced FB {list(sig.shape)}", sig,
                           FB_PAIR_FRAMES, "FB", dtype))
    k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
    e0 = one_shot_e0(t(srng.uniform(0.1, 10.0, (2, 1, 2, C.FB_BAND_COUNT,
                                                 FB_MAIN[-1]))))
    cases.append(mask_case(k, f"one shot 600 s {list(e0.shape)}", e0))
    return cases


def k1_library(a, b, label: str, calls: int = 2, rounds: int = 5,
               warmup: int = 3, want=None) -> float:
    """K1's function (y0 = None) as one PyTorch call, timed as cuda_ms
    does (`calls`, `rounds`, `warmup`) and held against the plain version
    (`want`, its output where already computed): a grouped causal conv1d
    of each row [1, rows, F] with the weight w[k] = a_z^(F - 1 - k)
    (powers in float64, built before the timing), padding F - 1, one group
    a row, TF32 off; y is its first F outputs.  Returns the call's ms."""
    f = b.shape[-1]
    rows = b.numel() // f
    n = torch.arange(f - 1, -1, -1, dtype=torch.float64, device=b.device)
    weight = (a.double()[:, None] ** n).to(b.dtype).repeat(
        rows // a.numel(), 1)[:, None, :].contiguous()
    x = b.reshape(1, rows, f)

    def call():
        return torch.nn.functional.conv1d(x, weight, padding=f - 1,
                                          groups=rows)

    with api.full_precision_matmuls():
        ms, _ = cuda_ms(call, calls=calls, rounds=rounds, warmup=warmup)
        got = call()[..., :f].reshape(b.shape)
    if want is None:
        want = cuda_iir.recurrence_banded_plain(a, b)
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"  recurrence_banded {label} {b.dtype}: library call (grouped "
          f"causal conv1d) {ms:.4f} ms, max|d|/max|ref| {err:.3e} against "
          f"plain")
    return ms


def once_ms(fn) -> tuple[object, float]:
    """fn()'s result and its time in ms between CUDA events, one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def long_rows() -> dict:
    """K1 and K2 at LONG_ROW, the one-shot FB rows of a 10-minute program
    (59 tiles a row), beside their bounds, their plain versions (one call:
    the plain frame loop launches its kernels for seconds) and K1's library
    call (k1_library: one call after the host's round, which warms it),
    held against the plain version's output, in both dtypes, on inputs
    from a generator of their own; K1 over the row equals K1 over its two
    halves carried by y0 within BARS.  Returns ms, plain_ms, bound_ms,
    bound_by and library_ms (None for K2) per kernel and dtype."""
    lrng = np.random.default_rng(11)
    out = {"recurrence_banded": {}, "fused_mod_smoothers": {}}
    scale = C.SAMPLING_RATE / C.FB_FRAMESIZE
    half = LONG_ROW[-1] // 2
    for dtype in DTYPES:
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device="cuda")
        a = t(np.exp(-lrng.uniform(0.01, 0.5, LONG_ROW[-2])))
        b = t(lrng.standard_normal(LONG_ROW))
        exc2, uns2 = (t(lrng.uniform(0.01, 10.0, LONG_ROW))
                      for _ in range(2))
        whole = cuda_iir.recurrence_banded(a, b)
        first = cuda_iir.recurrence_banded(a, b[..., :half].contiguous())
        halves = torch.cat([first, cuda_iir.recurrence_banded(
            a, b[..., half:].contiguous(), first[..., -1])], -1)
        err = ((halves - whole).abs().max() / whole.abs().max()).item()
        print(f"  recurrence_banded {list(LONG_ROW)} {dtype}: two halves "
              f"carried by y0 against the whole row: max|d|/max|ref| "
              f"{err:.3e}")
        check(err < BARS[dtype], f"K1 long row {dtype}: halves differ")
        del whole, first, halves
        for name, fn, plain, inputs in (
                ("recurrence_banded",
                 lambda: cuda_iir.recurrence_banded(a, b),
                 lambda: cuda_iir.recurrence_banded_plain(a, b), (a, b)),
                ("fused_mod_smoothers",
                 lambda: cuda_iir.fused_mod_smoothers(a, exc2, uns2, scale),
                 lambda: cuda_iir.fused_mod_smoothers_plain(a, exc2, uns2,
                                                            scale),
                 (a, exc2, uns2))):
            ms, _ = cuda_ms(fn, calls=5, rounds=5, cover_host=True)
            want, plain_ms = once_ms(plain)
            library_ms = (k1_library(a, b, f"{list(LONG_ROW)}", calls=1,
                                     rounds=1, warmup=0, want=want)
                          if name == "recurrence_banded" else None)
            del want
            bound_ms, bound_by = bound(name, dtype, inputs, stacked(fn()))
            out[name][dtype] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
            print(f"  {name} {list(LONG_ROW)} (a 10-minute program's "
                  f"one-shot FB rows) {dtype}: kernel {ms:.4f} ms, "
                  f"{bound_ms / ms:.1%} of its bound {bound_ms:.5f} ms "
                  f"({bound_by}), plain {plain_ms:.1f} ms (one call)")
    return out


def ehs_shared() -> int:
    """E1's dynamic shared memory a block: csrc/ehs.cu's kShared, its
    expression taken over the source's own integer constants."""
    text = (_build.CSRC / "ehs.cu").read_text()
    names = {k: int(v) for k, v in re.findall(
        r"\b(k\w+) = (\d+)[;,]", text)}
    expr = " ".join(re.search(r"constexpr int kShared = ([^;]+);",
                              text)[1].split())
    assert re.fullmatch(r"[\w *+]+", expr), expr
    return eval(expr, {"__builtins__": {}}, names)


def ehs_report() -> None:
    """E1's registers, spills and static shared memory from the build's
    ptxas report (_build's log), and the dynamic shared memory a block of
    its launches."""
    entry, spills = None, ""
    for line in _build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"ehs_frames_kernelI([fd])", line)
            entry = m and {"f": torch.float32, "d": torch.float64}[m[1]]
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "Used" in line:
            print(f"  ehs_frames {entry} rows: "
                  f"{line.split(':', 1)[1].strip()}; {spills}; dynamic "
                  f"shared memory {ehs_shared()} B a block of "
                  f"{cuda_ehs.WARPS} row warps and a helper, "
                  f"{cuda_ehs.RESIDENT} blocks an SM", flush=True)
            entry = None


def fir_note(name: str, entry: dict) -> str:
    """For F1: its plain version is also its library call (the cuDNN
    conv1d, TF32 off), and its share of the uniform conv's bound.  For S1,
    S2, G1 and W1: that no single PyTorch call computes their functions.  For
    E1 on float rows, which it computes in double: its share of the bound
    at the FP64 rate."""
    if name == "spectral_movs" and "first_count_bound_ms" in entry:
        b = entry["first_count_bound_ms"]
        return (f"; {b / entry['ms']:.1%} of the bound as first counted "
                f"(all 1,025 bins read) {b:.5f} ms; library: none (no "
                "single PyTorch call)")
    if name in (*SPECTRAL, "frame_gate", "mask_frames"):
        return "; library: none (no single PyTorch call)"
    if name == "ehs_frames" and "double_rate_bound_ms" in entry:
        b = entry["double_rate_bound_ms"]
        return (f"; computed in double: {b / entry['ms']:.1%} of the bound "
                f"at the FP64 rate, {b:.5f} ms")
    if name != "fir_bank":
        return ""
    entry["library_ms"] = entry["plain_ms"]
    return (f"; {entry['padded_bound_ms'] / entry['ms']:.1%} of the uniform "
            f"conv's bound {entry['padded_bound_ms']:.5f} ms; plain = "
            f"library (cuDNN conv1d)")


@contextlib.contextmanager
def fir_parts_forced(p: int):
    """cuda_fir.fir_bank with its groups split into p parts, whatever
    launch_grid would choose (its other outputs kept)."""
    chosen = cuda_fir.launch_grid

    def forced(*args):
        tiles, _, _, strip_rows, smem = chosen(*args)
        return tiles, p, args[0] * tiles * p, strip_rows, smem

    cuda_fir.launch_grid = forced
    try:
        yield
    finally:
        cuda_fir.launch_grid = chosen


def fir_parts(main: dict) -> None:
    """F1 with its groups split into each count of parts it can take
    (fir_parts_forced) beside launch_grid's choice, at the shapes whose
    grid is small enough to be split: the per-pair shape (phase 3's main
    case) and the chunk-64 FB step of one stream with a history, per
    dtype.  Device times (cuda_ms, 20 calls a round) in the order 1 .. P
    then P .. 1, each part count's two readings printed; each split's
    outputs against the chosen one's, bit for bit (each output is one
    block's sum, in one order, whatever the part)."""
    gen = torch.Generator(device="cuda").manual_seed(53)
    for dtype in DTYPES:
        k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
        sh = stream_shapes(1)["dc"]
        step = torch.randn(sh, generator=gen, device="cuda", dtype=dtype)
        hist = torch.randn((*sh[:-1], FB.HIST_LEN), generator=gen,
                           device="cuda", dtype=dtype)
        for label, x, h in (
                (f"main {list(main['fir_bank'][dtype]['inputs'][0].shape)}",
                 main["fir_bank"][dtype]["inputs"][0], None),
                (f"stream N=1 {list(sh)} history", step, hist)):
            chosen = cuda_fir.launch_grid(
                x.numel() // x.shape[-1], x.shape[-1], dtype, k.fir_plan,
                cuda_fir.sm_count(x.device.index))[1]

            def run():
                return cuda_fir.fir_bank(x, k.fir_weight, k.fir_plan, h)

            want = stacked(run())
            counts = range(1, len(k.fir_plan.tables) + 1)
            ms = {p: [] for p in counts}
            for p in (*counts, *reversed(counts)):
                with fir_parts_forced(p):
                    ms[p].append(cuda_ms(run, calls=20, cover_host=True)[0])
            for p in counts:
                with fir_parts_forced(p):
                    same = torch.equal(stacked(run()), want)
                check(same, f"fir_bank {label} {dtype}: {p} parts differ "
                      f"from {chosen}")
            print(f"  fir_bank parts {label} {dtype}: launch_grid chooses "
                  f"{chosen}; " + ", ".join(
                      f"{p} part(s) {a:.4f} / {b:.4f} ms"
                      for p, (a, b) in ms.items())
                  + "; every split bit-identical: True", flush=True)


def fir_mma(rounds: int = 2048) -> None:
    """The shape of F1's double mma: the FP64 tensor cores' rate per f64
    mma shape (cuda_fir.mma_rate: 132 x 8 blocks of 8 warps, each warp
    `rounds` rounds of 4 independent mma.sync on values in registers;
    CUDA events, median of 5) in TFLOP/s.  F1 runs m16n8k8."""
    out = torch.empty(132 * 8 * 256, dtype=torch.float64, device="cuda")
    rates = []
    for shape, (name, fma) in cuda_fir.MMA_SHAPES.items():
        ms, _ = cuda_ms(lambda: cuda_fir.mma_rate(shape, rounds, out),
                        calls=1, rounds=5, warmup=1)
        flops = 2.0 * fma * 4 * rounds * (out.numel() // 32)
        rates.append(f"{name} {flops / ms / 1e9:.1f}")
    print("  fir_mma: FP64 tensor-core rate, TFLOP/s (67 the data sheet's "
          "peak): " + ", ".join(rates) + "; F1 runs m16n8k8", flush=True)


def phase_times(main: dict, batch: dict, stream: dict, pair10,
                reps: int = 30) -> tuple[dict, dict, dict]:
    """Kernel and plain device times (cuda_ms), each kernel at its batch
    shapes (phase 3's batch cases) and at the streams' chunk shapes (its
    stream cases), each beside its bound (F1 also beside the uniform
    conv's, and with its plain version, the cuDNN conv1d, as its library
    call), F1's part counts (fir_parts), F1 at the hour's one shot
    (hour_times), K1 and K2 on long rows
    (long_rows), then peaq() host wall time per 10 s stereo pair: `reps`
    calls per mode and tier, the tiers in turn, each call ending in the
    copy of its results to the host.  Returns the median wall ms per
    (mode, tier), long_rows' readings and hour_times'."""
    print("phase 7 times", flush=True)
    ehs_report()
    for name, by_dtype in main.items():
        for dtype, entry in by_dtype.items():
            entry["ms"], host = cuda_ms(entry.pop("kernel"), calls=20,
                                        cover_host=True)
            entry["plain_ms"], _ = cuda_ms(entry.pop("plain"), calls=1)
            share = entry["bound_ms"] / entry["ms"]
            print(f"  {name} {dtype}: kernel {entry['ms']:.4f} ms (host "
                  f"enqueue {host:.4f} ms), {share:.1%} of its bound "
                  f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}), plain "
                  f"{entry['plain_ms']:.4f} ms (median of 10)"
                  + fir_note(name, entry))
    for dtype, entry in main["recurrence_banded"].items():
        entry["library_ms"] = k1_library(*entry.pop("inputs"),
                                         f"basic {list(MAIN)}")
    for dtype in DTYPES:
        for c in site_cases(dtype, pair10):
            ms, _ = cuda_ms(c.kernel, calls=20, cover_host=True)
            plain_ms, _ = cuda_ms(c.plain, calls=1, rounds=3)
            bound_ms, bound_by = bound(c.name, dtype, c.inputs, c.kernel())
            print(f"  {c.name} {c.case} {dtype}: kernel {ms:.4f} ms, "
                  f"{bound_ms / ms:.1%} of its bound {bound_ms:.5f} ms "
                  f"({bound_by}), plain {plain_ms:.4f} ms (median of 3)"
                  + fir_note(c.name, {}))
            if c.name == "recurrence_banded":
                k1_library(*c.inputs, c.case)
    rates = band_math_rates()
    for dtype, by_op in rates.items():
        print(f"  band math rates {dtype}, G calls/s: " + ", ".join(
            f"{op} {rate / 1e9:.1f}" for op, rate in by_op.items()))
    for dtype, entry in batch.items():
        for c in entry["cases"]:
            if c["name"] == "band_movs":
                site = c["case"].split()[2]
                floor = band_math_floor(site, c["inputs"], dtype, rates)
                print(f"  band_movs {c['case']} {dtype}: math floor "
                      f"{floor:.4f} ms ({M1_CALLS[site]} an element), "
                      f"bytes bound {c['bound_ms']:.4f} ms", flush=True)
    for dtype, entry in batch.items():
        for c in entry["cases"]:
            c["ms"], host = cuda_ms(c.pop("kernel"), calls=5,
                                    cover_host=True)
            c["plain_ms"], _ = cuda_ms(c.pop("plain"), calls=1, rounds=3)
            inputs = c.pop("inputs")
            if c["name"] == "recurrence_banded":
                c["library_ms"] = k1_library(*inputs, c["case"])
            print(f"  {c['name']} {c['case']} {dtype}: kernel "
                  f"{c['ms']:.4f} ms (host enqueue {host:.4f} ms), "
                  f"{c['bound_ms'] / c['ms']:.1%} of its bound "
                  f"{c['bound_ms']:.5f} ms ({c['bound_by']}), plain "
                  f"{c['plain_ms']:.4f} ms (median of 3)" + fir_note(
                      c["name"], c))
    for dtype, cases in stream.items():
        for c in cases:
            c["ms"], host = cuda_ms(c.pop("kernel"), calls=20,
                                    cover_host=True)
            c["plain_ms"], _ = cuda_ms(c.pop("plain"), calls=1, rounds=3)
            # K1's conv1d computes y0 = 0 only: no library call for a
            # carried state; F1's is its plain version
            c["library_ms"] = None
            del c["inputs"]
            print(f"  {c['name']} {c['case']} {dtype}: kernel "
                  f"{c['ms']:.4f} ms (host enqueue {host:.4f} ms), "
                  f"{c['bound_ms'] / c['ms']:.1%} of its bound "
                  f"{c['bound_ms']:.5f} ms ({c['bound_by']}), plain "
                  f"{c['plain_ms']:.4f} ms (median of 3)" + fir_note(
                      c["name"], c))
    GATE_SIGNALS.clear()
    fir_parts(main)
    fir_mma()
    long = long_rows()
    hour = hour_times(pair10)
    medians = {}
    for mode in MODES:
        walls = {tier: [] for tier in TIERS}
        for tier in TIERS:
            peaq_call(pair10, mode, tier)              # warm
        for _ in range(reps):
            for tier in TIERS:
                start = time.perf_counter()
                peaq_call(pair10, mode, tier)
                walls[tier].append((time.perf_counter() - start) * 1e3)
        for tier in TIERS:
            q1, med, q3 = statistics.quantiles(walls[tier], n=4)
            medians[mode, tier] = med
            print(f"  {mode} peaq() 10 s stereo pair, {tier}: median "
                  f"{med:.3f} ms (quartiles {q1:.3f}..{q3:.3f}, {reps} "
                  f"calls), {1e4 / med:.1f}x realtime")
    return medians, long, hour


def phase_profile(pair10, walls: dict, calls: int = 5) -> None:
    """Device time per peaq() call under torch.profiler, per mode and tier:
    the sum of the device's own rows (kernels and copies; the CPU op rows
    repeat the time of the kernels they launch), its share of the
    unprofiled median wall time of phase 7, each hand kernel's part of it,
    and D3's time per launch step."""
    print("phase 8 profile", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for mode in MODES:
        for tier in TIERS:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    peaq_call(pair10, mode, tier)
            events = prof.key_averages()
            device = [e for e in events if e.device_type == DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in device) / 1e3
            # each hand kernel's rows (D1: one per launch, D3: one per
            # launch step)
            by_kernel = {name: sum(e.self_device_time_total for e in device
                                   if re.search(rf"\b{name}(_\w+)?_kernel",
                                                e.key)) / 1e3
                         for name in KERNELS}
            hand_ms = sum(by_kernel.values())
            check(device_ms > 0, "the profiler saw no device time")
            wall = walls[mode, tier]
            print(f"  {mode} {tier}, {calls} calls: device "
                  f"{device_ms / calls:.4f} ms per call ({len(device)} "
                  f"kinds), busy {device_ms / calls / wall:.2%} of the "
                  f"unprofiled median {wall:.3f} ms; hand kernels "
                  f"{hand_ms / calls:.4f} ms per call "
                  f"({hand_ms / device_ms:.2%} of the device time)")
            print("    per call: " + ", ".join(
                f"{name} {ms / calls:.4f} ms ({ms / device_ms:.2%})"
                for name, ms in by_kernel.items() if ms > 0))
            steps = sorted(
                (re.sub(r".*dc_chain_kernel<\w+, *(\d+)>.*", r"\1", e.key),
                 e.self_device_time_total / 1e3 / calls)
                for e in device if "dc_chain_kernel" in e.key)
            if steps:
                print("    dc_chain per step and call: " + ", ".join(
                    f"{step} {ms:.4f} ms" for step, ms in steps))
            slope = sorted((re.sub(r".*slope_state_(\w+)_kernel.*", r"\1",
                                   e.key),
                            e.self_device_time_total / 1e3 / calls)
                           for e in device if "slope_state_" in e.key)
            if slope:
                print("    slope_state per launch and call: " + ", ".join(
                    f"{step} {ms:.4f} ms" for step, ms in slope))
            print(events.table(sort_by="self_device_time_total",
                               row_limit=12))


def deviation(got: dict, want: dict) -> tuple[float, float]:
    """The worst |dODG| and |dMOV| / (1 + |w|) of one peaq_batch() result
    dict against another; a NaN in both counts as agreement, in one alone
    as inf."""
    def dev(g, w, scale):
        both = np.isnan(g) & np.isnan(w)
        d = np.abs(g - w) / (1.0 + scale * np.abs(w))
        return float(np.max(np.where(both, 0.0, np.nan_to_num(d, nan=np.inf))))
    return dev(got["odg"], want["odg"], 0.0), dev(got["movs"], want["movs"],
                                                  1.0)


def mixed_lengths(items: int = 8):
    """Corpus v2 items (10 s stereo) cut to 6..10 s."""
    refs, tests = corpus.realistic_pairs(items, 10.0)
    cut = [int(C.SAMPLING_RATE * (6.0 + 4.0 * i / (items - 1)))
           for i in range(items)]
    return ([r[:n] for r, n in zip(refs, cut)],
            [t[:n] for t, n in zip(tests, cut)])


def batch_profile(pairs, advanced: bool, tier: str, mb: int) -> dict:
    """One peaq_batch() of `pairs` under torch.profiler: device ms (the
    device rows), the FIR bank's (F1's rows), the bin-domain stage's (S1's
    and S2's rows), the gate's (G1's rows), each band epilogue kernel's
    (L1's, L2's and M1's rows), EHS's (E1's rows), the FB masking's (W1's
    rows), the hand kernels' (F1's, S1's, S2's, G1's, L1's, L2's, M1's,
    E1's and W1's included) and the copies to the card's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        PB.peaq_batch(*pairs, advanced=advanced, dtype=tier, microbatch=mb)
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    hand = sum(e.self_device_time_total for e in device
               if re.search(rf"\b({'|'.join(KERNELS)})(_\w+)?_kernel",
                            e.key))
    return {"device_ms": sum(e.self_device_time_total for e in device) / 1e3,
            "fir_ms": sum(e.self_device_time_total for e in device
                          if "fir_bank_kernel" in e.key) / 1e3,
            "spectral_ms": sum(e.self_device_time_total for e in device
                               if re.search(r"\b(pair_frames|spectral_movs)"
                                            r"_kernel", e.key)) / 1e3,
            "gate_ms": sum(e.self_device_time_total for e in device
                           if "frame_gate_kernel" in e.key) / 1e3,
            "ehs_ms": sum(e.self_device_time_total for e in device
                          if "ehs_frames_kernel" in e.key) / 1e3,
            "mask_ms": sum(e.self_device_time_total for e in device
                           if "mask_frames_kernel" in e.key) / 1e3,
            "band_ms": {name: sum(e.self_device_time_total for e in device
                                  if re.search(rf"\b{name}_kernel", e.key))
                        / 1e3 for name in BAND},
            "hand_ms": hand / 1e3,
            "h2d_ms": sum(e.self_device_time_total for e in device
                          if "HtoD" in e.key) / 1e3,
            "copies": [(e.key, e.count, e.self_device_time_total / 1e3)
                       for e in device if "Memcpy" in e.key],
            "table": events.table(sort_by="self_device_time_total",
                                  row_limit=8)}


def copy_ms(pairs, advanced: bool, mb: int) -> tuple[float, int]:
    """The device time (cuda_ms) of one chunk's copy to the card from
    page-locked memory (PB.stage of the first `mb` pairs), and its
    bytes."""
    refs, tests = pairs
    chunk = PB.prepare_chunk(refs[:mb], tests[:mb],
                             PB.compute_buckets(refs, tests, advanced),
                             pin=True)
    ms, _ = cuda_ms(lambda: PB.stage(chunk, "cuda"), calls=3, rounds=3)
    return ms, sum(a.numel() * a.element_size() for a in chunk)


def phase_batch(pairs, card: str) -> dict:
    """parallel/batch.py on the card.  (1) Eight corpus pairs of mixed
    lengths through peaq_batch() in microbatches of 3 (the last padded
    with a duplicate) against per-pair peaq(), per mode and tier: float64
    within BATCH_BAR, float32 and accurate within BATCH_TIER_BAR ODG.  (2)
    Four of them quantized to int16: the int16 ship equal to the float one
    bit for bit.  (3) `pairs`, 64 x 10 s stereo, per mode (basic in
    microbatches of 64, advanced of 32) and tier: tools/bench.py's rate
    (3 repeats of 2 batches, staged before the clock), one timed
    peaq_batch() with its `timings` and peak device memory, and one under
    the profiler.  Returns the readings per (mode, tier)."""
    print("phase 9 batch", flush=True)
    refs, tests = mixed_lengths()
    for mode in MODES:
        advanced = mode == "advanced"
        for tier in TIERS:
            got = PB.peaq_batch(refs, tests, advanced=advanced, dtype=tier,
                                microbatch=3)
            singles = [api.peaq(r, t, advanced=advanced, dtype=tier)
                       for r, t in zip(refs, tests)]
            names = C.MOV_ADVANCED_NAMES if advanced else C.MOV_BASIC_NAMES
            want = {"odg": np.array([x.odg for x in singles]),
                    "movs": np.array([[x.movs[n] for n in names]
                                      for x in singles])}
            odg, mov = deviation(got, want)
            print(f"  {mode} {tier}, 8 pairs of 6-10 s in microbatches of "
                  f"3: ODGs {np.nanmin(got['odg']):.4f}.."
                  f"{np.nanmax(got['odg']):.4f}; against per-pair peaq(): "
                  f"|dODG| {odg:.3e}, MOVs |d|/(1 + |w|) {mov:.3e}",
                  flush=True)
            if tier == "float64":
                check(odg <= BATCH_BAR and mov <= BATCH_BAR,
                      f"{mode} float64 batch against per pair: {odg}, {mov}")
            else:
                check(odg <= BATCH_TIER_BAR,
                      f"{mode} {tier} batch against per pair: {odg}")
        as_int16 = [PB.to_pcm16(x) for x in (*refs[:4], *tests[:4])]
        as_float = [np.float32(x / 32768.0) for x in as_int16]
        out_f = PB.peaq_batch(as_float[:4], as_float[4:], advanced=advanced)
        out_i = PB.peaq_batch(as_int16[:4], as_int16[4:], advanced=advanced)
        same = all(np.array_equal(out_i[k], out_f[k], equal_nan=True)
                   for k in ("odg", "di", "movs"))
        print(f"  {mode} float64, 4 pairs: int16 ship equal to float: "
              f"{same}", flush=True)
        check(same, f"{mode}: the int16 ship differs from the float one")
    readings = {}
    audio = sum(r.shape[0] for r in pairs[0]) / C.SAMPLING_RATE
    for mode in MODES:
        advanced, mb = mode == "advanced", MICROBATCH[mode]
        ms, nbytes = copy_ms(pairs, advanced, mb)
        print(f"  {mode}: one chunk of {mb} pairs to the card from "
              f"page-locked memory: {ms:.3f} ms for {nbytes / 1e6:.1f} MB "
              f"({nbytes / ms / 1e6:.1f} GB/s), {len(pairs[0]) // mb} "
              f"chunk(s) a batch", flush=True)
        for tier in TIERS:
            rates = TB.bench(advanced, dtype=tier, microbatch=mb, iters=2,
                             repeats=3, pairs=pairs)
            timings = {}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            out = PB.peaq_batch(*pairs, advanced=advanced, dtype=tier,
                                microbatch=mb, timings=timings)
            wall = time.perf_counter() - start
            peak = torch.cuda.max_memory_allocated()
            check(np.isfinite(out["odg"]).all(),
                  f"{mode} {tier} batch of {len(out['odg'])}: ODG not finite")
            prof = batch_profile(pairs, advanced, tier, mb)
            dev = prof["device_ms"]
            check(dev > 0, "the profiler saw no device time")
            readings[mode, tier] = dict(rates=rates, wall=wall, peak=peak,
                                        **prof)
            print(f"  {mode} {tier}, {len(out['odg'])} pairs, {audio:.0f} "
                  f"audio-s, microbatch {mb} ({card}): "
                  f"{statistics.median(rates):.1f} audio-s/s (min "
                  f"{min(rates):.1f}, max {max(rates):.1f}, 3 repeats of 2 "
                  f"batches, staged); peaq_batch() {wall * 1e3:.1f} ms = "
                  f"{audio / wall:.1f} audio-s/s, timings "
                  + ", ".join(f"{k} {v * 1e3:.1f} ms"
                              for k, v in timings.items())
                  + f"; peak memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f}"
                  f" GiB before)", flush=True)
            staged_ms = audio / statistics.median(rates) * 1e3
            band = prof["band_ms"]
            band_ms = sum(band.values())
            other = (prof["hand_ms"] - prof["fir_ms"] - prof["spectral_ms"]
                     - prof["gate_ms"] - band_ms - prof["ehs_ms"]
                     - prof["mask_ms"])
            print(f"    profiled peaq_batch(): device {dev:.1f} ms, busy "
                  f"{dev / (wall * 1e3):.1%} of the unprofiled call and, "
                  f"without the copies to the card, "
                  f"{(dev - prof['h2d_ms']) / staged_ms:.1%} of a staged "
                  f"batch ({staged_ms:.1f} ms); FIR "
                  f"bank (F1) {prof['fir_ms']:.1f} ms "
                  f"({prof['fir_ms'] / dev:.1%}), the bin-domain stage (S1, "
                  f"S2) {prof['spectral_ms']:.2f} ms "
                  f"({prof['spectral_ms'] / dev:.1%}), the gate (G1) "
                  f"{prof['gate_ms']:.3f} ms ({prof['gate_ms'] / dev:.1%}), "
                  f"the band epilogues (L1, L2, M1) {band_ms:.3f} ms "
                  f"({band_ms / dev:.1%}: "
                  + ", ".join(f"{name} {ms:.3f} ms ({ms / dev:.1%})"
                              for name, ms in band.items())
                  + f"), EHS (E1) {prof['ehs_ms']:.3f} ms "
                  f"({prof['ehs_ms'] / dev:.1%}), the FB masking (W1) "
                  f"{prof['mask_ms']:.3f} ms ({prof['mask_ms'] / dev:.1%}), "
                  f"the other hand "
                  f"kernels {other:.1f} ms ({other / dev:.1%}), the "
                  f"profiler's rows of "
                  f"copies to the card {prof['h2d_ms']:.1f} ms "
                  f"({prof['h2d_ms'] / dev:.1%}); copy rows "
                  f"{prof['copies']}", flush=True)
            print(prof["table"])
    epilogue_sites(pairs)
    sample_passes(readings)
    return readings


def epilogue_sites(pairs) -> None:
    """The device time of one staged basic float64 and advanced float64
    batch of `pairs` split by site (tools/epilogue_sites.py): each eager
    function the pipelines call in a record_function range (the FFT ear's
    front and smear, EHS's E1 call and its gate, the band epilogue's
    sites, the accumulators, the gates, the cognitive model, the FB ear's
    casts and masking) with the device ms of the PyTorch kernels inside
    it, the device ms outside every range and hand kernel with the
    top-level operations that launched it, and L1's, L2's, M1's, K1's,
    E1's and W1's device ms by kernel name beside the batch's."""
    for config, got in ES.profile_sites(
            (("basic", "float64", MICROBATCH["basic"]),
             ("advanced", "float64", MICROBATCH["advanced"])),
            pairs).items():
        dev = got["device_ms"]
        hand = got["hand_kernels_ms"]
        check(dev > 0, "the profiler saw no device time")
        check(hand.get("ehs_frames", 0.0) > 0, f"{config}: no E1 time")
        check(config.startswith("basic")
              or hand.get("mask_frames", 0.0) > 0, f"{config}: no W1 time")
        band = sum(hand.get(name, 0.0) for name in BAND)
        print(f"  sites, {config}: device {dev:.3f} ms, "
              f"{got['device_ops']} device ops; ranges (eager kernels "
              "inside): " + ", ".join(
                  f"{name} {s['calls']} calls {s['device_ms']:.3f} ms "
                  f"{s['kernels']} kernels"
                  for name, s in sorted(got["sites"].items(),
                                        key=lambda kv: -kv[1]["device_ms"]))
              + f"; outside every range and hand kernel "
              f"{got['outside_ms']:.3f} ms (" + ", ".join(
                  f"{op} {ms:.3f} ms" for op, ms in got["outside_ops"].items())
              + f"); L1 + L2 + M1 {band:.3f} ms ({band / dev:.1%}: "
              + ", ".join(f"{name} {hand.get(name, 0.0):.3f} ms"
                          for name in (*BAND, "recurrence_banded",
                                       "ehs_frames", "mask_frames"))
              + ")", flush=True)


def eager_energy_totals(ref_blocks, test_blocks, dtype):
    """The totalsnr sums per pair as the basic path took them before S1
    gave their halves: the hop blocks [B, CH, F + 1, 1024] cast to dtype,
    the first hop block of each frame of ref and of ref - test squared and
    summed."""
    rhalf = ref_blocks[..., :-1, :].to(dtype)
    nhalf = rhalf - test_blocks[..., :-1, :].to(dtype)
    return (torch.sum(rhalf ** 2, dim=(1, 2, 3)),
            torch.sum(nhalf ** 2, dim=(1, 2, 3)))


def sample_passes(readings: dict) -> None:
    """The basic path's work over the whole signal outside S1, at the
    basic float64 batch's shape (64 pairs of 10 s stereo in their bucket,
    [64, 2, 525312] samples), fed float32 samples (as peaq_batch ships
    them) and float64: G1 (the gate) on the reference and the energy
    totals summed from S1's halves (basic.energy_totals), beside the eager
    passes they replaced, the plain gate on the reference cast to float64
    (framing.above_threshold_signal) and eager_energy_totals on the hop
    blocks; each on random samples (cuda_ms, 10 calls a round), with the
    bytes bound of its input read once, G1's bits equal to the plain
    gate's and the totals within BARS of the eager ones; and each side's
    sum as a share of the profiled device time of one basic float64
    batch (readings)."""
    n_frames = batch_shapes()["basic"][-1]
    t = (n_frames + 1) * C.FFT_STEPSIZE
    dev = readings["basic", "float64"]["device_ms"]
    hann = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT),
                           torch.float64, "cuda").hann
    f64 = torch.float64
    gen = torch.Generator(device="cuda").manual_seed(61)
    for ship in DTYPES:
        ref, test = (torch.randn((MICROBATCH["basic"], 2, t), generator=gen,
                                 device="cuda", dtype=ship) * 0.1
                     for _ in range(2))
        blocks = [framing.blocks_hop(x, n_frames) for x in (ref, test)]
        halves = cuda_spectral.pair_frames(*blocks, hann)[2]
        gate = cuda_gate.frame_gate(ref, n_frames, C.FFT_FRAMESIZE,
                                    C.FFT_STEPSIZE, f64)
        want = framing.above_threshold_signal(
            ref.to(f64), n_frames, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
        got = torch.stack(basic.energy_totals(halves, None))
        eager = torch.stack(eager_energy_totals(*blocks, f64))
        err = ((got - eager).abs().max() / eager.abs().max()).item()
        print(f"  {str(ship)[6:]} samples: G1's bits equal the plain "
              f"gate's: {torch.equal(gate, want)}; energy totals from the "
              f"halves against the eager sums: max|d|/max|ref| {err:.3e}",
              flush=True)
        check(torch.equal(gate, want), f"G1 at the batch shape, {ship}")
        check(err < BARS[f64], f"energy totals from the halves: {err}")
        runs = {"eager": {
                    "plain gate": (lambda: framing.above_threshold_signal(
                        ref.to(f64), n_frames, C.FFT_FRAMESIZE,
                        C.FFT_STEPSIZE), (ref,)),
                    "eager_energy_totals": (lambda: eager_energy_totals(
                        *blocks, f64), (ref, test))},
                "now": {
                    "G1": (lambda: cuda_gate.frame_gate(
                        ref, n_frames, C.FFT_FRAMESIZE, C.FFT_STEPSIZE,
                        f64), (ref,)),
                    "energy_totals from halves": (lambda: basic.energy_totals(
                        halves, None), (halves,))}}
        for side, fns in runs.items():
            total = 0.0
            parts = []
            for name, (fn, inputs) in fns.items():
                ms, _ = cuda_ms(fn, calls=10)
                total += ms
                bound_ms = (sum(x.numel() * x.element_size() for x in inputs)
                            / MEMORY_BYTES_PER_S * 1e3)
                parts.append(f"{name} {ms:.4f} ms ({bound_ms / ms:.1%} of "
                             f"reading its input once, {bound_ms:.4f} ms)")
            print(f"  basic float64 passes outside S1 at "
                  f"[{MICROBATCH['basic']}, 2, {t}], {str(ship)[6:]} "
                  f"samples, {side}: " + ", ".join(parts) + f"; together "
                  f"{total:.3f} ms, {total / dev:.1%} of the profiled "
                  f"batch's {dev:.1f} ms of device time", flush=True)
        del ref, test, blocks, halves


def stream_program() -> tuple[np.ndarray, np.ndarray]:
    """A 10-minute stereo program, [T, 2] ref and test: drift corpus v2's
    20 items of 10 s (phase 5c's) three times over, each pass its own
    audio: the items in order, then each item reversed in time, then the
    items in reverse order with the channels swapped at 0.7 of the level.
    So it carries 60 distinct 10 s pairs, with the corpus's quiet tail,
    true-stereo and DC items among them."""
    refs, tests = corpus_v2()
    passes = [list(zip(refs, tests)),
              [(r[::-1], t[::-1]) for r, t in zip(refs, tests)],
              [(0.7 * r[:, ::-1], 0.7 * t[:, ::-1])
               for r, t in zip(refs[::-1], tests[::-1])]]
    pairs = [pair for one in passes for pair in one]
    return tuple(np.ascontiguousarray(np.concatenate(x), dtype=np.float32)
                 for x in zip(*pairs))


def stream_deviation(got, want) -> tuple[float, float, float]:
    """|dODG|, |dDI| and the worst |dMOV| / (1 + |w|) of one result
    against another (NaN in both agrees, in one alone is inf)."""
    def dev(g, w, scale=0.0):
        if np.isnan(g) or np.isnan(w):
            return 0.0 if np.isnan(g) and np.isnan(w) else math.inf
        return abs(g - w) / (1.0 + scale * abs(w))
    return (dev(got.odg, want.odg), dev(got.di, want.di),
            max(dev(got.movs[n], w, 1.0) for n, w in want.movs.items()))


def same_result(got, want) -> bool:
    """ODG, DI and every MOV equal bit for bit (NaN equal to NaN)."""
    def vec(r):
        return np.array([r.odg, r.di, *r.movs.values()])
    return (list(got.movs) == list(want.movs)
            and np.array_equal(vec(got), vec(want), equal_nan=True))


def stream_run(cls, tier: str, ref, test, checkpoint_dir=None) -> dict:
    """One stream of `cls` in `tier` over the whole program, fed in 1 s
    pieces, the launch counts set to 0 just before and read just after:
    its result, wall seconds (current() and the checkpoint left out), peak
    memory over minute 1 and over minute 10, current() after minute 1, the
    launch counts, and with checkpoint_dir a checkpoint after minute 5
    (utils/checkpoint.py's npz there, and the pending host samples)."""
    sr = C.SAMPLING_RATE
    seconds = ref.shape[0] // sr
    stream = cls(chunk_frames=STREAM_CHUNK, dtype=tier)
    out, aside = {}, 0.0
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    for i in range(seconds):
        if i in (0, seconds - 60, 60, seconds // 2):
            pause = time.perf_counter()
            torch.cuda.synchronize()
            if i == 60:
                out["peak_minute_1"] = torch.cuda.max_memory_allocated()
                out["minute_1"] = stream.current()
            if i in (0, seconds - 60):
                torch.cuda.reset_peak_memory_stats()
            if i == seconds // 2 and checkpoint_dir is not None:
                CK.save_state(str(checkpoint_dir / "stream"), stream.state)
                out["pending"] = [[b.copy() for b in bufs]
                                  for bufs in stream.pending]
            aside += time.perf_counter() - pause
        stream.feed(ref[i * sr:(i + 1) * sr], test[i * sr:(i + 1) * sr])
    torch.cuda.synchronize()
    out["peak_minute_10"] = torch.cuda.max_memory_allocated()
    out["result"] = stream.finalize()
    out["wall"] = time.perf_counter() - start - aside
    out["launches"] = read_counts()
    return out


def stream_launches(n_samples: int, advanced: bool,
                    chunk: int = STREAM_CHUNK) -> dict:
    """Each kernel's launches over a stream (or a pool) of n_samples per
    signal in chunks of `chunk` FFT frames: each path runs
    ceil(frames / chunk frames) steps (the full chunks, then the flush of
    the rest), each as STREAM_STEP_LAUNCHES counts."""
    paths = {"basic": (C.FFT_FRAMESIZE, C.FFT_STEPSIZE, chunk)}
    if advanced:
        paths = {"advanced_fft": paths["basic"],
                 "advanced_fb": (C.FB_FRAMESIZE, C.FB_FRAMESIZE,
                                 16 * chunk)}
    out = dict.fromkeys(KERNELS, 0)
    for path, (frame, hop, chunk) in paths.items():
        steps = -(-framing.num_frames(n_samples, n_samples, frame, hop)
                  // chunk)
        for name in KERNELS:
            out[name] += steps * STREAM_STEP_LAUNCHES[path][name]
    return out


def step_walls(cls, ref, test, seconds: int = 30) -> tuple[float, float]:
    """The median wall of one chunk step (the card synchronized after
    each) over `seconds` of the program fed in 1 s pieces, and the device's
    busy share over the next `seconds` (profiled device time over the
    unprofiled wall of the same feeds, the second time round), float64."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sr = C.SAMPLING_RATE
    stream = cls(chunk_frames=STREAM_CHUNK, dtype="float64")
    walls = []
    step = stream._step

    def timed_step(*args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)

    stream._step = timed_step
    for i in range(seconds):
        stream.feed(ref[i * sr:(i + 1) * sr], test[i * sr:(i + 1) * sr])
    stream._step = step
    pieces = [(ref[i * sr:(i + 1) * sr], test[i * sr:(i + 1) * sr])
              for i in range(seconds, 2 * seconds)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r, t in pieces:
            stream.feed(r, t)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    again = cls(chunk_frames=STREAM_CHUNK, dtype="float64")
    for i in range(seconds):
        again.feed(ref[i * sr:(i + 1) * sr], test[i * sr:(i + 1) * sr])
    torch.cuda.synchronize()
    start = time.perf_counter()
    for r, t in pieces:
        again.feed(r, t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    return statistics.median(walls), device_ms / wall_ms


def phase_streams(card: str) -> dict:
    """parallel/stream.py on the card (see the module's docstring, phase
    10).  Returns each mode's float64 launch counts."""
    print("phase 10 streams", flush=True)
    ref, test = stream_program()
    audio = ref.shape[0] / C.SAMPLING_RATE
    launches = {}
    for mode in MODES:
        advanced = mode == "advanced"
        cls = PS.PeaqStreamAdvanced if advanced else PS.PeaqStream
        for tier in TIERS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            want = api.peaq(ref, test, advanced=advanced, dtype=tier)
            one_wall = time.perf_counter() - start
            one_peak = torch.cuda.max_memory_allocated()
            with tempfile.TemporaryDirectory() as tmp:
                keep = pathlib.Path(tmp) if tier == "float64" else None
                run = stream_run(cls, tier, ref, test, keep)
                got = run["result"]
                d_odg, d_di, d_mov = stream_deviation(got, want)
                peaks = run["peak_minute_1"], run["peak_minute_10"]
                spread = abs(peaks[1] - peaks[0]) / max(peaks)
                print(f"  {mode} {tier}, {audio:.0f} s stereo program in 1 s "
                      f"pieces, chunk_frames {STREAM_CHUNK} ({card}): ODG "
                      f"{got.odg:.9f}, one-shot {want.odg:.9f}; |dODG| "
                      f"{d_odg:.3e}, |dDI| {d_di:.3e}, MOVs |d|/(1 + |w|) "
                      f"{d_mov:.3e}; stream {run['wall']:.2f} s = "
                      f"{audio / run['wall']:.1f} audio-s/s, one-shot "
                      f"{one_wall:.2f} s; peak memory minute 1 "
                      f"{peaks[0] / 2**20:.1f} MiB, minute 10 "
                      f"{peaks[1] / 2**20:.1f} MiB ({spread:.2%} apart), "
                      f"one-shot {one_peak / 2**20:.1f} MiB; current() "
                      f"after minute 1: ODG {run['minute_1'].odg:.6f}; "
                      f"launches {run['launches']}", flush=True)
                check(np.isfinite(run["minute_1"].odg)
                      and np.isfinite(got.odg),
                      f"{mode} {tier} stream: ODG not finite")
                if tier == "float64":
                    check(d_odg <= STREAM_BAR and d_di <= STREAM_BAR
                          and d_mov <= STREAM_MOV_BAR,
                          f"{mode} float64 stream against one shot: "
                          f"{d_odg}, {d_di}, {d_mov}")
                else:
                    check(d_odg <= STREAM_TIER_BAR,
                          f"{mode} {tier} stream against one shot: {d_odg}")
                check(spread < 0.05, f"{mode} {tier} stream memory grows: "
                      f"{peaks}")
                expected = stream_launches(ref.shape[0], advanced)
                check(run["launches"] == expected,
                      f"{mode} {tier} stream: launches {run['launches']}, "
                      f"expected {expected}")
                if tier == "float64":
                    launches[mode] = run["launches"]
                    resumed = cls(chunk_frames=STREAM_CHUNK, dtype=tier)
                    resumed.state = CK.load_state(str(keep / "stream"),
                                                  resumed.state)
                    resumed.pending = run["pending"]
                    sr = C.SAMPLING_RATE
                    for i in range(ref.shape[0] // sr // 2,
                                   ref.shape[0] // sr):
                        resumed.feed(ref[i * sr:(i + 1) * sr],
                                     test[i * sr:(i + 1) * sr])
                    same = same_result(resumed.finalize(), got)
                    print(f"  {mode} float64: checkpoint after minute 5 "
                          f"(npz) resumed in a fresh stream: bit for bit "
                          f"{same}", flush=True)
                    check(same, f"{mode}: the resumed stream differs")
        step_ms, busy = step_walls(cls, ref, test)
        print(f"  {mode} float64 ({card}): median wall of a chunk step "
              f"{step_ms * 1e3:.3f} ms (synchronized), device busy "
              f"{busy:.1%} of 30 s of feeds", flush=True)
        pool_run(mode, ref, test, card)
    return launches


def pool_run(mode: str, ref, test, card: str) -> None:
    """PeaqStreamPool of POOL stereo streams of 60 s (program windows 36 s
    apart) in float64, fed in lockstep 1 s pieces, against peaq_batch() of
    the same pairs within POOL_BAR (ODG; MOVs times 1 + |w|)."""
    sr = C.SAMPLING_RATE
    starts = [36 * sr * i for i in range(POOL)]
    refs = np.stack([ref[s:s + 60 * sr] for s in starts])
    tests = np.stack([test[s:s + 60 * sr] for s in starts])
    advanced = mode == "advanced"
    pool = PS.PeaqStreamPool(POOL, chunk_frames=STREAM_CHUNK,
                             dtype="float64", advanced=advanced)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for i in range(60):
        pool.feed(refs[:, i * sr:(i + 1) * sr], tests[:, i * sr:(i + 1) * sr])
    got = pool.finalize()
    wall = time.perf_counter() - start
    want = PB.peaq_batch(list(refs), list(tests), advanced=advanced,
                         dtype="float64")
    names = C.MOV_ADVANCED_NAMES if advanced else C.MOV_BASIC_NAMES
    odg, mov = deviation(
        {"odg": got.odg, "movs": np.stack([got.movs[n] for n in names], 1)},
        want)
    print(f"  {mode} float64 pool of {POOL} stereo streams x 60 s in "
          f"lockstep 1 s pieces ({card}): {POOL * 60 / wall:.1f} audio-s/s "
          f"({wall:.2f} s); against peaq_batch() of the same pairs: |dODG| "
          f"{odg:.3e}, MOVs |d|/(1 + |w|) {mov:.3e}", flush=True)
    check(odg <= POOL_BAR and mov <= POOL_BAR,
          f"{mode} pool against peaq_batch: {odg}, {mov}")


# the CLI's printed lines (src/peaq.c:217-220, src/gstpeaq.c:493-497)
CLI_LINES = re.compile(r"Objective Difference Grade: -?\d+\.\d{3}\n"
                       r"Distortion Index: -?\d+\.\d{3}\n"
                       r"(Total SNR: -?\d+\.\d{3} dB\n)?$")
# phase 12: peaq_sharded() against peaq_batch() on the same pairs (float64:
# ODG and MOV x (1 + |w|); float32: ODG); the training losses on the card
# against the CPU's, relative, per step; the two-part pool against the
# pool on one device (ODG and MOV x (1 + |w|), and each checkpoint leaf
# within SHARD_BAR of its largest value)
SHARD_BAR = 1e-12
SHARD_F32_BAR = 1e-4
TRAIN_BAR = 1e-12
TRAIN_EXAMPLES = 4096
TRAIN_STEPS = 10
POOL_SECONDS = 20


def run_module(root: pathlib.Path, *args: str) -> tuple[str, float]:
    """`python -m gstpeaq_tpu_torch *args` from `root` with no
    GSTPEAQ_PLATFORM (so on the card): (stdout, wall seconds from the
    process's start to its exit).  Fails on a non-zero exit."""
    env = {k: v for k, v in os.environ.items() if k != "GSTPEAQ_PLATFORM"}
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gstpeaq_tpu_torch", *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - start
    check(proc.returncode == 0, f"python -m gstpeaq_tpu_torch {args}: exit "
          f"{proc.returncode}\n{proc.stderr[-2000:]}")
    return proc.stdout, wall


def fresh_copy(dest: pathlib.Path) -> pathlib.Path:
    """The package and native/ copied under dest without the built kernels,
    so that the first CLI run there builds them (a cold start)."""
    here = pathlib.Path(__file__).resolve().parent
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    shutil.copytree(here / "gstpeaq_tpu_torch", dest / "gstpeaq_tpu_torch",
                    ignore=ignore)
    shutil.copytree(here / "native", dest / "native", ignore=ignore)
    return dest


def odg_of(stdout: str) -> float:
    return float(re.search(r"Objective Difference Grade: (\S+)",
                           stdout)[1])


def median_s(fn, calls: int = 5) -> float:
    walls = []
    for _ in range(calls):
        start = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - start)
    return statistics.median(walls)


def fake_conformance_items(directory: pathlib.Path, items) -> None:
    """A synthetic dataset under ITU item names (the real one is
    proprietary): 0.6 s mono refs of three tones and a dither floor, so
    that every MOV gate opens, and noisy tests."""
    n = C.SAMPLING_RATE * 3 // 5
    rng = np.random.default_rng(0)
    t = np.arange(n) / C.SAMPLING_RATE
    for i, item in enumerate(items):
        ref = (0.3 * np.sin(2 * np.pi * (440 + 100 * i) * t)
               + 0.1 * np.sin(2 * np.pi * 3500.0 * t)
               + 0.03 * np.sin(2 * np.pi * 9200.0 * t)
               + 2e-5 * rng.standard_normal(n))
        test = ref + 0.01 * rng.standard_normal(n)
        wavio.write_wav(str(directory / (item.replace("cod", "ref")
                                         + ".wav")),
                        ref.astype(np.float32)[:, None])
        wavio.write_wav(str(directory / (item + ".wav")),
                        test.astype(np.float32)[:, None])


def phase_cli(pair10, card: str) -> dict:
    """The CLI, the conformance harness and WAV reading on the card.
    (1) cli.main() in-process on WAVs the port's wavio wrote, each call
    with the counts set to 0 just before and read just after: the pinned
    float64 ODGs (sine/sine 0.171, saw/triangle -2.007) and an advanced
    call, each launching what one peaq() of its mode launches.  (2) `python
    -m gstpeaq_tpu_torch` as a subprocess on the 10 s stereo pair per mode,
    cold (a fresh copy of the package: the kernels build first) and warm,
    wall from the process's start to its exit; sine/sine (0.171) and
    saw/triangle with --precision accurate --totalsnr (within 1e-3 of
    -2.007, and the SNR line); every output in the CLI's line format.  (3)
    conformance.run() on a synthetic two-item dataset per mode, and
    conformance.main() without the dataset, which exits 77.  (4)
    native.available(), and the read and resample time of a 10 s stereo
    44.1 kHz WAV, native against wavio.  Returns the in-process calls'
    launch counts per mode."""
    print("phase 11 CLI, conformance, WAV I/O", flush=True)
    counts = {}
    n = 128 * 1024
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        wav = {}
        for name, x in (("sine", TS.sine(n)), ("saw", TS.saw(n)),
                        ("tri", TS.triangle(n)), ("ref10", pair10[0]),
                        ("test10", pair10[1])):
            wav[name] = str(tmp / f"{name}.wav")
            wavio.write_wav(wav[name], x)
        for mode, args, pinned in (
                ("basic", [wav["sine"], wav["sine"]], "0.171"),
                ("basic", [wav["saw"], wav["tri"]], "-2.007"),
                ("advanced", ["--advanced", wav["saw"], wav["tri"]], None)):
            out = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(out):
                rc = cli.main(args)
            got = read_counts()
            text = out.getvalue()
            print(f"  cli.main({' '.join(pathlib.Path(a).name for a in args)})"
                  f": exit {rc}, {text.splitlines()[0]}; launches {got}",
                  flush=True)
            check(rc == 0 and CLI_LINES.match(text) is not None,
                  f"cli.main {args}: exit {rc}, output {text!r}")
            check(pinned is None or text.splitlines()[0].endswith(pinned),
                  f"cli.main {args}: {text!r}, pinned ODG {pinned}")
            check(got == PATH_LAUNCHES[mode], f"cli.main {args}: launches "
                  f"{got}, expected {PATH_LAUNCHES[mode]}")
            counts[mode] = got
        cold = fresh_copy(tmp / "cold")
        for mode in MODES:
            flags = ["--advanced"] * (mode == "advanced")
            root = cold if mode == "basic" else fresh_copy(tmp / "cold2")
            walls = []
            for _ in range(2):
                stdout, wall = run_module(root, *flags, wav["ref10"],
                                          wav["test10"])
                check(CLI_LINES.match(stdout) is not None,
                      f"python -m gstpeaq_tpu_torch {mode}: {stdout!r}")
                walls.append(wall)
            print(f"  python -m gstpeaq_tpu_torch {mode} on the 10 s stereo "
                  f"WAV pair ({card}): cold (kernels built first) "
                  f"{walls[0]:.2f} s, warm {walls[1]:.2f} s, process start "
                  f"to exit; ODG {odg_of(stdout):.3f}", flush=True)
        # two untimed runs side by side, to keep the phase short
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            pinned = pool.submit(run_module, cold, wav["sine"], wav["sine"])
            accurate = pool.submit(run_module, cold, "--precision",
                                   "accurate", "--totalsnr", wav["saw"],
                                   wav["tri"])
            (stdout, wall), (stdout2, wall2) = (pinned.result(),
                                                accurate.result())
        check(CLI_LINES.match(stdout) is not None
              and odg_of(stdout) == 0.171,
              f"python -m gstpeaq_tpu_torch sine sine: {stdout!r}")
        print(f"  python -m gstpeaq_tpu_torch sine sine: "
              f"{' / '.join(stdout.splitlines())} ({wall:.2f} s)",
              flush=True)
        check(CLI_LINES.match(stdout2) is not None
              and "Total SNR: " in stdout2
              and abs(odg_of(stdout2) + 2.007) <= CONFORMANCE_BAR + 5e-4,
              f"python -m gstpeaq_tpu_torch --precision accurate "
              f"--totalsnr: {stdout2!r}")
        print(f"  python -m gstpeaq_tpu_torch --precision accurate "
              f"--totalsnr saw tri: {' / '.join(stdout2.splitlines())} "
              f"({wall2:.2f} s, beside the run above)", flush=True)
        items = ["acodsna", "bcodtri"]
        data = tmp / "conformance"
        data.mkdir()
        fake_conformance_items(data, items)
        for mode in MODES:
            name = ("CONFORMANCE_ADVANCED" if mode == "advanced"
                    else "CONFORMANCE_BASIC")
            table = getattr(conformance, name)
            setattr(conformance, name, {k: table[k] for k in items})
            try:
                rows = conformance.run(mode == "advanced",
                                       directory=str(data))
            finally:
                setattr(conformance, name, table)
            check([r.item for r in rows] == items
                  and all(np.isfinite(r.di) and np.isfinite(r.odg)
                          for r in rows),
                  f"conformance.run {mode}: {rows}")
            print(f"  conformance.run({mode}) on a synthetic two-item "
                  f"dataset: " + ", ".join(f"{r.item} DI {r.di:.4f} ODG "
                                           f"{r.odg:.4f}" for r in rows),
                  flush=True)
        saved = os.environ.pop("CONFORMANCEDATADIR", None)
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                code = conformance.main([])
        finally:
            if saved is not None:
                os.environ["CONFORMANCEDATADIR"] = saved
        print(f"  conformance.main() without the dataset: exit {code} "
              f"({out.getvalue().strip()})", flush=True)
        check(code == 77, f"conformance.main() without the dataset: {code}")
        sr44 = 44100
        t = np.arange(10 * sr44) / sr44
        x44 = np.stack([np.sin(2 * np.pi * 997.0 * t),
                        0.5 * np.sin(2 * np.pi * 3001.0 * t)],
                       1).astype(np.float32)
        wavio.write_wav(str(tmp / "t44.wav"), x44, sr44)
        path = str(tmp / "t44.wav")
        reads = {"native": median_s(lambda: native.read_wav(path)),
                 "wavio": median_s(lambda: wavio.read_wav(path))}
        loads = {"native": median_s(lambda: native.load_audio_48k(path)),
                 "wavio": median_s(lambda: wavio.load_audio_48k(path))}
        print(f"  native.available(): {native.available()}; a 10 s stereo "
              f"44.1 kHz float WAV, read / read and resample to 48 kHz, "
              f"median of 5: native {reads['native'] * 1e3:.2f} / "
              f"{loads['native'] * 1e3:.2f} ms, wavio "
              f"{reads['wavio'] * 1e3:.2f} / {loads['wavio'] * 1e3:.2f} ms",
              flush=True)
    return counts


def pool_pair(pools, ref, test, seconds: int) -> None:
    """Feed every pool the same [N, T, 2] program windows in 1 s pieces."""
    sr = C.SAMPLING_RATE
    n = pools[0]._n
    starts = [30 * sr * i for i in range(n)]
    refs = np.stack([ref[s:s + seconds * sr] for s in starts])
    tests = np.stack([test[s:s + seconds * sr] for s in starts])
    for i in range(seconds):
        for pool in pools:
            pool.feed(refs[:, i * sr:(i + 1) * sr],
                      tests[:, i * sr:(i + 1) * sr])


def leaf_dev(got, want) -> float:
    """A checkpoint leaf's worst |d| over its largest |w|; NaN where the
    other has none is inf."""
    if want.dtype.kind != "f":
        return 0.0 if np.array_equal(got, want) else math.inf
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        return math.inf
    scale = np.abs(want[~nan]).max(initial=0.0)
    d = np.abs(got[~nan] - want[~nan]).max(initial=0.0)
    return 0.0 if d == 0 else d / scale


def phase_shard(pairs, card: str) -> dict:
    """parallel/shard.py and the multi-device pool on the card.  (1)
    peaq_sharded() over default_devices() against peaq_batch() on 8
    corpus pairs of 6-10 s per mode: float64 within SHARD_BAR (counted
    from 0: the mode's kernels), float32 within SHARD_F32_BAR ODG; then
    both on bench.py's 64 x 10 s stereo pairs per mode in float64 (the
    microbatch of phase 9), audio-s/s of the median of 3 calls each.  (2)
    train_cognitive_sharded() of TRAIN_EXAMPLES MOV vectors per mode on the
    card against the same on the CPU: every step's loss within TRAIN_BAR
    relative, the loss falling; a step's wall.  (3) PeaqStreamPool of 4
    stereo streams x POOL_SECONDS over ["cuda:0", "cuda:0"] (two parts of 2)
    against the pool on one device, float64: current() within SHARD_BAR,
    and the checkpoints leaf for leaf.  Returns the float64 sharded calls'
    launch counts per mode."""
    print("phase 12 sharding, training, multi-device pool", flush=True)
    devices = shard.default_devices()
    print(f"  default_devices(): {[str(d) for d in devices]}", flush=True)
    counts = {}
    refs, tests = mixed_lengths()
    for mode in MODES:
        advanced = mode == "advanced"
        for tier in ("float64", "float32"):
            want = PB.peaq_batch(refs, tests, advanced=advanced, dtype=tier)
            reset_counts()
            got = shard.peaq_sharded(refs, tests, advanced=advanced,
                                     dtype=tier)
            launched = read_counts()
            odg, mov = deviation(got, want)
            print(f"  {mode} {tier} peaq_sharded() of {len(refs)} pairs of "
                  f"6-10 s "
                  f"over {len(devices)} device(s) against peaq_batch(): "
                  f"|dODG| {odg:.3e}, MOVs |d|/(1 + |w|) {mov:.3e}; "
                  f"launches {launched}", flush=True)
            check(np.isfinite(got["odg"]).all(),
                  f"{mode} {tier} sharded ODG is not finite")
            if tier == "float64":
                check(odg <= SHARD_BAR and mov <= SHARD_BAR,
                      f"{mode} sharded against batch: {odg}, {mov}")
                check(all((launched[k] > 0) == (v > 0)
                          for k, v in PATH_LAUNCHES[mode].items()),
                      f"{mode} sharded launches {launched}")
                counts[mode] = launched
            else:
                check(odg <= SHARD_F32_BAR,
                      f"{mode} float32 sharded against batch: {odg}")
    audio = sum(r.shape[0] for r in pairs[0]) / C.SAMPLING_RATE
    for mode in MODES:
        advanced, mb = mode == "advanced", MICROBATCH[mode]
        walls = {"peaq_batch": [], "peaq_sharded": []}
        calls = {"peaq_batch": PB.peaq_batch,
                 "peaq_sharded": shard.peaq_sharded}
        for rep in range(4):
            for name in (("peaq_batch", "peaq_sharded") if rep % 2 == 0
                         else ("peaq_sharded", "peaq_batch")):
                torch.cuda.synchronize()
                start = time.perf_counter()
                calls[name](*pairs, advanced=advanced, dtype="float64",
                            microbatch=mb)
                if rep:
                    walls[name].append(time.perf_counter() - start)
        print(f"  {mode} float64, {len(pairs[0])} x 10 s stereo, microbatch "
              f"{mb} ({card}): " + ", ".join(
                  f"{name} {audio / statistics.median(w):.1f} audio-s/s "
                  f"({statistics.median(w) * 1e3:.1f} ms, median of 3; "
                  f"{min(w) * 1e3:.1f}..{max(w) * 1e3:.1f} ms)"
                  for name, w in walls.items()), flush=True)
    from gstpeaq_tpu_torch.models import nn as NN
    rng = np.random.default_rng(4)
    for mode in MODES:
        advanced = mode == "advanced"
        lo = np.asarray(C.NN_AMIN_ADVANCED if advanced else C.NN_AMIN_BASIC)
        hi = np.asarray(C.NN_AMAX_ADVANCED if advanced else C.NN_AMAX_BASIC)
        movs = lo + (hi - lo) * rng.uniform(0, 1, (TRAIN_EXAMPLES, lo.size))
        target = NN.di_advanced(torch.from_numpy(movs)).numpy() \
            if advanced else NN.di_basic(torch.from_numpy(movs)).numpy()
        target = target + 0.3 * rng.standard_normal(TRAIN_EXAMPLES)
        shard.train_cognitive_sharded(movs, target, advanced=advanced,
                                      steps=2)
        torch.cuda.synchronize()
        start = time.perf_counter()
        params, losses = shard.train_cognitive_sharded(
            movs, target, advanced=advanced, steps=TRAIN_STEPS)
        step_ms = (time.perf_counter() - start) / TRAIN_STEPS * 1e3
        start = time.perf_counter()
        cpu_params, cpu_losses = shard.train_cognitive_sharded(
            movs, target, devices=["cpu"], advanced=advanced,
            steps=TRAIN_STEPS)
        cpu_ms = (time.perf_counter() - start) / TRAIN_STEPS * 1e3
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
        prel = max(float((params[k].cpu() - cpu_params[k]).abs().max()
                         / cpu_params[k].abs().max()) for k in params)
        print(f"  {mode} train_cognitive_sharded(), {TRAIN_EXAMPLES} MOV "
              f"vectors, {TRAIN_STEPS} steps over {len(devices)} device(s) "
              f"({card}): {step_ms:.3f} ms a step (CPU {cpu_ms:.3f}); loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}; against the CPU, "
              f"losses {rel:.3e}, parameters {prel:.3e} relative",
              flush=True)
        check(rel <= TRAIN_BAR and prel <= TRAIN_BAR,
              f"{mode} training on the card against the CPU: {rel}, {prel}")
        check(losses[-1] < losses[0], f"{mode} training loss: {losses}")
    ref, test = stream_program()
    for mode in MODES:
        kw = dict(chunk_frames=STREAM_CHUNK, dtype="float64",
                  advanced=mode == "advanced")
        one = PS.PeaqStreamPool(4, device="cuda:0", **kw)
        two = PS.PeaqStreamPool(4, device=["cuda:0", "cuda:0"], **kw)
        pool_pair([one, two], ref, test, POOL_SECONDS)
        a, b = one.finalize(), two.finalize()
        names = list(b.movs)
        odg, mov = deviation(
            {"odg": b.odg, "movs": np.stack([b.movs[k] for k in names], 1)},
            {"odg": a.odg, "movs": np.stack([a.movs[k] for k in names], 1)})
        with tempfile.TemporaryDirectory() as tmp:
            CK.save_state(f"{tmp}/one", one.state)
            CK.save_state(f"{tmp}/two", two.state)
            with np.load(f"{tmp}/one.npz") as x, np.load(f"{tmp}/two.npz") as y:
                same_keys = sorted(x.files) == sorted(y.files) and all(
                    x[k].shape == y[k].shape and x[k].dtype == y[k].dtype
                    for k in x.files)
                devs = [leaf_dev(y[k], x[k]) for k in x.files
                        if k != "format_version"] if same_keys else [math.inf]
                exact = sum(np.array_equal(x[k], y[k], equal_nan=True)
                            for k in x.files)
        print(f"  {mode} float64 pool of 4 stereo streams x {POOL_SECONDS} s "
              f"over "
              f"['cuda:0', 'cuda:0'] against one device: |dODG| {odg:.3e}, "
              f"MOVs |d|/(1 + |w|) {mov:.3e}; checkpoint {len(devs)} leaves, "
              f"{exact - 1} bit for bit, worst {max(devs):.3e} of a leaf's "
              f"largest value", flush=True)
        check(np.isfinite(a.odg).all(), f"{mode} pool ODG is not finite")
        check(odg <= SHARD_BAR and mov <= SHARD_BAR and same_keys
              and max(devs) <= SHARD_BAR,
              f"{mode} two-part pool against one device: {odg}, {mov}, "
              f"{max(devs)}")
    return counts


# phase 13: the tools (gstpeaq_tpu_torch/tools/) on the card.  The WAV
# sweep's pairs (PCM16 at 48 kHz, float32 at 48 kHz, PCM16 at 44.1 kHz,
# which the loader resamples), the demo sweep's pair count (the JAX
# system's at-scale record, codec_sweep.py --demo 1000), the one-hour
# stream's and the pools' minutes, and their bars: the TSV holds 4
# decimals, so each value within SWEEP_BAR of per-pair peaq(); the float64
# hour within phase 10's STREAM_BAR (ODG, DI, and MOV x (1 + |w|)) of one
# shot, its peak memory flat within FLAT_BAR
SWEEP_WAVS = ("pcm16",) * 12 + ("float32",) * 2 + ("pcm16 44.1",) * 2
SWEEP_DEMO = 1000
SWEEP_BAR = 1e-4
LONG_MINUTES = 60
POOL_MINUTES = 10
FLAT_BAR = 0.05


def write_pcm16(path: pathlib.Path, x: np.ndarray, rate: int) -> str:
    """float [T, CH] in [-1, 1) as a 16-bit PCM WAV."""
    pcm = PB.to_pcm16(x).astype("<i2")
    block = 2 * x.shape[1]
    fmt = struct.pack("<HHIIHH", 1, x.shape[1], rate, rate * block, block,
                      16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
            + struct.pack("<I", pcm.nbytes) + pcm.tobytes())
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


def tool_run(label: str, main, argv: list, expected: dict, card: str,
             **kwargs) -> tuple[str, float]:
    """main(argv, **kwargs) of a tool in-process on the card, the counts
    set to 0 just before and read just after, and held to `expected`; its
    stdout and stderr lines are printed.  Returns its stdout and wall
    seconds."""
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    got = read_counts()
    print(f"  {label} ({card}): {' '.join(argv)}: exit {rc}, {wall:.2f} s, "
          f"launches {got}", flush=True)
    for line in (err.getvalue() + out.getvalue()).splitlines():
        print(f"    | {line}", flush=True)
    check(rc == 0, f"{label}: exit {rc}")
    check(got == expected, f"{label}: launches {got}, expected {expected}")
    return out.getvalue(), wall


def times(n: int, launches: dict) -> dict:
    return {name: n * k for name, k in launches.items()}


def tsv(path) -> list[tuple[str, float, float]]:
    rows = pathlib.Path(path).read_text().splitlines()
    check(rows[0] == "item\todg\tdi", f"TSV header {rows[0]!r}")
    return [(name, float(odg), float(di)) for name, odg, di in
            (row.split("\t") for row in rows[1:])]


def sweep_deviation(rows, refs, tests, advanced: bool) -> tuple[float, float]:
    """The worst |dODG| and |dDI| of TSV rows against per-pair float64
    peaq() of the same pairs (int16 PCM dequantized as the card does)."""
    def dev(g, w):
        if np.isnan(g) or np.isnan(w):
            return 0.0 if np.isnan(g) and np.isnan(w) else math.inf
        return abs(g - w)

    worst = [0.0, 0.0]
    for (_, odg, di), r, t in zip(rows, refs, tests):
        want = api.peaq(PS._dequant_host(r), PS._dequant_host(t),
                        advanced=advanced, dtype="float64")
        worst[0] = max(worst[0], dev(odg, want.odg))
        worst[1] = max(worst[1], dev(di, want.di))
    return worst[0], worst[1]


def sweep_wavs(tmp: pathlib.Path, card: str, counts: dict) -> None:
    """(a) codec_sweep over a manifest of len(SWEEP_WAVS) 10 s stereo pairs
    of drift corpus v2 written as WAVs, per mode, with and without
    --pcm16: each TSV value within SWEEP_BAR of per-pair peaq() on the
    pair as the tool loaded it."""
    refs, tests = corpus_v2()
    lines = []
    for i, kind in enumerate(SWEEP_WAVS):
        paths = []
        for sig, x in (("ref", refs[i]), ("test", tests[i])):
            path = tmp / f"{sig}{i}.wav"
            if kind == "float32":
                wavio.write_wav(str(path), x)
            elif kind == "pcm16":
                write_pcm16(path, x, C.SAMPLING_RATE)
            else:
                write_pcm16(path, x[:441000], 44100)
            paths.append(str(path))
        lines.append("\t".join(paths))
    manifest = tmp / "manifest.tsv"
    manifest.write_text("# drift corpus v2 as WAVs\n" + "\n".join(lines)
                        + "\n")
    pairs = CS.load_manifest(str(manifest))
    for mode in MODES:
        advanced = mode == "advanced"
        for pcm16 in (False, True):
            label = f"codec_sweep {mode} WAVs" + " --pcm16" * pcm16
            out = tmp / "out.tsv"
            argv = ([str(manifest), "--out", str(out)]
                    + ["--advanced"] * advanced + ["--pcm16"] * pcm16)
            tool_run(label, CS.main, argv, PATH_LAUNCHES[mode], card)
            load = (native.load_audio_48k_ship if pcm16
                    else native.load_audio_48k)
            loaded = [[load(p) for p in pair] for pair in pairs]
            if pcm16:
                loaded = [[PB.to_pcm16(x) for x in pair] for pair in loaded]
            rows = tsv(out)
            check([r[0] for r in rows] == [t for _, t in pairs],
                  f"{label}: items {[r[0] for r in rows]}")
            d_odg, d_di = sweep_deviation(rows, *zip(*loaded), advanced)
            print(f"  {label} ({card}): {len(rows)} pairs against per-pair "
                  f"float64 peaq() of the pairs as loaded: |dODG| "
                  f"{d_odg:.2e}, |dDI| {d_di:.2e}", flush=True)
            check(d_odg <= SWEEP_BAR and d_di <= SWEEP_BAR,
                  f"{label}: {d_odg}, {d_di} against peaq()")
            counts[f"tools_sweep_wav_{mode}" + "_pcm16" * pcm16] = \
                PATH_LAUNCHES[mode]


def sweep_demo(tmp: pathlib.Path, card: str, counts: dict) -> None:
    """(b) codec_sweep --demo SWEEP_DEMO --pcm16 per mode (basic in
    microbatches of 64, advanced of the tool's 32), the pairs made once for
    both: the tool's lines, peak device memory, and the first 4 items
    within SWEEP_BAR of per-pair peaq()."""
    made = functools.cache(make_pairs)
    saved = CS.make_pairs
    CS.make_pairs = made
    try:
        for mode, mb in (("basic", 64), ("advanced", 32)):
            advanced = mode == "advanced"
            out = tmp / "demo.tsv"
            argv = ["--demo", str(SWEEP_DEMO), "--pcm16", "--out", str(out)]
            argv += ["--advanced"] if advanced else ["--microbatch", str(mb)]
            torch.cuda.reset_peak_memory_stats()
            tool_run(f"codec_sweep {mode} demo", CS.main, argv,
                     times(-(-SWEEP_DEMO // mb), PATH_LAUNCHES[mode]), card)
            peak = torch.cuda.max_memory_allocated()
            rows = tsv(out)
            refs, tests = made(SWEEP_DEMO, 10.0)
            check(len(rows) == SWEEP_DEMO
                  and all(np.isfinite([o, d]).all() for _, o, d in rows),
                  f"codec_sweep {mode} demo: {len(rows)} rows")
            d_odg, d_di = sweep_deviation(
                rows[:4], [PB.to_pcm16(r) for r in refs[:4]],
                [PB.to_pcm16(t) for t in tests[:4]], advanced)
            print(f"  codec_sweep {mode} demo ({card}): peak device memory "
                  f"{peak / 2**30:.2f} GiB; first 4 items against per-pair "
                  f"float64 peaq(): |dODG| {d_odg:.2e}, |dDI| {d_di:.2e}",
                  flush=True)
            check(d_odg <= SWEEP_BAR and d_di <= SWEEP_BAR,
                  f"codec_sweep {mode} demo: {d_odg}, {d_di}")
            counts[f"tools_sweep_demo_{mode}"] = times(
                -(-SWEEP_DEMO // mb), PATH_LAUNCHES[mode])
    finally:
        CS.make_pairs = saved


def hour_stream(advanced: bool, minutes: int, card: str) -> tuple[
        object, dict]:
    """longform_bench --minutes `minutes` (one stream, the tool's chunk) in
    float64, through tool_run: its final result, wall seconds, and the
    peak device memory over the first minute, the first two, and each of
    the last two minutes.  The first FB step of the tool's chunk (16,384
    FB frames, 65.5 s) ends in minute 2, so the first two minutes and the
    last two each hold FB steps."""
    sr = C.SAMPLING_RATE
    total = minutes * 60 * sr
    peaks = {}
    seen = {}

    def observe(done, stream):
        seen["stream"] = stream
        if done in (sr * 60, sr * 120, total - 120 * sr, total - 60 * sr,
                    total):
            torch.cuda.synchronize()
            peaks[done] = torch.cuda.max_memory_allocated()
            if done in (total - 120 * sr, total - 60 * sr):
                torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, wall = tool_run(f"longform_bench {'advanced' if advanced else 'basic'}"
                       f" {minutes} minutes", LB.main,
                       ["--minutes", str(minutes)] + ["--advanced"] * advanced,
                       stream_launches(total, advanced, TOOL_CHUNK), card,
                       observe=observe)
    return seen.pop("stream").current(), dict(
        wall=wall, minute_1=peaks[sr * 60], minutes_1_2=peaks[sr * 120],
        minute_59=peaks[total - 60 * sr], minute_60=peaks[total])


def long_stream(card: str, counts: dict) -> None:
    """(c) longform_bench --minutes LONG_MINUTES, one stream, the tool's
    chunk, float64, per mode: the launches (steps x phase 6's counts), the
    rate, peak memory at minute 60 within FLAT_BAR of minute 1 (and the
    last two minutes of the first two), then the stream freed and the
    final result against one-shot peaq() of the same program (the tool's
    feeds joined) within STREAM_BAR, over the longest program of 60, 30
    or 15 minutes whose one shot fits on the card."""
    sr = C.SAMPLING_RATE
    for mode in MODES:
        advanced = mode == "advanced"
        got, run = hour_stream(advanced, LONG_MINUTES, card)
        total = LONG_MINUTES * 60 * sr
        flat = abs(run["minute_60"] - run["minute_1"]) / max(
            run["minute_60"], run["minute_1"])
        last2 = max(run["minute_59"], run["minute_60"])
        flat2 = abs(last2 - run["minutes_1_2"]) / max(last2,
                                                      run["minutes_1_2"])
        print(f"  longform_bench {mode} --minutes {LONG_MINUTES} ({card}): "
              f"{total / sr / run['wall']:.1f} audio-s/s; peak memory "
              f"minute 1 {run['minute_1'] / 2**20:.1f} MiB, minute 60 "
              f"{run['minute_60'] / 2**20:.1f} MiB ({flat:.2%} apart), "
              f"minutes 1-2 {run['minutes_1_2'] / 2**20:.1f} MiB, minutes "
              f"59-60 {last2 / 2**20:.1f} MiB ({flat2:.2%} apart)",
              flush=True)
        check(flat <= FLAT_BAR and flat2 <= FLAT_BAR,
              f"longform_bench {mode}: memory grows {run}")
        counts[f"tools_longform_{mode}"] = stream_launches(total, advanced,
                                                           TOOL_CHUNK)
        gc.collect()
        torch.cuda.empty_cache()
        ref = np.empty((total, 2), np.float32)
        test = np.empty((total, 2), np.float32)
        at = 0
        for r, t in LB.feeds(*LB.base_program(), total):
            ref[at:at + len(r)], test[at:at + len(t)] = r, t
            at += len(r)
        for minutes in (LONG_MINUTES, LONG_MINUTES // 2, LONG_MINUTES // 4):
            n = minutes * 60 * sr
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            try:
                want = api.peaq(ref[:n], test[:n], advanced=advanced,
                                dtype="float64")
                break
            except torch.cuda.OutOfMemoryError:
                gc.collect()
                torch.cuda.empty_cache()
                print(f"  one-shot peaq() over {minutes} minutes does not "
                      f"fit on the card", flush=True)
        else:
            check(False, f"{mode}: no one shot fits")
        one_wall = time.perf_counter() - start
        one_peak = torch.cuda.max_memory_allocated()
        del ref, test
        if minutes != LONG_MINUTES:
            got, _ = hour_stream(advanced, minutes, card)
        d_odg, d_di, d_mov = stream_deviation(got, want)
        print(f"  longform_bench {mode} against one-shot float64 peaq() "
              f"over the same {minutes}-minute program ({card}): ODG "
              f"{got.odg:.9f}, one-shot {want.odg:.9f}; |dODG| {d_odg:.3e}, "
              f"|dDI| {d_di:.3e}, MOVs |d|/(1 + |w|) {d_mov:.3e}; one-shot "
              f"{one_wall:.2f} s, peak {one_peak / 2**30:.2f} GiB",
              flush=True)
        check(np.isfinite(got.odg) and d_odg <= STREAM_BAR
              and d_di <= STREAM_BAR and d_mov <= STREAM_BAR,
              f"longform_bench {mode} against one shot: {d_odg}, {d_di}, "
              f"{d_mov}")
        gc.collect()
        torch.cuda.empty_cache()


def device_source_launches(n_samples: int, advanced: bool) -> dict:
    """longform_bench --device-source's launches: one warm round, then
    rounds until n_samples are covered, each one basic step, or three FFT
    steps and one FB step (STREAM_STEP_LAUNCHES)."""
    stride = TOOL_CHUNK * C.FFT_STEPSIZE * (3 if advanced else 1)
    rounds = 1 + -(-n_samples // stride)
    steps = ({"advanced_fft": 3, "advanced_fb": 1} if advanced
             else {"basic": 1})
    return {name: rounds * sum(k * STREAM_STEP_LAUNCHES[path][name]
                               for path, k in steps.items())
            for name in KERNELS}


def pools(card: str, counts: dict) -> None:
    """(d) longform_bench --streams POOL --minutes POOL_MINUTES per mode,
    fed as the tool feeds (every stream's ODG finite), then with
    --device-source; the rates are the tool's lines.  First the host's
    time to make the pool's feeds alone (LB.feeds, no stream): the part
    of a fed pool's wall that is not the stream's."""
    total = POOL_MINUTES * 60 * C.SAMPLING_RATE
    start = time.perf_counter()
    for _ in LB.feeds(*LB.base_program(), total, POOL):
        pass
    print(f"  longform_bench's feeds of {POOL} streams x {POOL_MINUTES} "
          f"minutes alone, made on the host: "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    for mode in MODES:
        advanced = mode == "advanced"
        argv = (["--streams", str(POOL), "--minutes", str(POOL_MINUTES)]
                + ["--advanced"] * advanced)
        seen = {}
        torch.cuda.reset_peak_memory_stats()
        tool_run(f"longform_bench {mode} pool", LB.main, argv,
                 stream_launches(total, advanced, TOOL_CHUNK), card,
                 observe=lambda done, pool: seen.update(pool=pool))
        odg = seen.pop("pool").current().odg
        print(f"  longform_bench {mode} pool ({card}): peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, ODG "
              f"{odg.min():.6f}..{odg.max():.6f}", flush=True)
        check(np.isfinite(odg).all() and odg.shape == (POOL,),
              f"longform_bench {mode} pool: ODG {odg}")
        counts[f"tools_pool_{mode}"] = stream_launches(total, advanced,
                                                       TOOL_CHUNK)
        expected = device_source_launches(total, advanced)
        tool_run(f"longform_bench {mode} device-source", LB.main,
                 ["--device-source"] + argv, expected, card)
        counts[f"tools_device_source_{mode}"] = expected
        gc.collect()
        torch.cuda.empty_cache()


def settings_sweep(tmp: pathlib.Path, card: str, counts: dict) -> None:
    """(e) optimize_settings, basic, over a synthetic two-item dataset
    (fake_conformance_items): its 32 RMSE lines and the best."""
    items = ["acodsna", "bcodtri"]
    data = tmp / "conformance"
    data.mkdir()
    fake_conformance_items(data, items)
    table = conformance.CONFORMANCE_BASIC
    saved = os.environ.get("CONFORMANCEDATADIR")
    conformance.CONFORMANCE_BASIC = {k: table[k] for k in items}
    os.environ["CONFORMANCEDATADIR"] = str(data)
    expected = times(2 ** len(OS.FLAGS) * len(items),
                     PATH_LAUNCHES["basic"])
    try:
        out, _ = tool_run("optimize_settings", OS.main, [], expected, card)
    finally:
        conformance.CONFORMANCE_BASIC = table
        if saved is None:
            del os.environ["CONFORMANCEDATADIR"]
        else:
            os.environ["CONFORMANCEDATADIR"] = saved
    lines = out.splitlines()
    rmse = [line for line in lines
            if re.fullmatch(r"[01]+  RMSE \d+\.\d{4}", line)]
    check(len(rmse) == 2 ** len(OS.FLAGS) and lines[-1].startswith("best: {"),
          f"optimize_settings: {lines}")
    counts["tools_optimize_settings"] = expected


def phase_tools(card: str) -> dict:
    """The tools on the card, each through its main() in-process with the
    counts set to 0 just before and read just after, float64, with no
    GSTPEAQ_PLATFORM (so on CUDA): (a) sweep_wavs, (b) sweep_demo, (c)
    long_stream, (d) pools, (e) settings_sweep.  Returns each run's
    launches per kernel."""
    print("phase 13 tools", flush=True)
    counts = {}
    saved = os.environ.pop("GSTPEAQ_PLATFORM", None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            sweep_wavs(tmp, card, counts)
            sweep_demo(tmp, card, counts)
            long_stream(card, counts)
            pools(card, counts)
            settings_sweep(tmp, card, counts)
    finally:
        if saved is not None:
            os.environ["GSTPEAQ_PLATFORM"] = saved
    return {name: {run: got[name] for run, got in counts.items()}
            for name in KERNELS}


def timed(phase, *args):
    """Run one phase and print its seconds."""
    start = time.perf_counter()
    out = phase(*args)
    print(f"  ({phase.__name__}: {time.perf_counter() - start:.1f} s)",
          flush=True)
    return out


def main() -> None:
    start = time.perf_counter()
    card = timed(phase_card)
    count_conv1d()
    count_plain_gate()
    count_plain_ehs()
    count_plain_mask()
    timed(phase_build)
    rng = np.random.default_rng(1)
    pair10 = ten_second_pair()
    spec = load_spec(pair10)
    main_kernels, batch_kernels, stream_kernels = timed(phase_kernels, rng,
                                                        pair10)
    odg64 = timed(phase_float64, pair10, spec)
    adv64 = timed(phase_adv_float64, pair10, spec)
    timed(phase_tiers, pair10, odg64)
    timed(phase_adv_float32, pair10, adv64)
    timed(phase_corpus)
    pairs = bench_pairs()
    counts = timed(phase_counters, pair10, pairs)
    walls, long, hour = timed(phase_times, main_kernels, batch_kernels,
                        stream_kernels, pair10)
    timed(phase_profile, pair10, walls)
    timed(phase_batch, pairs, card)
    for mode, got in timed(phase_streams, card).items():
        for name, n in got.items():
            counts[name][f"stream_{mode}"] = n
    for mode, got in timed(phase_cli, pair10, card).items():
        for name, n in got.items():
            counts[name][f"cli_{mode}"] = n
    for mode, got in timed(phase_shard, pairs, card).items():
        for name, n in got.items():
            counts[name][f"sharded_{mode}"] = n
    for name, runs in timed(phase_tools, card).items():
        counts[name].update(runs)
    check(not any(m == "jax" or m.split(".")[0] == "gstpeaq_tpu"
                  for m in sys.modules),
          "JAX or the JAX package was imported")
    kernels = []
    for name in KERNELS:
        f32, f64 = (main_kernels[name][dtype] for dtype in DTYPES)
        kernels.append(dict(
            name=name, **KERNELS[name], launches=sum(counts[name].values()),
            launches_by_path=counts[name], max_abs_err=f32["max_abs_err"],
            ms=f32["ms"], plain_ms=f32["plain_ms"],
            bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
            library_ms=f32.get("library_ms"),
            max_abs_err_f64=f64["max_abs_err"],
            ms_f64=f64["ms"], plain_ms_f64=f64["plain_ms"],
            bound_ms_f64=f64["bound_ms"], bound_by_f64=f64["bound_by"],
            library_ms_f64=f64.get("library_ms"),
            batch=[dict(case=b32["case"], max_abs_err=b32["max_abs_err"],
                        ms=b32["ms"], plain_ms=b32["plain_ms"],
                        bound_ms=b32["bound_ms"], bound_by=b32["bound_by"],
                        library_ms=b32.get("library_ms"),
                        max_abs_err_f64=b64["max_abs_err"],
                        ms_f64=b64["ms"], plain_ms_f64=b64["plain_ms"],
                        bound_ms_f64=b64["bound_ms"],
                        bound_by_f64=b64["bound_by"],
                        library_ms_f64=b64.get("library_ms"))
                   for b32, b64 in zip(*(
                       [c for c in batch_kernels[dtype]["cases"]
                        if c["name"] == name] for dtype in DTYPES))],
            stream=[dict(case=s32["case"], max_abs_err=s32["max_abs_err"],
                         ms=s32["ms"], plain_ms=s32["plain_ms"],
                         bound_ms=s32["bound_ms"], bound_by=s32["bound_by"],
                         library_ms=s32.get("library_ms"),
                         max_abs_err_f64=s64["max_abs_err"],
                         ms_f64=s64["ms"], plain_ms_f64=s64["plain_ms"],
                         bound_ms_f64=s64["bound_ms"],
                         bound_by_f64=s64["bound_by"],
                         library_ms_f64=s64.get("library_ms"))
                    for s32, s64 in zip(*(
                        [c for c in stream_kernels[dtype]
                         if c["name"] == name] for dtype in DTYPES))],
            stream_steps={path: launches[name]
                          for path, launches in STREAM_STEP_LAUNCHES.items()},
            chunk_shapes=chunk_shapes(name),
            tool_chunk_shapes=chunk_shapes(name, TOOL_CHUNK),
            **({"long_row": dict(
                shape=LONG_ROW, **long[name][torch.float32],
                **{f"{key}_f64": v for key, v in
                   long[name][torch.float64].items()})}
               if name in long else {}),
            **({"hour": dict(
                shape=HOUR_ROWS, **hour[torch.float32],
                **{f"{key}_f64": v for key, v in
                   hour[torch.float64].items()})}
               if name == "fir_bank" else {})))
    print(f"all phases: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
