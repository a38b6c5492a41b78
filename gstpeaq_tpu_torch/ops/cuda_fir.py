"""The FB ear's complex FIR bank: CUDA kernel F1 and its plain PyTorch
version.

F1 `fir_bank` (csrc/fir_bank.cu) computes the 40 complex bands of
src/fbearmodel.c:398-435 at every 32nd sample.  It is not a TPU kernel: the
JAX package leaves the bank to XLA, as convs over groups of bands that read
only each group's input blocks (gstpeaq_tpu/ops/fb_ear.py::
_conv_group_outputs).  F1 replaces `fir_bank_plain`, the uniform cuDNN
conv1d of every band over the whole 1,456-lag window, of whose taps 63%
are structural zeros: the Table-8 filter lengths fall from 1,456 to 52,
each centred in the window.

The host plan (`fir_plan`, numpy, cached) finds each of the 80 channels'
(40 real, 40 imaginary) nonzero window from the taps themselves, groups
the bands GROUP_BANDS at a time in band order (8 channels a group, the n8
of the double kernel's mma tiles; the windows nest, so a group's union is
close to its longest band's), rounds each union out to K_ALIGN taps and
packs each group's weights [K_g, 8] contiguously.  It also splits the
groups into 1..MAX_PARTS parts of near-equal work: `launch_grid` gives a
small grid (one pair, a chunk step) one block per part of each tile, so
that every SM gets work, choosing the parts that finish soonest on the
card's SMs.  The grid and the shared-memory strip are computed on the
host in Python ints, so the one-hour one shot's 64-bit offsets are plain
to check.

The wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  It
counts its launches in `fir_bank_launches`, one per call.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.nn import functional as F

from .. import constants as C
from . import _build

BANDS = C.FB_BAND_COUNT
SUB = C.FB_SUBSAMPLING          # 32: one instant every 32 samples
TAPS = C.FB_BUFFER_LENGTH       # 1456 lags, 0..1455
# the bank as a stride-1 convolution over 32-sample blocks: FIR_BLOCKS
# blocks of window behind FIR_PAD leading samples (zeros or the history)
FIR_BLOCKS = 47
FIR_PAD = SUB * (FIR_BLOCKS - 1)
# csrc/fir_bank.cu's constants: bands a group (its 8 channels are the N of
# an mma.m8n8k4 tile), the k-step a window is rounded out to, and per
# dtype the instants a block takes and the skew of its strip (values added
# every 32 samples)
GROUP_BANDS = 4
K_ALIGN = 4
TILE_INSTANTS = {torch.float32: 512, torch.float64: 128}
SKEW = {torch.float32: 1, torch.float64: 4}
CHUNK = 32                      # taps of weights a block stages at once
MAX_PARTS = 4
# an H100's shared memory a SM, and what each block reserves of it
SM_SHARED = 233472
BLOCK_RESERVED = 1024
fir_bank_launches = 0


@dataclasses.dataclass(frozen=True, eq=False)
class FirPlan:
    """Where F1 reads its taps.  j is a tap's offset in xs (the FIR_PAD
    history samples, then hp2): channel c's output at instant i is
    sum_j xs[32 i + j] w_c[j], w_c[j] = taps[c, FIR_PAD - j].
    channel_lo, channel_hi [80]: each channel's nonzero window of j; lo,
    hi [G]: each group's union, rounded out to K_ALIGN; offset [G]: the
    first of the group's K_g x 8 values in `weights` (float64, [K_g, 8]
    row-major, channels 4g..4g+3 real then imaginary); jbase: min(lo)
    rounded down to 32; tables[p - 1]: the int64 table the kernel takes
    for p parts, [jbase, lo, hi, offset, p, order, part_start] with the
    groups in part order and where each part starts.  Its arrays are
    read-only: the plan is cached, and compared and hashed as an object
    (packed_weight's cache key)."""
    channel_lo: np.ndarray
    channel_hi: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    offset: np.ndarray
    weights: np.ndarray
    jbase: int
    tables: tuple

    @property
    def groups(self) -> int:
        return len(self.lo)

    def parts(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        """(order, part_start) of the split into p parts."""
        table = self.tables[p - 1][1 + 3 * self.groups:]
        return table[1:1 + self.groups], table[1 + self.groups:]


def split(work: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """The groups split into p parts of near-equal work (taps each):
    longest first, each to the part with the least so far (the lowest
    such part on a tie), each part's groups in band order.  Returns the
    groups in part order and where each part starts."""
    load = [0] * p
    member = [[] for _ in range(p)]
    for g in sorted(range(len(work)), key=lambda g: (-work[g], g)):
        q = min(range(p), key=lambda q: (load[q], q))
        load[q] += int(work[g])
        member[q].append(g)
    order = np.concatenate([sorted(m) for m in member])
    start = np.cumsum([0] + [len(m) for m in member])
    return order, start


def group_channels(g: int) -> list[int]:
    """The taps rows of group g's 8 channels, in packed order."""
    bands = range(GROUP_BANDS * g, GROUP_BANDS * (g + 1))
    return [*bands, *(BANDS + b for b in bands)]


def fir_plan(taps: np.ndarray) -> FirPlan:
    """F1's plan for the lag-order taps [80, 1456] (fb_ear.folded_taps)."""
    taps = np.ascontiguousarray(taps, dtype=np.float64)
    return _plan(taps.tobytes(), taps.shape)


@functools.lru_cache(maxsize=8)
def _plan(raw: bytes, shape: tuple) -> FirPlan:
    taps = np.frombuffer(raw, np.float64).reshape(shape)
    if shape != (2 * BANDS, TAPS) or BANDS % GROUP_BANDS:
        raise ValueError(f"fir_plan: taps {shape}, expected "
                         f"{(2 * BANDS, TAPS)}")
    lo_c = np.full(2 * BANDS, FIR_PAD + 1)
    hi_c = np.full(2 * BANDS, FIR_PAD + 1)
    for c in range(2 * BANDS):
        lags = np.nonzero(taps[c])[0]
        if lags.size:
            lo_c[c], hi_c[c] = FIR_PAD - lags.max(), FIR_PAD - lags.min() + 1
    groups = BANDS // GROUP_BANDS
    lo, hi, offset, packed = [], [], [], []
    start = 0
    for g in range(groups):
        ch = group_channels(g)
        live = [c for c in ch if hi_c[c] > lo_c[c]]
        if live:
            g_lo = min(lo_c[c] for c in live) // K_ALIGN * K_ALIGN
            g_hi = -(-max(hi_c[c] for c in live) // K_ALIGN) * K_ALIGN
        else:
            g_lo = g_hi = 0
        j = np.arange(g_lo, g_hi)
        lag = FIR_PAD - j
        valid = (lag >= 0) & (lag < TAPS)
        w = np.where(valid[:, None],
                     taps[ch][:, np.clip(lag, 0, TAPS - 1)].T, 0.0)
        lo.append(g_lo)
        hi.append(g_hi)
        offset.append(start)
        packed.append(w.reshape(-1))
        start += w.size
    lo, hi = np.array(lo), np.array(hi)
    empty = lo == hi
    jbase = int(lo[~empty].min()) // SUB * SUB if (~empty).any() else 0
    lo[empty] = hi[empty] = jbase
    offset = np.array(offset)
    tables = tuple(np.concatenate([[jbase], lo, hi, offset, [p],
                                   *split(hi - lo, p)]).astype(np.int64)
                   for p in range(1, min(MAX_PARTS, groups) + 1))
    out = FirPlan(lo_c, hi_c, lo, hi, offset, np.concatenate(packed), jbase,
                  tables)
    for a in (out.channel_lo, out.channel_hi, out.lo, out.hi, out.offset,
              out.weights, *out.tables):
        a.flags.writeable = False
    return out


def launch_grid(rows: int, t: int, dtype, plan: FirPlan,
                sms: int) -> tuple[int, int, int, int, int]:
    """F1's launch for `rows` signal rows of t samples on a card of `sms`
    SMs, in Python ints: (tiles a row, parts, blocks = rows x tiles x
    parts, rows of 32 samples a block's strip holds, its shared-memory
    bytes: two chunks of weights and the strip).  Block b takes part
    b % parts of the groups at row (b // parts) // tiles and instants from
    TILE_INSTANTS ((b // parts) % tiles); its strip covers xs from
    32 i0 + jbase through the last tap of its last instant.  A grid that
    fills the blocks the SMs hold at once is not split; a smaller one takes
    the parts whose blocks finish soonest: the waves of blocks times the
    largest part's share of the taps (the fewest parts on a tie)."""
    n_inst = t // SUB
    tile = TILE_INSTANTS[dtype]
    tiles = -(-n_inst // tile)
    span = SUB * (tile - 1) + int(plan.hi.max()) - plan.jbase
    strip_rows = -(-span // SUB)
    item = torch.empty((), dtype=dtype).element_size()
    smem = (2 * CHUNK * 2 * GROUP_BANDS + strip_rows * (SUB + SKEW[dtype])) \
        * item
    slots = sms * (SM_SHARED // (smem + BLOCK_RESERVED))
    work = plan.hi - plan.lo

    def finish(p):
        order, start = plan.parts(p)
        largest = max(work[order[start[q]:start[q + 1]]].sum()
                      for q in range(p))
        return -(-rows * tiles * p // slots) * largest / max(work.sum(), 1)

    parts = 1 if rows * tiles >= slots else min(
        range(1, len(plan.tables) + 1), key=lambda p: (finish(p), p))
    return tiles, parts, rows * tiles * parts, strip_rows, smem


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=16)
def packed_weight(plan: FirPlan, dtype, device) -> torch.Tensor:
    """The plan's packed weights as a tensor F1 reads, cached per (plan,
    dtype, device), so that the layout always matches the dtype it is read
    in: in float64 each k-step's [4 taps, 8 channels] stored [8, 4], the
    order of an mma B fragment (lane l holds tap l % 4 of channel l // 4),
    so that a warp reads 32 consecutive values; in float32 [K, 8] row-major.
    The tensor is shared: callers do not write to it."""
    w = plan.weights
    if dtype == torch.float64:
        w = w.reshape(-1, K_ALIGN, 2 * GROUP_BANDS).transpose(0, 2, 1)
    return torch.tensor(np.ascontiguousarray(w).reshape(-1), dtype=dtype,
                        device=device)


def fir_bank_plain(hp2: torch.Tensor, weight: torch.Tensor,
                   history: torch.Tensor | None = None):
    """The complex FIR bank as one stride-1 conv1d over 32-sample blocks.
    hp2: [..., T], T divisible by 32; weight: fb_ear.fir_weight's
    [80, 32, 47]; history: [..., >= FIR_PAD], the samples before hp2, or
    None for zeros.  Returns (re, im), each [..., 40, I] with I = T / 32:
    fb[i] = sum_lag h[lag] hp2[32 i - lag].  The history's last FIR_PAD
    samples take the place of the leading zeros."""
    lead, t = hp2.shape[:-1], hp2.shape[-1]
    if history is None:
        x = F.pad(hp2.reshape(-1, t), (FIR_PAD, 0))
    else:
        x = torch.cat([history[..., -FIR_PAD:].to(hp2.dtype), hp2],
                      dim=-1).reshape(-1, FIR_PAD + t)
    blocks = x.view(x.shape[0], -1, SUB).transpose(1, 2)   # [n, 32, M]
    out = F.conv1d(blocks, weight)                         # [n, 80, I]
    out = out.reshape(*lead, 2, BANDS, t // SUB)
    return out[..., 0, :, :].contiguous(), out[..., 1, :, :].contiguous()


def fir_bank(hp2: torch.Tensor, weight: torch.Tensor, plan: FirPlan,
             history: torch.Tensor | None = None):
    """F1: see fir_bank_plain, which a CPU tensor takes (with `weight`).
    On the card: plan, fir_plan of the taps `weight` holds (the kernel
    reads packed_weight(plan) in hp2's dtype on its device); hp2 [..., T],
    T divisible by 32; history [..., >= FIR_PAD] or None.  Returns
    (re, im), each [..., 40, T / 32], contiguous."""
    global fir_bank_launches
    if hp2.device.type == "cpu":
        return fir_bank_plain(hp2, weight, history)
    lead, t = hp2.shape[:-1], hp2.shape[-1]
    if t % SUB:
        raise ValueError(f"fir_bank: {t} samples, not a multiple of {SUB}")
    x = hp2.reshape(-1, t).contiguous()
    operands = {}
    hist = None
    if history is not None:
        if history.shape[:-1] != lead or history.shape[-1] < FIR_PAD:
            raise ValueError(f"fir_bank: history {tuple(history.shape)} "
                             f"for hp2 {tuple(hp2.shape)}")
        hist = operands["history"] = history[..., -FIR_PAD:].to(
            hp2.dtype).reshape(-1, FIR_PAD).contiguous()
    _build.require("fir_bank", x, **operands)
    packed = packed_weight(plan, x.dtype, x.device)
    rows, n = x.shape[0], t // SUB
    re = x.new_empty((*lead, BANDS, n))
    im = x.new_empty((*lead, BANDS, n))
    if rows == 0 or n == 0:
        return re, im
    tiles, parts, _, strip_rows, _ = launch_grid(
        rows, t, x.dtype, plan, sm_count(x.device.index))
    _build.launch("fir_bank", x, x.data_ptr(),
                  None if hist is None else hist.data_ptr(),
                  packed.data_ptr(), re.data_ptr(), im.data_ptr(), rows, t,
                  tiles, strip_rows, plan.tables[parts - 1].ctypes.data,
                  plan.groups)
    fir_bank_launches += 1
    return re, im
