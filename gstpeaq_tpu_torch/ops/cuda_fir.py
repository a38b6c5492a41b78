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
close to its longest band's), rounds each union out to ALIGN taps and
packs each group's weights [K_g, 8] contiguously, which the float kernel
reads group by group.  It also splits the groups into 1..MAX_PARTS parts
of near-equal covering work: `launch_grid` gives a small grid (one pair, a
chunk step) one block per part of each tile, so that every SM gets work,
choosing the parts that finish soonest on the card's SMs.  The double
kernel walks taps outer and
every covering group inner: `fir_layout` (cached) rounds the windows
out to K_ALIGN taps (one k-step of its mma), cuts each part into passes
of at most OPEN groups (the accumulators a thread holds) whose windows
nest, each pass into segments of at most CHUNK taps over which the
same groups cover every tap, and packs the weights k-major, for each
k-step of a pass the fragments of the groups that cover it, one after
another, so that a segment is one contiguous copy.  The grid and the
shared-memory strip are computed on the host in Python ints, so the
one-hour one shot's 64-bit offsets are plain to check.

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
# the double kernel's mma tiles), the taps a group's window is rounded out
# to (the float kernel's; the double kernel's k-step, 8 taps: one
# m16n8k8), the taps of weights a block stages at once, the groups a
# double pass holds open, and per dtype the instants of a block and the
# skew of its strip (values added every 32 samples)
GROUP_BANDS = 4
ALIGN = 4
K_ALIGN = 8
CHUNK = 32
OPEN = 4
TILE_INSTANTS = {torch.float32: 512, torch.float64: 256}
SKEW = {torch.float32: 1, torch.float64: 4}
MAX_PARTS = 4
MAX_PASSES = 16
MAX_SEGMENTS = 256
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
    hi [G]: each group's union, rounded out to ALIGN; offset [G]: the
    first of the group's K_g x 8 values in `weights` (float64, [K_g, 8]
    row-major, channels 4g..4g+3 real then imaginary; the float kernel's
    layout); jbase: min(lo) rounded down to 32; tables[p - 1]: the int64
    table the float kernel takes for p parts, [jbase, lo, hi, offset, p,
    order, part_start] with the groups in part order and where each part
    starts.  Its arrays are read-only: the plan is cached, and compared
    and hashed as an object (fir_layout's cache key)."""
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

    def group_weights(self, g: int) -> np.ndarray:
        """Group g's weights [K_g, 8], taps lo[g]..hi[g] - 1."""
        k = self.hi[g] - self.lo[g]
        return self.weights[self.offset[g]:self.offset[g] + 8 * k].reshape(
            k, 8)


def split(work: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """The groups split into p parts of near-equal work (taps each):
    longest first, each to the part with the least so far (the lowest
    such part on a tie), each part's groups in band order.  Returns the
    groups in part order and where each part starts.  The largest part
    exceeds the smallest by at most the largest group's work."""
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
            g_lo = min(lo_c[c] for c in live) // ALIGN * ALIGN
            g_hi = -(-max(hi_c[c] for c in live) // ALIGN) * ALIGN
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


@dataclasses.dataclass(frozen=True, eq=False)
class FirLayout:
    """What F1 reads in float64: lo, hi [G], the plan's windows rounded
    out to K_ALIGN; per count of parts p: passes[p - 1],
    each pass's groups in pass order; segments[p - 1], int64 [S, 5] rows
    (j0, taps, cover, end, weights) in the order the parts' blocks walk
    them; tables[p - 1], the int64 table the kernel takes: [jbase, lo, hi,
    p, passes, S, order, pass_start, part_pass, part_seg, seg_x, seg_y];
    and the packed weights of every split.  A part's groups, widest
    window first, go into passes of at most OPEN groups whose windows
    nest, so that the groups covering a tap are the pass's first `cover`.
    A segment is a run of at most CHUNK taps of its pass from j0 over
    which `cover` is constant; `end` marks a pass's last.  Its weights
    start at `weights`: for each k-step of K_ALIGN taps the fragments of
    its `cover` groups in pass order, 8 taps x 8 channels in mma B order
    (value 32 h + l = tap 4 h + l % 4 of channel l // 4).  seg_x packs
    j0 | taps << 12 | cover << 20 | end << 28; seg_y is `weights`."""
    lo: np.ndarray
    hi: np.ndarray
    packed: np.ndarray
    passes: tuple
    segments: tuple
    tables: tuple


def _fragment(w: np.ndarray) -> np.ndarray:
    """One k-step's weights [8 taps, 8] as the double kernel reads them."""
    lane = np.arange(32)
    return np.concatenate([w[4 * h + lane % 4, lane // 4] for h in (0, 1)])


def _passes(lo: np.ndarray, hi: np.ndarray, groups, open_: int) -> list:
    """A part's groups in passes: widest window first, each into the first
    pass with room whose last window holds it, else a pass of its own."""
    passes = []
    for g in sorted(groups, key=lambda g: (lo[g] - hi[g], lo[g], g)):
        for gs in passes:
            h = gs[-1]
            if len(gs) < open_ and lo[h] <= lo[g] and hi[g] <= hi[h]:
                gs.append(int(g))
                break
        else:
            passes.append([int(g)])
    return passes


def _segments(lo: np.ndarray, hi: np.ndarray, gs: list,
              chunk: int) -> list:
    """A pass's segments (j0, taps, cover, end) of at most `chunk` taps
    over the union of its nested windows, the widest's."""
    start, stop = int(lo[gs[0]]), int(hi[gs[0]])
    bounds = sorted({start, stop, *(int(lo[g]) for g in gs),
                     *(int(hi[g]) for g in gs)})
    out = []
    for a, b in zip(bounds, bounds[1:]):
        cover = sum(1 for g in gs if lo[g] <= a < hi[g])
        for j in range(a, b, chunk):
            out.append([j, min(chunk, b - j), cover, 0])
    if not out:
        out.append([start, 0, 0, 0])
    out[-1][3] = 1
    return out


@functools.lru_cache(maxsize=8)
def fir_layout(plan: FirPlan) -> FirLayout:
    """The passes, segments, tables and k-major packed weights of every
    split of the plan, for F1 in float64."""
    lo = plan.lo // K_ALIGN * K_ALIGN
    hi = -(-plan.hi // K_ALIGN) * K_ALIGN
    weights = []                   # each group's [K_g, 8] over [lo, hi)
    for g in range(plan.groups):
        w = np.zeros((hi[g] - lo[g], 2 * GROUP_BANDS))
        w[plan.lo[g] - lo[g]:plan.hi[g] - lo[g]] = plan.group_weights(g)
        weights.append(w)
    chunks, all_passes, all_segments, tables = [], [], [], []
    total = 0
    for p in range(1, len(plan.tables) + 1):
        order, start = plan.parts(p)
        passes, part_pass, part_seg, segments = [], [0], [0], []
        for a, b in zip(start, start[1:]):
            for gs in _passes(lo, hi, order[a:b], OPEN):
                passes.append(gs)
                for j0, taps, cover, end in _segments(lo, hi, gs, CHUNK):
                    segments.append((j0, taps, cover, end, total))
                    for j in range(j0, j0 + taps, K_ALIGN):
                        for g in gs[:cover]:
                            k = j - lo[g]
                            frag = _fragment(weights[g][k:k + K_ALIGN])
                            chunks.append(frag)
                            total += frag.size
            part_pass.append(len(passes))
            part_seg.append(len(segments))
        seg = np.array(segments, np.int64)
        seg_x = seg[:, 0] | seg[:, 1] << 12 | seg[:, 2] << 20 | seg[:, 3] << 28
        tables.append(np.concatenate([
            [plan.jbase], lo, hi, [p, len(passes), len(seg)],
            np.concatenate(passes), np.cumsum([0] + [len(g) for g in passes]),
            part_pass, part_seg, seg_x, seg[:, 4]]).astype(np.int64))
        all_passes.append(tuple(tuple(gs) for gs in passes))
        all_segments.append(seg)
    out = FirLayout(lo, hi, np.concatenate(chunks), tuple(all_passes),
                    tuple(all_segments), tuple(tables))
    for a in (out.lo, out.hi, out.packed, *out.segments, *out.tables):
        a.flags.writeable = False
    return out


def launch_grid(rows: int, t: int, dtype, plan: FirPlan,
                sms: int) -> tuple[int, int, int, int, int]:
    """F1's launch for `rows` signal rows of t samples on a card of `sms`
    SMs, in Python ints: (tiles a row, parts, blocks = rows x tiles x
    parts, rows of 32 samples a block's strip holds, its shared-memory
    bytes: two buffers of weights and the strip).  Block b takes part
    b % parts of the groups at row (b // parts) // tiles and instants from
    TILE_INSTANTS ((b // parts) % tiles); its strip covers xs from
    32 i0 + jbase through the last tap of its last instant.  A grid that
    fills the blocks the SMs hold at once is not split; a smaller one takes
    the parts whose blocks finish soonest: the waves of blocks times the
    largest part's share of the covering work (the fewest parts on a
    tie), in float64 among the splits whose passes and segments the
    kernel's plan holds (MAX_PASSES, MAX_SEGMENTS); a plan whose one part
    does not fit raises."""
    n_inst = t // SUB
    tile = TILE_INSTANTS[dtype]
    tiles = -(-n_inst // tile)
    double = dtype == torch.float64
    hi = fir_layout(plan).hi if double else plan.hi
    span = SUB * (tile - 1) + int(hi.max()) - plan.jbase
    strip_rows = -(-span // SUB)
    item = torch.empty((), dtype=dtype).element_size()
    weights = CHUNK * 2 * GROUP_BANDS * (OPEN if double else 1)
    smem = (2 * weights + strip_rows * (SUB + SKEW[dtype])) * item
    slots = sms * (SM_SHARED // (smem + BLOCK_RESERVED))
    work = plan.hi - plan.lo

    def finish(p):
        order, start = plan.parts(p)
        largest = max(work[order[start[q]:start[q + 1]]].sum()
                      for q in range(p))
        return -(-rows * tiles * p // slots) * largest / max(work.sum(), 1)

    fits = range(1, len(plan.tables) + 1)
    if double:
        layout = fir_layout(plan)
        fits = [p for p in fits if len(layout.passes[p - 1]) <= MAX_PASSES
                and len(layout.segments[p - 1]) <= MAX_SEGMENTS]
    if 1 not in fits:
        raise ValueError(f"fir_bank: the plan's {len(layout.passes[0])} "
                         f"passes in {len(layout.segments[0])} segments "
                         f"exceed the kernel's {MAX_PASSES} / "
                         f"{MAX_SEGMENTS}")
    parts = 1 if rows * tiles >= slots else min(
        fits, key=lambda p: (finish(p), p))
    return tiles, parts, rows * tiles * parts, strip_rows, smem


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=16)
def packed_weight(plan: FirPlan, dtype, device) -> torch.Tensor:
    """The weights F1 reads in `dtype`, cached per (plan, dtype, device),
    so that the layout always matches the dtype it is read in: in float64
    fir_layout(plan).packed (k-major), in float32 plan.weights (group by
    group).  The tensor is shared: callers do not write to it."""
    w = fir_layout(plan).packed if dtype == torch.float64 else plan.weights
    return torch.tensor(w, dtype=dtype, device=device)


def kernel_table(plan: FirPlan, dtype, parts: int) -> np.ndarray:
    """The int64 table F1 takes in `dtype` for the split into `parts`
    parts: fir_layout(plan).tables in float64, plan.tables in float32."""
    tables = fir_layout(plan).tables if dtype == torch.float64 \
        else plan.tables
    return tables[parts - 1]


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
    table = kernel_table(plan, x.dtype, parts)
    _build.launch("fir_bank", x, x.data_ptr(),
                  None if hist is None else hist.data_ptr(),
                  packed.data_ptr(), re.data_ptr(), im.data_ptr(), rows, t,
                  tiles, strip_rows, table.ctypes.data, plan.groups)
    fir_bank_launches += 1
    return re, im


# the f64 mma shapes csrc/fir_bank.cu's mma_rate_kernel times: id ->
# (name, multiply-adds a warp's instruction)
MMA_SHAPES = {0: ("m8n8k4", 8 * 8 * 4), 1: ("m16n8k4", 16 * 8 * 4),
              2: ("m16n8k8", 16 * 8 * 8), 3: ("m16n8k16", 16 * 8 * 16)}


def mma_rate(shape: int, iters: int, out: torch.Tensor) -> None:
    """Launch the FP64 tensor cores' rate probe of mma shape `shape`
    (MMA_SHAPES) on `out`'s card: out.numel() / 256 blocks of 8 warps,
    each running `iters` rounds of 4 independent mma.sync; out: float64
    [blocks x 256], contiguous, takes each thread's sums.  Not counted:
    no path of the port runs it (chip_smoke.py phase 7 does)."""
    _build.require("fir_mma_rate", out)
    if out.dtype != torch.float64 or out.numel() % 256:
        raise ValueError("mma_rate: out must be float64, 256 a block")
    lib = _build.library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.peaq_fir_mma_rate(shape, iters, out.numel() // 256,
                                           out.data_ptr(), stream),
                     "fir_mma_rate")
