"""G1 `frame_gate` (ops/cuda_gate.py) and S1's `halves` on the CPU, where the
wrappers take their plain versions.

The port's gate is held bit for bit to the JAX package's
gstpeaq_tpu/ops/framing.py::above_threshold_signal in both frame forms
(FFT: frame 2048, hop 1024; FB: frame = hop = 192) and both dtypes, on
inputs made with numpy from a seed that hold the rows the card is checked
on: windows one ulp either side of the threshold, windows across a hop
boundary, windows at frame-local i < 5 that must not count, one channel
crossing alone, a NaN sample, mono and 3 channels, a view.  The kernel's
walk (csrc/gate.cu) is re-enacted in numpy from the source's constants and
the host planner's launch (cuda_gate.gate_plan): the spans, the staged
tiles and their halos, each thread's run of windows, the segmented
reduction of each hop's maxima and the frames each block owns, one hop
past its span in the FFT form: every frame written once, every covered
sample read once besides a halo and that hop, and the frame bits equal
the plain version's, also at every hop size the wrapper takes.  The
planner covers every frame of every pair once.  S1's plain halves give
the totalsnr energies of the formula they replaced and of JAX's, and
their sums are steady across threads.
"""

import re

from hypothesis import given
from hypothesis import settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu.ops import framing as JFR
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch import earparams as EP
from gstpeaq_tpu_torch.models import basic
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_gate
from gstpeaq_tpu_torch.ops import cuda_spectral
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.ops import framing
from gstpeaq_tpu_torch.parallel import stream as PS

TH = C.FRAME_THRESHOLD
# (frame, hop, frames): the FFT form over 12 of G1's tiles of 2 hops, the
# FB form over 4 of 10
FORMS = {"fft": (C.FFT_FRAMESIZE, C.FFT_STEPSIZE, 23),
         "fb": (C.FB_FRAMESIZE, C.FB_FRAMESIZE, 40)}
DTYPES = (np.float32, np.float64)
NUMPY = {torch.float32: np.float32, torch.float64: np.float64}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def hops_of(form: str) -> tuple[int, int, int, int]:
    """frame, hop, frames and the hop count the frames cover."""
    frame, hop, n = FORMS[form]
    return frame, hop, n, n + (frame == 2 * hop)


def gate_rows(form: str, dtype, channels: int = 2, seed: int = 5):
    """Signals [3, CH, T] of `dtype`, T the samples the frames cover, and
    the bits that pair 1's frames must take.  Pair 0: noise below the
    threshold with loud bursts, some in one channel alone.  Pair 1:
    silence holding one edge case every other hop (so that an FFT frame,
    which also reads the next hop, holds one): a window exactly at the
    threshold, one ulp above and one below (a lone sample, then five
    samples whose rounded sum lands there), a loud sample 2 before a hop's
    end (its windows straddle the boundary), five samples across a hop
    boundary whose one window that holds them all, at i = 1025 of the FFT
    frame and i = 1 of the FB frame, sums to the threshold, one at
    frame-local 0 of a
    tile's first hop (its windows end at i < 5 of that frame: they count
    only for the FFT frame before, in the tile before) and one at
    frame-local 1 (its window at i = 5 counts), and a NaN beside a loud
    sample (its frame and the one before stay below).  Pair 2: pair 0
    negated, its first channel silent."""
    frame, hop, n, n_hops = hops_of(form)
    rng = np.random.default_rng(seed)
    t = n_hops * hop
    x = (rng.standard_normal((3, channels, t)) * 2e-4).astype(dtype)
    for h in rng.choice(n_hops, n_hops // 3, replace=False):
        c = rng.integers(channels) if h % 2 else slice(None)
        x[0, c, h * hop + rng.integers(hop)] = dtype(0.02)
    x[1] = 0.0
    th = dtype(TH)
    up, down = np.nextafter(th, dtype(1)), np.nextafter(th, dtype(0))

    def five(target):
        # five samples whose window sum, rounded as the gate rounds it,
        # is `target`; their later windows hold fewer of them
        v = rng.uniform(0.1, 0.2, 4).astype(dtype) * th
        s = ((v[0] + v[1]) + v[2]) + v[3]
        last = dtype(target - s)
        while ((s + last) < target):
            last = np.nextafter(last, dtype(1))
        while ((s + last) > target):
            last = np.nextafter(last, dtype(0))
        return [last, v[3], v[2], v[1], v[0]]   # a(j-4) .. a(j)

    cases = [([th], True), ([up], True), ([down], False),
             (five(th), True), (five(up), True), (five(down), False)]
    expect = {}
    for k, (samples, bit) in enumerate(cases):
        start = 2 * k * hop + hop // 2
        x[1, -1, start:start + len(samples)] = samples
        expect[2 * k] = bit
    h = 2 * len(cases)
    loud = dtype(0.05)
    tile = tile_of(hop, dtype)
    edge = -(-(h + 4) // tile) * tile
    x[1, 0, (h + 1) * hop - 2] = loud                 # across a boundary
    x[1, 0, (h + 3) * hop - 3:(h + 3) * hop + 2] = five(th)
    x[1, 0, edge * hop] = loud                        # i = 0, a tile edge
    x[1, 0, (edge + 2) * hop + 1] = loud              # i = 1
    x[1, 0, (n_hops - 2) * hop + 40] = loud           # a NaN beside it
    x[1, 0, (n_hops - 2) * hop + 42] = np.nan
    assert edge + 2 < n_hops - 2
    fft = frame == 2 * hop
    expect.update({h - 1: fft, h: True, h + 1: False, h + 2: fft,
                   h + 3: False,
                   edge - 1: fft, edge: False, edge + 2: True,
                   n_hops - 3: False, n_hops - 2: False})
    x[2] = -x[0]
    x[2, 0] = 0.0
    return x, expect


def jax_gate(x: np.ndarray, n: int, frame: int, hop: int) -> np.ndarray:
    fn = jax.jit(JFR.above_threshold_signal,
                 static_argnames=("n_frames", "frame_size", "step_size"))
    return np.stack([np.asarray(fn(jnp.asarray(row), n_frames=n,
                                   frame_size=frame, step_size=hop))
                     for row in x])


@pytest.mark.parametrize("channels", [2, 1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", list(FORMS))
def test_gate_matches_jax_bit_for_bit(form, dtype, channels):
    """The port's gate on the CPU (cuda_gate.frame_gate, the plain version)
    equals JAX's, frame for frame, on the edge rows; the rows make both
    outcomes at the threshold, and the NaN clears its frame."""
    frame, hop, n, _ = hops_of(form)
    x, expect = gate_rows(form, dtype, channels)
    want = jax_gate(x, n, frame, hop)
    got = cuda_gate.frame_gate(torch.from_numpy(x), n, frame, hop)
    assert got.dtype == torch.bool and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert {f: bool(want[1, f]) for f in expect} == expect
    assert 0 < want[0].sum() < n


@pytest.mark.parametrize("form", list(FORMS))
def test_gate_takes_the_spectrum_dtype(form):
    """frame_gate(sig, ..., dtype) is the plain gate of sig cast to dtype:
    float64 samples gated in float32 round first, as the pipelines' cast
    did, and a view gives what its copy gives."""
    frame, hop, n, n_hops = hops_of(form)
    x, _ = gate_rows(form, np.float64)
    wide = torch.from_numpy(np.concatenate([x, x[..., :hop]], -1))
    view = wide[..., :n_hops * hop]
    assert not view.is_contiguous()
    for dtype in (torch.float32, torch.float64):
        want = jax_gate(x.astype(NUMPY[dtype]), n, frame, hop)
        got = cuda_gate.frame_gate(view, n, frame, hop, dtype)
        np.testing.assert_array_equal(got.numpy(), want)
        plain = cuda_gate.frame_gate_plain(view, n, frame, hop, dtype)
        np.testing.assert_array_equal(plain.numpy(), want)


def source_constants() -> dict:
    text = (_build.CSRC / "gate.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+)",
                                text)[1])
            for name in ("kThreads", "kResident", "kStages", "kTileBytes",
                         "kMaxTileHops", "kMaxStep", "kHalo", "kTailFrom")}


def tile_of(hop: int, dtype) -> int:
    """G1's tile in hops of `hop` samples of numpy type `dtype`: whole
    hops of at most kTileBytes, at most kMaxTileHops of them, at least
    one."""
    k = source_constants()
    return max(1, min(k["kMaxTileHops"],
                      k["kTileBytes"] // np.dtype(dtype).itemsize // hop))


def test_planner_constants_are_the_sources():
    """cuda_gate's copies of gate.cu's constants equal the source's, and
    the planner's tiles are tile_of's."""
    k = source_constants()
    assert {"kThreads": cuda_gate.THREADS, "kResident": cuda_gate.RESIDENT,
            "kStages": cuda_gate.STAGES,
            "kTileBytes": cuda_gate.TILE_BYTES,
            "kMaxTileHops": cuda_gate.MAX_TILE_HOPS,
            "kMaxStep": cuda_gate.MAX_STEP, "kHalo": cuda_gate.HALO,
            "kTailFrom": 5} == k
    for hop in (6, 7, 192, 1024, 2048, 2049, 4096):
        for dtype in DTYPES:
            assert cuda_gate.gate_plan(
                1, 2, 9, hop, True, TORCH[dtype], 132).tile_hops == tile_of(
                    hop, dtype)


def warp_partials(tail, head, hops, q, threads):
    """gate.cu's segmented reduction of one tile's run maxima: the shuffle
    rounds within each warp (lane l takes lane l + off's maxima where both
    lanes' runs lie in one hop), then the partial each hop's first lane in
    a warp writes.  Returns the partials' tail and full maxima by thread
    (-inf where no partial is written)."""
    idle = 1 << 30
    tid = np.arange(threads)
    lane = tid % 32
    hop_of = np.where(tid < hops * q, tid // q, idle)
    first = (lane == 0) | (hop_of != np.roll(hop_of, 1))
    tl, fl = tail.copy(), np.maximum(tail, head)
    off = 1
    while off < 32:
        src = np.where(lane + off < 32, tid + off, tid)
        same = hop_of[src] == hop_of
        tl = np.where(same, np.maximum(tl[src], tl), tl)
        fl = np.where(same, np.maximum(fl[src], fl), fl)
        off *= 2
    keep = first & (hop_of != idle)
    return np.where(keep, tl, -np.inf), np.where(keep, fl, -np.inf)


def kernel_walk(x: np.ndarray, n: int, frame: int, hop: int, dtype,
                plan) -> tuple:
    """G1 re-enacted from gate.cu's constants under `plan` (gate_plan's):
    one block a (pair, span of plan.span frames), reading its span's hops
    (one more in the FFT form) in tiles of plan.tile_hops hops, channel by
    channel through a stage of plan.stage samples (the tile at kHalo, the
    kHalo samples before it, none before the signal's first: the windows
    there take them as 0); each thread's run of plan.run positions inside
    one hop, its windows summed in the kernel's order in `dtype`, the
    maxima of their numbers at offsets >= kTailFrom and below and whether
    a NaN lies among the samples they read (offsets 1 .. hop - 1 for the
    tail windows, -4 .. 4 for the head; a run counts its own samples and
    those of its halo before the hop: the float samples' bookkeeping,
    whose maxima the double samples' max_nan equals), over the tile's
    channels;
    the warps' segmented reduction into partials and each hop's bits from
    its partials; frame h - 1 set by hop h of its span (FFT: the tail bit
    before it, carried across tiles) or frame h (FB).  Returns the bits,
    each frame's writes and each sample's reads, the reads outside the
    main pass allowed (each tile's halo and the hop past each span) and
    the tiles walked."""
    k = source_constants()
    threads, halo, tail_from = k["kThreads"], k["kHalo"], k["kTailFrom"]
    fft = int(frame == 2 * hop)
    pairs, channels, t = x.shape
    q, run, th = plan.runs_per_hop, plan.run, dtype(TH)
    assert plan.tile_hops * q <= threads
    out = np.full((pairs, n), -1, np.int8)          # no fill: -1 unwritten
    writes = np.zeros((pairs, n), int)
    reads = np.zeros(x.shape, int)
    again = np.zeros(t, bool)
    starts = np.arange(0, hop, run)                  # a hop's runs' offsets
    assert len(starts) == q
    offsets = np.arange(hop)
    tiles_walked = 0
    for p in range(pairs):
        for si in range(plan.spans):
            f0 = si * plan.span
            f1 = min(f0 + plan.span, n)
            assert f0 < f1                            # no span is empty
            h_end = f1 + fft
            if fft and f1 < n:
                again[f1 * hop:(f1 + 1) * hop] = True
            carry = False
            for h0 in range(f0, h_end, plan.tile_hops):
                tiles_walked += 1
                hops = min(plan.tile_hops, h_end - h0)
                j0, size = h0 * hop, hops * hop
                lead = halo if j0 > 0 else 0
                again[j0 - lead:j0] = True
                tail = np.full(threads, -np.inf, dtype)
                head = tail.copy()
                nan_tail = np.zeros(threads, bool)
                nan_head = nan_tail.copy()
                for c in range(channels):
                    assert halo + size <= plan.stage
                    stage = np.full(plan.stage, np.nan, x.dtype)   # stale
                    stage[halo - lead:halo + size] = x[p, c,
                                                       j0 - lead:j0 + size]
                    reads[p, c, j0 - lead:j0 + size] += 1
                    if lead == 0:
                        stage[:halo] = 0
                    a = np.abs(stage.astype(dtype))
                    i = halo + np.arange(size)
                    w = a[i]
                    for back in range(1, halo + 1):
                        w = w + a[i - back]
                    w = np.where(np.isnan(w), -np.inf, w).reshape(hops, hop)
                    late = offsets >= tail_from
                    runs_tail = np.maximum.reduceat(
                        np.where(late, w, -np.inf), starts, axis=1)
                    runs_head = np.maximum.reduceat(
                        np.where(late, -np.inf, w), starts, axis=1)
                    r = hops * q
                    tail[:r] = np.maximum(runs_tail.reshape(-1), tail[:r])
                    head[:r] = np.maximum(runs_head.reshape(-1), head[:r])
                    nan = np.isnan(stage)
                    for t_run in range(r):
                        hl, k_run = divmod(t_run, q)
                        off0 = k_run * run
                        base = halo + hl * hop
                        own = nan[base + off0:base + min(off0 + run, hop)]
                        o = off0 + np.arange(own.size)
                        nan_tail[t_run] |= own[o >= 1].any()
                        nan_head[t_run] |= own[o < tail_from].any()
                        if off0 < tail_from:
                            nan_head[t_run] |= nan[base + off0 - halo:
                                                   base].any()
                tail = np.where(nan_tail, np.nan, tail).astype(dtype)
                head = np.where(nan_head, np.nan, head).astype(dtype)
                part_t, part_f = warp_partials(tail, head, hops, q, threads)
                bits = []
                for lane in range(hops):
                    pieces = [lane * q]
                    while (pieces[-1] // 32 + 1) * 32 < (lane + 1) * q:
                        pieces.append((pieces[-1] // 32 + 1) * 32)
                    bits.append((np.max(part_t[pieces]) >= th,
                                 np.max(part_f[pieces]) >= th))
                for lane, (tb, fb) in enumerate(bits):
                    h = h0 + lane
                    if fft:
                        prev = carry if lane == 0 else bits[lane - 1][0]
                        if h - 1 >= f0:
                            out[p, h - 1] = prev or fb
                            writes[p, h - 1] += 1
                    else:
                        out[p, h] = tb
                        writes[p, h] += 1
                carry = bits[-1][0]
    return out, writes, reads, again, tiles_walked


def walk_plans(pairs: int, channels: int, n: int, frame: int, hop: int,
               dtype) -> list:
    """The planner's launches at 1, 2 and 132 SMs, and one with spans of
    half the hop before the last (the edge rows' NaN-and-loud hop: a span
    starts there, and the span before reads it as its one more hop)."""
    fft = frame == 2 * hop
    plans = [cuda_gate.gate_plan(pairs, channels, n, hop, fft, dtype, sms)
             for sms in (1, 2, 132)]
    span = max(1, (n + fft - 2) // 2)
    spans = -(-n // span)
    return plans + [plans[-1]._replace(span=span, spans=spans,
                                       grid=pairs * spans)]


def check_walk(x: np.ndarray, n: int, frame: int, hop: int, dtype,
               plan) -> np.ndarray:
    """kernel_walk under `plan`: each frame written once, each covered
    sample read at least once, again only in a halo or the hop past a
    span, nothing past the covered samples.  Returns the bits."""
    got, writes, reads, again, tiles = kernel_walk(x, n, frame, hop, dtype,
                                                   plan)
    assert (writes == 1).all() and (got >= 0).all()
    covered = (n + (frame == 2 * hop)) * hop
    assert (reads[..., :covered] >= 1).all()
    assert (reads[..., covered:] == 0).all()
    assert (reads[..., ~again] <= 1).all()
    extra = reads.sum() - reads[..., :covered].size
    halos = source_constants()["kHalo"] * x.shape[1] * tiles
    past = (frame == 2 * hop) * hop * x.shape[1] * x.shape[0] * (
        plan.spans - 1)
    assert extra <= halos + past
    return got.astype(bool)


@pytest.mark.parametrize("channels", [2, 1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", list(FORMS))
def test_kernel_walk_reads_once_and_equals_the_plain_gate(form, dtype,
                                                          channels):
    """G1's walk re-enacted from gate.cu's constants and gate_plan's
    launches (several spans a pair, a span starting at the NaN-and-loud
    hop), on the edge rows: the plain gate's bits (a sample at a tile's
    first hop sets a frame of the tile before), each frame written once
    on an output with no fill, each covered sample read once besides a
    halo and the hop past a span, nothing past them."""
    frame, hop, n, n_hops = hops_of(form)
    x, _ = gate_rows(form, dtype, channels)
    want = cuda_gate.frame_gate_plain(torch.from_numpy(x), n, frame,
                                      hop).numpy()
    plans = walk_plans(3, channels, n, frame, hop, torch.from_numpy(x).dtype)
    assert max(p.spans for p in plans) > 1
    assert plans[0].tile_hops < n_hops                    # two tiles
    for plan in plans:
        np.testing.assert_array_equal(
            check_walk(x, n, frame, hop, dtype, plan), want)


@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("hop", [6, 7, 13, 100, 191, 1000, 2049, 4096])
def test_kernel_walk_at_every_hop_size(hop, fft):
    """The walk at hops the wrapper takes beside the two forms' (6 to
    4,096 samples: runs that do not divide a hop, tiles of one hop or of
    32, idle threads, the scalar loads' odd hops), float32 samples gated
    in float64 and float32, on rows with loud bursts and a NaN: the plain
    gate's bits, each frame written once."""
    rng = np.random.default_rng(hop)
    frame = 2 * hop if fft else hop
    n = max(3, min(40, 20000 // hop))
    x = (rng.standard_normal((2, 2, (n + fft) * hop + 3)) * 2e-4).astype(
        np.float32)
    loud = rng.choice(x.size, max(4, (n + fft) // 2), replace=False)
    x.reshape(-1)[loud] = 0.02
    # NaNs at hop offsets -1, 0, 1, 4, 5 and the last, each in a hop with a
    # loud sample in its tail, so that a NaN missed would set a bit
    for k, o in enumerate((-1, 0, 1, 4, 5, hop - 1)):
        start = (1 + 3 * k % max(1, n + fft - 2)) * hop
        loud = hop - 1 if o != hop - 1 else 5
        if loud != o:
            x[k % 2, 1 - k % 2, start + loud] = 0.02
        x[k % 2, k % 2, start + o] = np.nan
    for dtype in DTYPES:
        want = cuda_gate.frame_gate_plain(torch.from_numpy(x), n, frame,
                                          hop, TORCH[dtype]).numpy()
        assert 0 < want.sum() < want.size
        for plan in walk_plans(2, 2, n, frame, hop, torch.float32):
            np.testing.assert_array_equal(
                check_walk(x, n, frame, hop, dtype, plan), want)


@settings(max_examples=300, deadline=None)
@given(pairs=st.integers(1, 70), channels=st.integers(1, 3),
       n_frames=st.integers(0, 3000), fft=st.booleans(),
       in_dtype=st.sampled_from([torch.float32, torch.float64]),
       sms=st.integers(1, 132))
def test_gate_plan_covers_every_frame_once(pairs, channels, n_frames, fft,
                                           in_dtype, sms):
    """gate_plan puts every frame of every pair in exactly one span, no
    span empty, one block a span within a grid of max(pairs, RESIDENT x
    SMs) blocks; a hop's runs cover it, one thread each, within a block;
    a stage holds a tile and its halo in whole 16-byte vectors, and the
    block's shared memory fits an SM's 227 KB."""
    hop = C.FFT_STEPSIZE if fft else C.FB_FRAMESIZE
    plan = cuda_gate.gate_plan(pairs, channels, n_frames, hop, fft,
                               in_dtype, sms)
    size = torch.empty((), dtype=in_dtype).element_size()
    assert plan.tile_hops * plan.runs_per_hop <= cuda_gate.THREADS
    assert (plan.runs_per_hop - 1) * plan.run < hop <= (
        plan.runs_per_hop * plan.run)
    assert plan.run % (16 // size) == 0
    assert plan.stage >= plan.tile_hops * hop + cuda_gate.HALO
    assert plan.stage * size % 16 == 0 and plan.shared <= 232448
    if n_frames == 0:
        assert plan.grid == 0
        return
    covered = np.zeros(n_frames, int)
    for si in range(plan.spans):
        part = covered[si * plan.span:(si + 1) * plan.span]
        assert part.size > 0
        part += 1
    assert (covered == 1).all()
    assert plan.grid == pairs * plan.spans
    assert plan.grid <= max(pairs, cuda_gate.RESIDENT * sms)


@pytest.mark.parametrize("label, pairs, n_frames, hop, fft", [
    ("basic FFT", 64, 512, C.FFT_STEPSIZE, True),
    ("advanced FFT", 32, 512, C.FFT_STEPSIZE, True),
    ("advanced FB", 32, 2560, C.FB_FRAMESIZE, False)])
def test_gate_plan_at_the_batch_shapes(label, pairs, n_frames, hop, fft):
    """At the batch shapes on an H100's 132 SMs, with float32 samples:
    one wave of blocks (at most RESIDENT an SM) and the FFT form's one hop
    past each span at most 3% of the samples read; 16 KB tiles of whole
    hops (4,096 float samples), 16-sample runs."""
    plan = cuda_gate.gate_plan(pairs, 2, n_frames, hop, fft, torch.float32,
                               132)
    assert 0.9 * 132 * cuda_gate.RESIDENT <= plan.grid <= (
        132 * cuda_gate.RESIDENT)
    assert int(fft) / (plan.span + int(fft)) <= 0.03
    assert plan.run == 16 and plan.tile_hops == 4096 // hop


def test_cpu_tensor_takes_the_plain_gate_and_others_raise(monkeypatch):
    """A CPU tensor runs the plain gate without nvcc and launches nothing;
    a tensor on neither the CPU nor a card is refused before any build."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(cuda_gate, "frame_gate_launches", 0)
    frame, hop, n, _ = hops_of("fft")
    x = torch.from_numpy(gate_rows("fft", np.float64)[0])
    got = cuda_gate.frame_gate(x, n, frame, hop, torch.float32)
    want = framing.above_threshold_signal(x.float(), n, frame, hop)
    assert torch.equal(got, want) and cuda_gate.frame_gate_launches == 0
    meta = torch.ones(2, 2, 8 * hop, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gate.frame_gate(meta, 7, frame, hop)


def test_gate_entries_are_bound():
    """The C entries of csrc/gate.cu have their ctypes signatures, one
    argument type a parameter."""
    text = (_build.CSRC / "gate.cu").read_text()
    for suffix in ("f32", "f64"):
        name = f"peaq_frame_gate_{suffix}"
        params = re.search(rf"int {name}\(([^)]*)\)", text)[1]
        assert len(_build.SIGNATURES[name]) == params.count(",") + 1


def counted_gate(monkeypatch) -> list:
    """Spy on cuda_gate.frame_gate: each call's frame size."""
    calls = []
    gate = cuda_gate.frame_gate

    def spy(sig, n_frames, frame_size, step_size, dtype=None):
        calls.append(frame_size)
        return gate(sig, n_frames, frame_size, step_size, dtype)
    monkeypatch.setattr(cuda_gate, "frame_gate", spy)
    return calls


def test_every_gate_site_calls_frame_gate(monkeypatch):
    """The pipelines and the chunk steps gate through frame_gate, never
    the plain gate directly: once a basic call, twice an advanced one (FFT
    then FB), once in each chunk step."""
    calls = counted_gate(monkeypatch)
    rng = np.random.default_rng(8)
    ref = rng.standard_normal((40 * 1024, 2)).astype(np.float32) * 0.1
    test = ref + 0.01 * rng.standard_normal(ref.shape).astype(np.float32)
    api.peaq(ref, test, device="cpu")
    assert calls == [C.FFT_FRAMESIZE]
    calls.clear()
    api.peaq(ref, test, advanced=True, device="cpu")
    assert calls == [C.FFT_FRAMESIZE, C.FB_FRAMESIZE]
    chunk = 4
    for advanced in (False, True):
        calls.clear()
        pool = PS.PeaqStreamPool(1, chunk_frames=chunk, advanced=advanced,
                                 device="cpu")
        fft_need = (chunk + 1) * C.FFT_STEPSIZE
        pool.feed(ref[None, :fft_need], test[None, :fft_need])
        assert calls == [C.FFT_FRAMESIZE]
        if advanced:
            fb_need = 16 * chunk * C.FB_FRAMESIZE
            pool.feed(ref[None, fft_need:fb_need],
                      test[None, fft_need:fb_need])
            assert sorted(calls) == [C.FB_FRAMESIZE] + [C.FFT_FRAMESIZE] * 2


def blocks_pair(dtype, lead=2, channels=2, n=30, seed=9):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((lead, channels, n + 1, 1024)) * 0.1
    test = ref + 0.01 * rng.standard_normal(ref.shape)
    return ref.astype(dtype), test.astype(dtype)


def old_energy_totals(ref_blocks, test_blocks, frame_valid, dtype):
    """The formula energy_totals had before S1 took the halves: the sums
    of the squares of each frame's first hop block, from the blocks."""
    rhalf = ref_blocks[..., :-1, :].to(dtype)
    nhalf = rhalf - test_blocks[..., :-1, :].to(dtype)
    if frame_valid is not None:
        sel = frame_valid[:, None, :, None]
        rhalf = torch.where(sel, rhalf, 0.0)
        nhalf = torch.where(sel, nhalf, 0.0)
    return (torch.sum(rhalf ** 2, dim=(1, 2, 3)),
            torch.sum(nhalf ** 2, dim=(1, 2, 3)))


def jax_energy_totals(ref_blocks, test_blocks, frame_valid):
    """gstpeaq_tpu/models/basic.py:203-211 per pair (rsum, nsum) in
    float64."""
    out = []
    for i in range(ref_blocks.shape[0]):
        rhalf = jnp.asarray(ref_blocks[i])[..., :-1, :].astype(jnp.float64)
        nhalf = rhalf - jnp.asarray(test_blocks[i])[..., :-1, :].astype(
            jnp.float64)
        if frame_valid is not None:
            sel = jnp.asarray(frame_valid[i])[:, None]
            rhalf = jnp.where(sel, rhalf, 0.0)
            nhalf = jnp.where(sel, nhalf, 0.0)
        out.append((float(jnp.sum(rhalf ** 2)), float(jnp.sum(nhalf ** 2))))
    return np.array(out).T


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ship", [np.float32, np.float64])
def test_halves_give_the_energy_totals(ship, masked):
    """S1's plain halves [2, B, CH, F], summed by energy_totals, give the
    formula they replaced and JAX's rsum / nsum within 1e-12 relative in
    float64, with and without frame_valid; the halves are each frame's
    first hop block's energies of ref and of ref - test."""
    ref, test = blocks_pair(ship)
    n = ref.shape[-2] - 1
    valid = (torch.arange(n) < torch.tensor([n, 17])[:, None]
             if masked else None)
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT))
    rb, tb = torch.from_numpy(ref), torch.from_numpy(test)
    _, _, halves = cuda_spectral.pair_frames_plain(rb, tb, k.hann)
    assert halves.shape == (2, 2, 2, n) and halves.dtype == torch.float64
    got = np.array([x.numpy() for x in basic.energy_totals(halves, valid)])
    old = np.array([x.numpy() for x in old_energy_totals(
        rb, tb, valid, torch.float64)])
    want = jax_energy_totals(ref, test, None if valid is None
                             else valid.numpy())
    for other in (old, want):
        assert (np.abs(got - other) / np.abs(other)).max() < 1e-12
    r64 = rb.double()
    np.testing.assert_allclose(
        halves[1, 1, 0, 3].item(),
        ((r64 - tb.double())[1, 0, 3] ** 2).sum().item(), rtol=1e-13)


@pytest.mark.parametrize("masked", [False, True])
def test_energy_totals_are_steady_across_threads(masked):
    """energy_totals over halves large enough for torch's parallel
    reduction gives the same bits at 1, 3 and 8 intra-op threads."""
    rng = np.random.default_rng(11)
    halves = torch.from_numpy(rng.uniform(0.0, 3.0, (2, 3, 2, 9000)))
    valid = (torch.from_numpy(rng.uniform(size=(3, 9000)) < 0.8)
             if masked else None)
    threads = torch.get_num_threads()
    got = []
    try:
        for n in (1, 3, 8):
            torch.set_num_threads(n)
            got.append(torch.stack(basic.energy_totals(halves, valid)))
    finally:
        torch.set_num_threads(threads)
    for g in got[1:]:
        assert torch.equal(g, got[0])
