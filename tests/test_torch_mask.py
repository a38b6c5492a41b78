"""W1 `mask_frames` (ops/cuda_fb.py, csrc/fb_mask.cu) on the CPU, where
the wrapper takes its plain version, cuda_fb.mask_frames_plain.

The FB ear's masking, fb_ear.back_and_forward_masking (W1's frame sums,
internal noise and drive, then K1's forward masking), is held to the JAX
package's gstpeaq_tpu/ops/fb_ear.py::back_and_forward_masking_t at 1e-12
(float64) and 1e-5 (float32) of max|ref|, without a state and with a
carried (e0_tail, exc), at F = 1, 2, 5 and 2500; and bit for bit to the
eager lines it replaced, copied here (`eager_masking`).  W1's launch plan
(mask_grid and the kernel's spans) is re-enacted at every call-site shape
of the main paths and at F = 1: every frame of every row written once,
each span's staged instants on a 16-byte boundary.  The kernel's walk is
re-enacted in numpy, block by block (the 16-byte staging, the frame before
a span, the shuffle of sa and lane 0's own sum, the tail at a row's first
frame), against the plain version, on shapes whose spans cross rows, end
raggedly and hold one frame.  The source's constants are the wrapper's,
the C entries are bound, a CPU tensor launches nothing, another device
raises, and every masking site of the pipelines and the chunk steps goes
through mask_frames.  The kernel itself is held to the plain version on
the card by chip_smoke.py and tests/test_torch_mask_card.py.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import earparams as EP
from gstpeaq_tpu.ops import fb_ear as JFB
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_fb
from gstpeaq_tpu_torch.ops import fb_ear as FB
from gstpeaq_tpu_torch.ops import iir
from gstpeaq_tpu_torch.parallel import batch as PB
from gstpeaq_tpu_torch.parallel import stream as PS

BARS = {torch.float64: 1e-12, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
LEAD = cuda_fb.MASK_LEAD
INSTANTS = cuda_fb.FRAME_INSTANTS
TORCH = {4: torch.float32, 8: torch.float64}

jax_masking = jax.jit(JFB.back_and_forward_masking_t,
                      static_argnames=("n_frames", "return_state"))


@pytest.fixture(scope="module")
def params():
    return EP.fb_ear_params()


def rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def inputs(seed: int, lead: tuple, frames: int, dtype):
    """e0 [*lead, 40, 6 F] over six decades and a state (e0_tail [*lead,
    40, 10], exc [*lead, 40]), from a generator of their own."""
    rng = np.random.default_rng(seed)
    shape = (*lead, C.FB_BAND_COUNT)
    e0 = (rng.uniform(0.1, 10.0, (*shape, INSTANTS * frames))
          * 10.0 ** rng.uniform(-3.0, 3.0, (*shape, 1)))
    state = (rng.uniform(0.1, 10.0, (*shape, FB.E0_TAIL)),
             rng.uniform(0.1, 10.0, shape))
    return e0.astype(NP[dtype]), tuple(s.astype(NP[dtype]) for s in state)


def eager_masking(k, e0, n_frames, state=None, return_state=False):
    """fb_ear.back_and_forward_masking as it was before W1: the eager frame
    sums, internal noise and drive, then K1."""
    e0f = e0.reshape(*e0.shape[:-1], n_frames, 6)
    wa, wb = k.back_mask_w[0], k.back_mask_w[1]
    sb = torch.sum(e0f * wb, dim=-1)
    sa = torch.sum(e0f * wa, dim=-1)
    if state is None:
        e0_tail, exc0 = None, None
        prev = torch.zeros_like(sa[..., :1])
    else:
        # the previous frame's instants 1..5 (wa[0] = 0)
        e0_tail, exc0 = (s.to(e0.dtype) for s in state)
        prev = torch.sum(e0_tail[..., -5:] * wa[1:], dim=-1, keepdim=True)
    e1 = sb + torch.cat([prev, sa[..., :-1]], -1)
    unsmeared = e1 + k.internal_noise[:, None]
    excitation = iir.linear_recurrence_banded(
        k.ear_a, (1.0 - k.ear_a)[:, None] * unsmeared, axis=-1, y0=exc0)
    if not return_state:
        return excitation, unsmeared
    if e0.shape[-1] < 10:      # a flush of one frame: 6 instants
        base = (e0_tail if e0_tail is not None
                else e0.new_zeros((*e0.shape[:-1], 10)))
        e0 = torch.cat([base, e0], dim=-1)
    return excitation, unsmeared, (e0[..., -10:], excitation[..., -1])


def flat(out) -> list:
    """The tensors of a masking result, its state's leaves after its two
    outputs."""
    return [*out[:2], *(out[2] if len(out) > 2 else ())]


@pytest.mark.parametrize("frames", [1, 2, 5, 2500])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_masking_matches_jax(params, dtype, with_state, frames):
    """back_and_forward_masking through W1's plain version against JAX's
    back_and_forward_masking_t: excitation, unsmeared and, with a state,
    the new state."""
    lead = (2,) if frames < 2500 else (2, 2)
    e0, state = inputs(frames, lead, frames, dtype)
    state = state if with_state else None
    k = FB.build_consts(params, dtype)
    jk = JFB.build_consts(params, dtype=JNP[dtype])
    got = FB.back_and_forward_masking(
        k, torch.from_numpy(e0), frames,
        None if state is None else tuple(map(torch.from_numpy, state)),
        with_state)
    want = jax_masking(jk, jnp.asarray(e0), n_frames=frames,
                       state=None if state is None
                       else tuple(map(jnp.asarray, state)),
                       return_state=with_state)
    want = [*want[:2], *(want[2] if with_state else ())]
    got = flat(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert rel(g, w) < BARS[dtype]


@pytest.mark.parametrize("frames", [1, 2, 5, 2500])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_masking_is_the_eager_form_bit_for_bit(params, dtype, with_state,
                                               frames):
    """The refactored masking (W1's plain version, then K1) equals the
    eager lines it replaced bit for bit, its state too."""
    e0, state = inputs(100 + frames, (2, 2), frames, dtype)
    state = tuple(map(torch.from_numpy, state)) if with_state else None
    k = FB.build_consts(params, dtype)
    got = flat(FB.back_and_forward_masking(k, torch.from_numpy(e0), frames,
                                           state, with_state))
    want = flat(eager_masking(k, torch.from_numpy(e0), frames, state,
                              with_state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# e0's shape at each W1 call site of the main paths (per pair, the
# advanced batch's microbatch of 32, the chunk-64 and chunk-1,024 FB steps
# at one stream and at the pool's 16, the one-shot 10-minute program) and
# the stream's one-frame flush
SITE_SHAPES = {"pair": (2, 1, 2, 40, 15000),
               "batch": (2, 32, 2, 40, 15360),
               "chunk64 N=1": (2, 1, 2, 40, 6144),
               "chunk64 N=16": (2, 16, 2, 40, 6144),
               "chunk1024 N=1": (2, 1, 2, 40, 98304),
               "chunk1024 N=16": (2, 16, 2, 40, 98304),
               "one shot 600 s": (2, 1, 2, 40, 900000),
               "flush F=1": (2, 1, 2, 40, 6)}


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("site", SITE_SHAPES)
def test_launch_plan_writes_each_frame_once(site, item):
    """mask_grid's blocks take consecutive spans of the flat rows x frames
    axis: every frame of every row in exactly one span (each span's thread
    t writes its frames g0 + P t + p, p < P, once), each span's instants
    on a 16-byte boundary
    and staged in whole 16-byte loads but at the last span's end, the frame
    before a span in the tensor wherever a span starts inside a row, and
    every index within the kernel's int and the grid's extent."""
    shape = SITE_SHAPES[site]
    frames_a_row = shape[-1] // INSTANTS
    frames = math.prod(shape[:-1]) * frames_a_row
    span = cuda_fb.mask_span(TORCH[item])
    per_thread = cuda_fb.MASK_FRAMES[TORCH[item]]
    assert span == cuda_fb.MASK_THREADS * per_thread
    blocks = cuda_fb.mask_grid(frames, TORCH[item])
    assert 0 < blocks <= 2**31 - 1
    g0 = np.arange(blocks, dtype=np.int64) * span
    n = np.minimum(span, frames - g0)
    assert g0[0] == 0 and (n >= 1).all() and (n[:-1] == span).all()
    assert np.array_equal(g0[1:], g0[:-1] + n[:-1])
    assert g0[-1] + n[-1] == frames
    # each span's first instant on a 16-byte boundary of a 16-byte aligned
    # e0; whole 16-byte loads cover all but a ragged end of the last span
    per = 16 // item
    assert ((g0 * INSTANTS * item) % 16 == 0).all()
    values = n * INSTANTS
    ragged = values - values // per * per
    assert (ragged[:-1] == 0).all() and ragged[-1] < per
    # a span that starts inside a row reads the frame before it, which the
    # kernel stages whenever g0 > 0; a row's first frame reads the tail
    inside = g0 % frames_a_row != 0
    assert (g0[inside] > 0).all()
    assert (LEAD - INSTANTS) >= 0 and (LEAD * item) % 16 == 0
    assert (values <= 2**31 - 1).all()


def kernel_walk(e0, w, noise, ear_a, n_frames: int, tail=None):
    """csrc/fb_mask.cu's mask_frames_kernel re-enacted in numpy, block by
    block, in e0's dtype: the span's instants staged in 16-byte vectors
    and single values, the frame before it at LEAD - 6, what a thread
    forms from unstaged shared memory NaN; sb and sa of each of a
    thread's P frames, sa of the frame before its first by a shuffle from
    the thread before (lane 0 sums its own), of a later frame its own,
    the tail or 0 at a row's first frame.  Returns (unsmeared, drive) and
    each frame's count of writes."""
    x = e0.reshape(-1)
    dtype = x.dtype.type
    z = noise.shape[0]
    frames = x.size // INSTANTS
    rows = frames // n_frames
    tail = None if tail is None else tail.reshape(rows, -1)[:, -5:]
    uns = np.full(frames, np.nan, x.dtype)
    drive = np.full(frames, np.nan, x.dtype)
    writes = np.zeros(frames, np.int64)
    per = 16 // x.itemsize
    wa, wb = w[0], w[1]
    dt = TORCH[x.itemsize]
    span, p_frames = cuda_fb.mask_span(dt), cuda_fb.MASK_FRAMES[dt]
    # a block's frames j = P t + p: thread t's p-th frame
    j = np.arange(span)
    for b in range(cuda_fb.mask_grid(frames, dt)):
        g0 = b * span
        n = min(span, frames - g0)
        s = np.full(LEAD + INSTANTS * span, np.nan, x.dtype)
        values = n * INSTANTS
        vectors = values // per
        src = x[g0 * INSTANTS:]
        for i in range(vectors):
            s[LEAD + i * per:LEAD + (i + 1) * per] = src[i * per:(i + 1) * per]
        s[LEAD + vectors * per:LEAD + values] = src[vectors * per:values]
        if g0 > 0:
            s[LEAD - INSTANTS:LEAD] = x[(g0 - 1) * INSTANTS:g0 * INSTANTS]
        own = s[LEAD + INSTANTS * j[:, None] + np.arange(INSTANTS)]
        before = s[LEAD + INSTANTS * (j[:, None] - 1) + np.arange(INSTANTS)]
        sb, sa, lane0 = wb[0] * own[:, 0], wa[0] * own[:, 0], wa[0] * before[:, 0]
        for r in range(1, INSTANTS):
            sb = sb + wb[r] * own[:, r]
            sa = sa + wa[r] * own[:, r]
            lane0 = lane0 + wa[r] * before[:, r]
        # the frame before a thread's first: a shuffle from the thread
        # before, lane 0's own sum; before a later frame, its own
        lane = j // p_frames % 32
        prev = np.where((j % p_frames == 0) & (lane == 0), lane0,
                        np.roll(sa, 1))
        g = g0 + j[:n]
        row = g // n_frames
        first = g == row * n_frames
        prev = prev[:n].copy()
        if tail is None:
            prev[first] = 0.0
        else:
            q = tail[row[first]]
            acc = wa[1] * q[:, 0]
            for r in range(2, 6):
                acc = acc + wa[r] * q[:, r - 1]
            prev[first] = acc
        band = row % z
        u = (sb[:n] + prev) + noise[band]
        uns[g] = u
        drive[g] = (dtype(1.0) - ear_a[band]) * u
        np.add.at(writes, g, 1)
    shape = (*e0.shape[:-1], n_frames)
    return uns.reshape(shape), drive.reshape(shape), writes


# (lead, bands, frames): spans across many rows; one frame a row; an odd
# count of frames in all (a ragged float end, bands other than 40); rows
# of more than a span
WALK_SHAPES = [((2,), 40, 1), ((2, 2), 40, 7), ((1,), 3, 7), ((2,), 40, 257)]


@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("shape", WALK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_walk_equals_the_plain_version(params, dtype, shape,
                                              with_tail):
    """The kernel's walk writes every frame once and equals
    mask_frames_plain within a few ulps (1e-14 / 1e-6 of max|ref|)."""
    lead, z, frames = shape
    rng = np.random.default_rng(z * frames + with_tail)
    k = FB.build_consts(params, dtype)
    e0 = (rng.uniform(0.1, 10.0, (*lead, z, INSTANTS * frames))
          * 10.0 ** rng.uniform(-3.0, 3.0, (*lead, z, 1))).astype(NP[dtype])
    tail = (rng.uniform(0.1, 10.0, (*lead, z, FB.E0_TAIL)).astype(NP[dtype])
            if with_tail else None)
    noise, ear_a = k.internal_noise[:z], k.ear_a[:z]
    w = k.back_mask_w.numpy()
    uns, drive, writes = kernel_walk(e0, w, noise.numpy(), ear_a.numpy(),
                                     frames, tail)
    assert (writes == 1).all()
    want = cuda_fb.mask_frames_plain(
        torch.from_numpy(e0), k.back_mask_w, noise, ear_a, frames,
        None if tail is None else torch.from_numpy(tail))
    bar = {torch.float64: 1e-14, torch.float32: 1e-6}[dtype]
    for got, ref in zip((uns, drive), want):
        assert np.isfinite(got).all()
        assert rel(got, ref) < bar


def test_kernel_constants_are_the_wrappers():
    """fb_mask.cu's threads, frames a thread, lead, frame and tail
    constants are the wrapper's, its spans even (16-byte aligned spans in
    float) and its lead 16-byte aligned and room for a frame in both
    types."""
    src = (_build.CSRC / "fb_mask.cu").read_text()
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
           for name in ("kInstants", "kThreads", "kLead", "kTailTaps")}
    assert got == {"kInstants": cuda_fb.FRAME_INSTANTS,
                   "kThreads": cuda_fb.MASK_THREADS,
                   "kLead": cuda_fb.MASK_LEAD,
                   "kTailTaps": cuda_fb.TAIL_TAPS}
    frames = re.search(r"constexpr int kFrames = sizeof\(T\) == 4 \? (\d+) "
                       r": (\d+);", src)
    assert {torch.float32: int(frames[1]), torch.float64: int(frames[2])} \
        == cuda_fb.MASK_FRAMES
    assert "constexpr int kSpan = kThreads * kFrames<T>;" in src
    for dtype in cuda_fb.MASK_FRAMES:
        assert cuda_fb.mask_span(dtype) % 2 == 0
    assert cuda_fb.MASK_THREADS % 32 == 0
    assert LEAD >= INSTANTS and (LEAD * 4) % 16 == 0
    assert "__launch_bounds__(kThreads)" in src
    assert "blocks != (frames + kSpan<T> - 1) / kSpan<T>" in src


def test_mask_entries_are_bound():
    """Both C entries are in the build's signatures, with the wrapper's
    argument count (eleven and the stream)."""
    for suffix in ("f32", "f64"):
        assert len(_build.SIGNATURES[f"peaq_mask_frames_{suffix}"]) == 12
    assert "fb_mask.cu" in {p.name for p in _build.sources()}


def test_cpu_route_is_the_plain_version(monkeypatch, params):
    """A CPU tensor takes mask_frames_plain and launches nothing."""
    monkeypatch.setattr(cuda_fb, "mask_frames_launches", 0)
    k = FB.build_consts(params)
    e0, state = inputs(7, (2,), 9, torch.float64)
    e0 = torch.from_numpy(e0)
    for tail in (None, torch.from_numpy(state[0])):
        got = cuda_fb.mask_frames(e0, k.back_mask_w, k.internal_noise,
                                  k.ear_a, 9, tail)
        want = cuda_fb.mask_frames_plain(e0, k.back_mask_w,
                                         k.internal_noise, k.ear_a, 9, tail)
        for g, w in zip(got, want):
            assert torch.equal(g, w) and g.is_contiguous()
    assert cuda_fb.mask_frames_launches == 0


def test_other_devices_raise_without_fallback():
    """A tensor on neither the CPU nor a CUDA card is refused before any
    build; so is a shape the kernel does not take."""
    e0 = torch.ones(2, 40, 12, device="meta")
    w = torch.ones(2, 6, device="meta")
    z = torch.ones(40, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fb.mask_frames(e0, w, z, z, 2)
    with pytest.raises(ValueError, match="do not match"):
        cuda_fb.mask_frames(e0, w, z, z, 3)
    with pytest.raises(ValueError, match="do not match"):
        cuda_fb.mask_frames(e0, w, z, z, 2, torch.ones(2, 40, 4,
                                                         device="meta"))


def test_every_masking_site_calls_mask_frames(monkeypatch):
    """The pipelines and the chunk steps take the masking sums through
    mask_frames: never in a basic call, once in an advanced peaq() and in
    each advanced microbatch, once in each FB chunk step (its flush too),
    never in an FFT step."""
    calls = []
    masked = cuda_fb.mask_frames

    def spy(e0, *args):
        calls.append(tuple(e0.shape))
        return masked(e0, *args)
    monkeypatch.setattr(cuda_fb, "mask_frames", spy)
    rng = np.random.default_rng(8)
    n = 40 * 1024
    ref = rng.standard_normal((n, 2)).astype(np.float32) * 0.1
    test = ref + rng.standard_normal(ref.shape).astype(np.float32) * 0.01
    for advanced in (False, True):
        calls.clear()
        api.peaq(ref, test, advanced=advanced, device="cpu")
        assert len(calls) == advanced
        assert all(c[:4] == (2, 1, 2, 40) and c[4] % INSTANTS == 0
                   for c in calls)
    calls.clear()
    PB.peaq_batch([ref] * 3, [test] * 3, advanced=True, microbatch=2,
                  device="cpu")
    assert len(calls) == 2 and all(c[1] == 2 for c in calls)
    chunk = 4
    for advanced in (False, True):
        calls.clear()
        pool = PS.PeaqStreamPool(1, chunk_frames=chunk, advanced=advanced,
                                 device="cpu")
        fft_need = (chunk + 1) * C.FFT_STEPSIZE
        pool.feed(ref[None, :fft_need], test[None, :fft_need])
        assert calls == []
        if advanced:
            fb_need = 16 * chunk * C.FB_FRAMESIZE
            pool.feed(ref[None, fft_need:fb_need],
                      test[None, fft_need:fb_need])
            assert calls == [(2, 1, 2, 40, INSTANTS * 16 * chunk)]
            # the flush of one FB frame
            calls.clear()
            pool.feed(ref[None, fb_need:fb_need + C.FB_FRAMESIZE],
                      test[None, fb_need:fb_need + C.FB_FRAMESIZE])
            pool.finalize()
            assert calls == [(2, 1, 2, 40, INSTANTS)]
