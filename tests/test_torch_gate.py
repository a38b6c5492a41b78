"""G1 `frame_gate` (ops/cuda_gate.py) and S1's `halves` on the CPU, where the
wrappers take their plain versions.

The port's gate is held bit for bit to the JAX package's
gstpeaq_tpu/ops/framing.py::above_threshold_signal in both frame forms
(FFT: frame 2048, hop 1024; FB: frame = hop = 192) and both dtypes, on
inputs made with numpy from a seed that hold the rows the card is checked
on: windows one ulp either side of the threshold, windows across a hop
boundary, windows at frame-local i < 5 that must not count, one channel
crossing alone, a NaN sample, mono and 3 channels, a view.  The kernel's
tile walk (csrc/gate.cu) is re-enacted in numpy from the source's
constants: every sample read once, and the frame bits equal the plain
version's.  S1's plain halves give the totalsnr energies of the formula
they replaced and of JAX's, and their sums are steady across threads.
"""

import re

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
# (frame, hop, frames): the FFT form over 6 of G1's float tiles of 4 hops
# (12 double tiles of 2), the FB form over 2 of 21 hops (4 of 10)
FORMS = {"fft": (C.FFT_FRAMESIZE, C.FFT_STEPSIZE, 23),
         "fb": (C.FB_FRAMESIZE, C.FB_FRAMESIZE, 40)}
DTYPES = (np.float32, np.float64)
NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


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
    sample (its frame stays below).  Pair 2: pair 0 negated, its first
    channel silent."""
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
    tile = tile_of(dtype) // hop
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
                   n_hops - 2: False})
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
            for name in ("kThreads", "kTileBytes", "kHalo", "kTailFrom")}


def tile_of(dtype) -> int:
    """G1's tile in samples of the spectrum dtype (gate.cu tile_of)."""
    return source_constants()["kTileBytes"] // np.dtype(dtype).itemsize


def kernel_walk(x: np.ndarray, n: int, frame: int, hop: int, dtype):
    """G1 re-enacted: one block a (pair, tile of tile_of // hop hops), the
    channels' |x| staged in `dtype` with a kHalo halo, the window sums at
    each position summed in the kernel's order, their maximum over
    channels, each hop's tail and full maxima, and out[f] set where a
    hop's bit is set.  Returns the bits and each sample's count of main
    (non-halo) loads."""
    k = source_constants()
    fft = frame == 2 * hop
    n_hops = n + fft
    tile_len = tile_of(dtype)
    tile_hops = tile_len // hop
    tiles = -(-n_hops // tile_hops)
    out = np.zeros((x.shape[0], n), bool)
    reads = np.zeros(x.shape[-1], int)
    halo = k["kHalo"]
    for p in range(x.shape[0]):
        for tile in range(tiles):
            h0 = tile * tile_hops
            hops = min(tile_hops, n_hops - h0)
            size, j0 = hops * hop, h0 * hop
            m = np.full(tile_len, -np.inf, dtype)
            for c in range(x.shape[1]):
                s = np.zeros(halo + tile_len, dtype)
                lo = max(j0 - halo, 0)
                row = x[p, c].astype(dtype)
                s[halo - (j0 - lo):halo] = np.abs(row[lo:j0])
                s[halo:halo + size] = np.abs(row[j0:j0 + size])
                if p == 0 and c == 0:
                    reads[j0:j0 + size] += 1
                i = np.arange(tile_len)
                w = s[halo + i]
                for back in range(1, halo + 1):
                    w = w + s[halo + i - back]
                w = np.where(j0 + i >= halo, w, dtype(0))
                m = np.maximum(m, w)
            for hl in range(hops):
                g = m[hl * hop:(hl + 1) * hop]
                h = h0 + hl
                if g[k["kTailFrom"]:].max() >= dtype(TH) and h < n:
                    out[p, h] = True
                if fft and g.max() >= dtype(TH) and 1 <= h <= n:
                    out[p, h - 1] = True
    return out, reads


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", list(FORMS))
def test_kernel_walk_reads_once_and_equals_the_plain_gate(form, dtype):
    """G1's walk over tiles, halos and set-only bits, re-enacted from
    gate.cu's constants, gives the plain gate's bits on the edge rows (a
    sample at a tile's first hop sets a frame of the tile before), and
    reads each covered sample once (a halo aside) and nothing past them."""
    frame, hop, n, n_hops = hops_of(form)
    x, _ = gate_rows(form, dtype, 3)
    got, reads = kernel_walk(x, n, frame, hop, dtype)
    want = cuda_gate.frame_gate_plain(torch.from_numpy(x), n, frame, hop)
    np.testing.assert_array_equal(got, want.numpy())
    assert (reads[:n_hops * hop] == 1).all() and reads.size == n_hops * hop
    assert tile_of(dtype) // hop < n_hops                 # two tiles


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
    """The C entries of csrc/gate.cu have their ctypes signatures."""
    text = (_build.CSRC / "gate.cu").read_text()
    for suffix in ("f32", "f64"):
        assert f"peaq_frame_gate_{suffix}" in _build.SIGNATURES
        assert f"int peaq_frame_gate_{suffix}(" in text


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
