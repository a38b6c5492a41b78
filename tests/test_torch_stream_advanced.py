"""The port's advanced streaming, gstpeaq_tpu_torch.parallel.stream.
PeaqStreamAdvanced and the advanced PeaqStreamPool, and the FB ear's
carried state, against the JAX package's in float64 on the CPU.

The stereo saw/triangle pair of 40 * 1024 samples goes to both packages in
the same pieces of random sizes, with chunk_frames 4: FFT chunks of 4
frames and FB chunks of 64 frames, so that several chunks of each path, a
ragged last piece and both flush frames occur.  Bars as in
test_torch_stream.py: 1e-9 against JAX (MOVs times 1 + |w|), the state's
leaves 1e-10 (1 + max|x|) (the DC cascade's rounding scales with the
leaf's largest value, not with each sample), the port's one-shot peaq
1e-10 ODG; the FB ear in
two chunks 1e-10 (its DC cascade's near-unit poles lift float64 rounding
to ~1e-12 of max|hp2|).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import earparams as JEP
from gstpeaq_tpu.ops import fb_ear as JFB
from gstpeaq_tpu.parallel import stream as JS
from gstpeaq_tpu.utils import checkpoint as JCK
from gstpeaq_tpu.utils import testsignals as TS
from gstpeaq_tpu_torch import PeaqStreamAdvanced, PeaqStreamPool
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import convert
from gstpeaq_tpu_torch.ops import fb_ear as FB
from gstpeaq_tpu_torch.utils import checkpoint as CK

N = 40 * 1024
CHUNK = 4
BAR = 1e-9
STATE_BAR = 1e-10
SELF_BAR = 1e-10
FB_BAR = 1e-10

jax_process = jax.jit(JFB.process_signal,
                      static_argnames=("n_frames", "return_state"))
jax_masking = jax.jit(JFB.back_and_forward_masking_t,
                      static_argnames=("n_frames", "return_state"))


def stereo_pair():
    return (np.stack([TS.saw(N), 0.5 * TS.saw(N, 660)], 1),
            np.stack([TS.triangle(N), 0.5 * TS.triangle(N, 660)], 1))


@functools.cache
def pieces():
    rng = np.random.default_rng(1)
    out, pos = [], 0
    while pos < N:
        size = int(rng.integers(1000, 9000))
        out.append((pos, size))
        pos += size
    return tuple(out)


def feed(stream, ref, test, pieces_):
    for start, size in pieces_:
        stream.feed(ref[start:start + size], test[start:start + size])


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def tt(x):
    return torch.from_numpy(np.array(x))


def assert_result(got, want, bar):
    assert abs(got.odg - want.odg) <= bar, (got.odg, want.odg)
    assert abs(got.di - want.di) <= bar, (got.di, want.di)
    for name, w in want.movs.items():
        g = got.movs[name]
        assert abs(g - w) <= bar * (1 + abs(w)), (name, g, w)


@functools.cache
def jax_stream():
    """The JAX stream's state after every feed, and its final result."""
    ref, test = stereo_pair()
    js = JS.PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK,
                               dtype="float64")
    feed(js, ref, test, pieces())
    return jax.tree.map(np.asarray, js.state), js.finalize()


@functools.cache
def port_stream():
    ref, test = stereo_pair()
    s = PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK, device="cpu")
    feed(s, ref, test, pieces())
    return convert.stream_state_to_numpy(s.state), s.finalize()


@pytest.fixture(scope="module")
def params():
    return JEP.fb_ear_params()


@pytest.mark.parametrize("cut", [19, 1])
def test_fb_process_signal_in_two_chunks_matches_jax(params, cut):
    """The FB ear with its (dc_state, hp2_history, cu, (e0_tail, exc))
    state carried across two chunks (the first of `cut` frames, so a chunk
    of one frame, 6 instants, takes the short e0-tail branch): against
    JAX's process_signal with state, leaf by leaf, and against one call."""
    rng = np.random.default_rng(3)
    n_frames = 40
    x = (rng.standard_normal((2, 2, 192 * n_frames)) * 0.3).astype(
        np.float32)
    x[..., :2000] = 0.0
    jk, k = JFB.build_consts(params), FB.build_consts(params)
    whole = FB.process_signal(k, tt(x), n_frames)
    state, jstate, outs = None, None, []
    for lo, hi in ((0, cut), (cut, n_frames)):
        part = x[..., 192 * lo:192 * hi]
        exc, uns, state = FB.process_signal(k, tt(part), hi - lo, state, True)
        jexc, juns, jstate = jax_process(jk, jnp.asarray(part, jnp.float64),
                                         n_frames=hi - lo, state=jstate,
                                         return_state=True)
        assert rel(exc, jexc) < FB_BAR and rel(uns, juns) < FB_BAR
        got, want = CK.tree_flatten(state), jax.tree.flatten(jstate)[0]
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float64
            assert np.all(np.abs(g.numpy() - w)
                          <= FB_BAR * (1 + np.abs(w).max()))
        outs.append((exc, uns))
    for i in range(2):
        assert rel(torch.cat([o[i] for o in outs], -1), whole[i]) < FB_BAR


@pytest.mark.parametrize("frames", [1, 2, 5])
def test_masking_tail_of_short_chunks_matches_jax(params, frames):
    """back_and_forward_masking's e0 tail after chunks of fewer than 10
    instants (a one-frame flush) and more, from a carried state."""
    rng = np.random.default_rng(frames)
    e0 = rng.uniform(0.1, 10.0, (2, 40, 6 * frames))
    state = (rng.uniform(0.1, 10.0, (2, 40, 10)),
             rng.uniform(0.1, 10.0, (2, 40)))
    jk, k = JFB.build_consts(params), FB.build_consts(params)
    got = FB.back_and_forward_masking(k, tt(e0), frames,
                                      tuple(map(tt, state)), True)
    want = jax_masking(jk, jnp.asarray(e0), n_frames=frames,
                       state=tuple(map(jnp.asarray, state)),
                       return_state=True)
    for g, w in zip(CK.tree_flatten(got), jax.tree.flatten(want)[0]):
        assert rel(g, w) < 1e-12


def test_advanced_stream_matches_jax_stream():
    assert_result(port_stream()[1], jax_stream()[1], BAR)


def test_advanced_stream_state_matches_jax():
    """The same leaves as JAX's after the same feeds, in flatten order,
    with the same shapes and dtypes, within 1e-10 (1 + max|x|)."""
    want = jax.tree.flatten(jax_stream()[0])[0]
    got = CK.tree_flatten(port_stream()[0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert np.all(np.abs(g - w) <= STATE_BAR * (1 + np.abs(w).max()))


def test_advanced_stream_matches_one_shot_peaq():
    want = api.peaq(*stereo_pair(), advanced=True, dtype="float64",
                    device="cpu")
    assert_result(port_stream()[1], want, SELF_BAR)


def resume_pending_in_jax(js, stream):
    (fr, ft), (br, bt) = stream.pending
    js._fft_buf = [fr[0].copy(), ft[0].copy()]
    js._fb_buf = [br[0].copy(), bt[0].copy()]


def test_advanced_checkpoint_port_to_jax(tmp_path):
    """A port checkpoint taken mid-stream resumes in the JAX stream to the
    uninterrupted result, and in a fresh port stream bit for bit."""
    ref, test = stereo_pair()
    first, rest = pieces()[:4], pieces()[4:]
    s = PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK, device="cpu")
    feed(s, ref, test, first)
    CK.save_state(str(tmp_path / "port"), s.state)
    js = JS.PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK,
                               dtype="float64")
    js.state = JCK.load_state(str(tmp_path / "port"), js.state)
    resume_pending_in_jax(js, s)
    s2 = PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK, device="cpu")
    s2.state = CK.load_state(str(tmp_path / "port"), s2.state)
    s2.pending = [[b.copy() for b in bufs] for bufs in s.pending]
    feed(js, ref, test, rest)
    feed(s2, ref, test, rest)
    assert_result(js.finalize(), port_stream()[1], BAR)
    got, want = s2.finalize(), port_stream()[1]
    assert got.odg == want.odg and got.movs == want.movs


def test_advanced_checkpoint_jax_to_port(tmp_path, monkeypatch):
    """A JAX checkpoint in its npz form resumes in the port."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    ref, test = stereo_pair()
    first, rest = pieces()[:5], pieces()[5:]
    js = JS.PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK,
                               dtype="float64")
    feed(js, ref, test, first)
    JCK.save_state(str(tmp_path / "jax"), js.state)
    s = PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK, device="cpu")
    s.state = CK.load_state(str(tmp_path / "jax"), s.state)
    s.pending = [[b[None].copy() for b in js._fft_buf],
                 [b[None].copy() for b in js._fb_buf]]
    feed(s, ref, test, rest)
    assert_result(s.finalize(), jax_stream()[1], BAR)


def test_advanced_pool_matches_scalar_streams():
    """Two lockstep advanced streams, fed in two ragged pieces, equal two
    scalar advanced streams within 1e-12."""
    ref, test = stereo_pair()
    sigs = [(ref, test), (ref, 0.9 * test)]
    pool = PeaqStreamPool(2, channels=2, chunk_frames=CHUNK, advanced=True,
                          device="cpu")
    refs = np.stack([r for r, _ in sigs])
    tests = np.stack([t for _, t in sigs])
    cut = 23_457
    pool.feed(refs[:, :cut], tests[:, :cut])
    pool.feed(refs[:, cut:], tests[:, cut:])
    got = pool.finalize()
    for i, (r, t) in enumerate(sigs):
        s = PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK, device="cpu")
        s.feed(r, t)
        want = s.finalize()
        assert abs(got.odg[i] - want.odg) <= 1e-12, i
        for name, w in want.movs.items():
            assert abs(got.movs[name][i] - w) <= 1e-12 * (1 + abs(w)), name


def test_advanced_int16_feed_bit_equal():
    """int16 feeds equal x / 32768 float32 feeds bit for bit."""
    rng = np.random.default_rng(7)
    ri = (rng.integers(-2000, 2000, (N, 2)) * 8).astype(np.int16)
    ti = (ri * 0.9).astype(np.int16)
    results = []
    for r, t in ((ri, ti), (ri.astype(np.float32) / 32768.0,
                            ti.astype(np.float32) / 32768.0)):
        s = PeaqStreamAdvanced(channels=2, chunk_frames=CHUNK, device="cpu")
        feed(s, r, t, pieces())
        results.append(s.finalize())
    got, want = results
    np.testing.assert_array_equal([got.odg, *got.movs.values()],
                                  [want.odg, *want.movs.values()])
