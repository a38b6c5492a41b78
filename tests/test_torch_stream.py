"""The port's basic streaming, gstpeaq_tpu_torch.parallel.stream.PeaqStream
and PeaqStreamPool, and the stateful forms it runs, against the JAX
package's in float64 on the CPU.

The same stereo saw/triangle pair (40 * 1024 samples) is fed to both
packages in the same pieces of random sizes, with chunks of 8 frames, so
that several chunks, a ragged last piece and the zero-padded flush frame
occur.  Bars: ODG and DI within 1e-9 of the JAX stream, each MOV within
1e-9 (1 + |w|), the state's leaves within 1e-10 (1 + |x|); the port's own
one-shot peaq within 1e-10 ODG; the stateful modules in two chunks within
1e-12 relative.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import constants as JC
from gstpeaq_tpu import earparams as JEP
from gstpeaq_tpu.models import level_adapt as JLA
from gstpeaq_tpu.models import modulation as JMOD
from gstpeaq_tpu.ops import fft_ear as JFE
from gstpeaq_tpu.parallel import stream as JS
from gstpeaq_tpu.utils import checkpoint as JCK
from gstpeaq_tpu.utils import testsignals as TS
from gstpeaq_tpu_torch import PeaqStream, PeaqStreamPool
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import convert
from gstpeaq_tpu_torch.models import level_adapt as LA
from gstpeaq_tpu_torch.models.modulation import modulation
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu_torch.utils import checkpoint as CK

N = 40 * 1024
CHUNK = 8
BAR = 1e-9            # port stream against JAX stream
STATE_BAR = 1e-10     # state leaves, times (1 + |x|)
SELF_BAR = 1e-10      # port stream against the port's one-shot peaq
MODULE_BAR = 1e-12    # stateful modules in two chunks
Z = JC.BASIC_BAND_COUNT


def stereo_pair():
    return (np.stack([TS.saw(N), 0.5 * TS.saw(N, 660)], 1),
            np.stack([TS.triangle(N), 0.5 * TS.triangle(N, 660)], 1))


@functools.cache
def pieces(seed: int = 0):
    """(start, size) of random-size feeds covering N samples."""
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < N:
        size = int(rng.integers(1000, 9000))
        out.append((pos, size))
        pos += size
    return tuple(out)


def feed(stream, ref, test, upto=None):
    for start, size in pieces():
        if upto is not None and start >= upto:
            break
        stream.feed(ref[start:start + size], test[start:start + size])


def fed_from(start_at: int):
    """The pieces from the first one starting at start_at."""
    return [(s, n) for s, n in pieces() if s >= start_at]


@functools.cache
def jax_stream():
    """The JAX stream after every feed (not finalized), and its result."""
    ref, test = stereo_pair()
    js = JS.PeaqStream(channels=2, chunk_frames=CHUNK, dtype="float64")
    feed(js, ref, test)
    state = jax.tree.map(np.asarray, js.state)
    return state, js.finalize()


@functools.cache
def port_stream():
    ref, test = stereo_pair()
    s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
    feed(s, ref, test)
    state = convert.stream_state_to_numpy(s.state)
    return state, s.finalize()


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def assert_result(got, want, bar):
    assert abs(got.odg - want.odg) <= bar, (got.odg, want.odg)
    assert abs(got.di - want.di) <= bar, (got.di, want.di)
    for name, w in want.movs.items():
        g = got.movs[name]
        assert abs(g - w) <= bar * (1 + abs(w)), (name, g, w)


def tt(x):
    return torch.from_numpy(np.asarray(x))


def two_chunks(x, cut=23):
    return x[..., :cut], x[..., cut:]


@pytest.fixture(scope="module")
def consts():
    params = JEP.fft_ear_params(Z)
    return JFE.build_consts(params), FE.build_consts(params, torch.float64)


def test_modulation_in_two_chunks_matches_jax(consts):
    """modulation with its (prev loud, filt deriv, filt loud) state carried
    across two chunks: against JAX's with state, and against one call."""
    jk, k = consts
    uns = 10.0 ** np.random.default_rng(1).uniform(-2, 6, (2, 2, Z, 60))
    whole, _, _ = modulation(k.adapt_a, tt(uns), 1024)
    state, jstate, outs = None, None, []
    for part in two_chunks(uns):
        mod, loud, state = modulation(k.adapt_a, tt(part), 1024, state)
        jmod, jloud, jstate = JMOD.modulation(jk.adapt_a, jnp.asarray(part),
                                              1024, jstate)
        assert rel(mod, jmod) < MODULE_BAR and rel(loud, jloud) < MODULE_BAR
        for g, w in zip(state, jstate):
            assert rel(g, w) < MODULE_BAR
        outs.append(mod)
    assert rel(torch.cat(outs, -1), whole) < MODULE_BAR


def test_level_adapt_in_two_chunks_matches_jax(consts):
    """level_adapt's six-state carry across two chunks: against JAX's
    level_adapt with state, and against one call (and the fused one-shot
    form's adapted excitations)."""
    jk, k = consts
    exc = 10.0 ** np.random.default_rng(2).uniform(-1, 5, (2, 2, Z, 60))
    exc[1] *= 3.0
    avg = LA.sliding_average_matrix(Z)
    whole = LA.level_adapt(k.adapt_a, tt(avg), tt(exc[0]), tt(exc[1]))
    fused = LA.level_adapt_fused_mod(k.adapt_a, tt(avg), tt(exc), tt(exc),
                                     1024)
    assert rel(fused[0], whole[0]) < MODULE_BAR
    state, jstate, outs = None, None, []
    for part in two_chunks(exc):
        ar, at, state = LA.level_adapt(k.adapt_a, tt(avg), tt(part[0]),
                                       tt(part[1]), state)
        jar, jat, jstate = JLA.level_adapt(
            jk.adapt_a, jnp.asarray(avg), jnp.asarray(part[0]),
            jnp.asarray(part[1]), jstate)
        assert rel(ar, jar) < MODULE_BAR and rel(at, jat) < MODULE_BAR
        assert len(state) == 6
        for g, w in zip(state, jstate):
            assert rel(g, w) < MODULE_BAR
        outs.append((ar, at))
    for i in range(2):
        assert rel(torch.cat([o[i] for o in outs], -1), whole[i]) < MODULE_BAR


def test_time_smear_in_two_chunks_matches_jax(consts):
    """time_smear's carried filtered excitation across two chunks."""
    jk, k = consts
    uns = 10.0 ** np.random.default_rng(3).uniform(-2, 6, (2, 2, Z, 50))
    whole = FE.time_smear(k, tt(uns), axis=-1)
    state, jstate, outs = None, None, []
    for part in two_chunks(uns, 17):
        out, state = FE.time_smear(k, tt(part), axis=-1, state=state,
                                   return_state=True)
        jout, jstate = JFE.time_smear(jk, jnp.asarray(part), axis=-1,
                                      state=jstate, return_state=True)
        assert rel(out, jout) < MODULE_BAR and rel(state, jstate) < MODULE_BAR
        outs.append(out)
    assert rel(torch.cat(outs, -1), whole) < MODULE_BAR


def test_stream_matches_jax_stream():
    """Identical random-size feeds: ODG, DI and every MOV."""
    assert_result(port_stream()[1], jax_stream()[1], BAR)


def test_stream_state_matches_jax():
    """The state after the same feeds (before the flush): the same leaves
    in flatten order, with the same shapes and dtypes, and values within
    1e-10 (1 + |x|)."""
    want, treedef = jax.tree.flatten(jax_stream()[0])
    got = CK.tree_flatten(port_stream()[0])
    assert len(got) == len(want) == treedef.num_leaves
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert np.all(np.abs(g - w) <= STATE_BAR * (1 + np.abs(w)))


def test_stream_matches_one_shot_peaq():
    """The stream equals the port's own one-shot peaq of the whole pair."""
    want = api.peaq(*stereo_pair(), dtype="float64", device="cpu")
    assert_result(port_stream()[1], want, SELF_BAR)


def test_tree_flatten_matches_jax():
    """The port's flatten gives jax.tree.flatten's order: on both streams'
    states (each flattened as JAX would) and on a tree with None, nested
    tuples and lists; tree_unflatten inverts it."""
    tree = {"b": (np.ones(1), None, [np.zeros(2), {"z": 3, "a": 4}]),
            "a": {"y": 5, "x": (6,)}, "c": None}
    assert [np.asarray(x).tolist() for x in CK.tree_flatten(tree)] == \
        [np.asarray(x).tolist() for x in jax.tree.flatten(tree)[0]]
    tagged = jax.tree.map(lambda _: object(), jax_stream()[0])
    assert CK.tree_flatten(tagged) == jax.tree.flatten(tagged)[0]
    port = CK.tree_unflatten(port_stream()[0],
                             list(range(len(CK.tree_flatten(
                                 port_stream()[0])))))
    assert jax.tree.flatten(port)[0] == list(range(len(jax.tree.flatten(
        port)[0])))
    back = CK.tree_unflatten(tree, CK.tree_flatten(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)


def resume_pending_in_jax(js, stream):
    """Give a JAX stream the port stream's pending host samples."""
    (ref, test), = stream.pending
    js._buf_ref, js._buf_test = ref[0].copy(), test[0].copy()


def test_checkpoint_port_to_jax_and_back(tmp_path):
    """A port checkpoint taken mid-stream resumes in JAX's load_state and
    stream to the uninterrupted result; and in a fresh port stream bit for
    bit."""
    ref, test = stereo_pair()
    cut = pieces()[3][0]
    s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
    feed(s, ref, test, upto=cut)
    CK.save_state(str(tmp_path / "port"), s.state)
    js = JS.PeaqStream(channels=2, chunk_frames=CHUNK, dtype="float64")
    js.state = JCK.load_state(str(tmp_path / "port"), js.state)
    resume_pending_in_jax(js, s)
    s2 = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
    s2.state = CK.load_state(str(tmp_path / "port"), s2.state)
    s2.pending = [[b.copy() for b in bufs] for bufs in s.pending]
    for start, size in fed_from(cut):
        for stream in (js, s2):
            stream.feed(ref[start:start + size], test[start:start + size])
    assert_result(js.finalize(), port_stream()[1], BAR)
    got, want = s2.finalize(), port_stream()[1]
    assert got.odg == want.odg and got.movs == want.movs


def test_checkpoint_jax_to_port(tmp_path, monkeypatch):
    """A JAX checkpoint in its npz form (written where orbax is absent)
    resumes in the port to the uninterrupted result."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    ref, test = stereo_pair()
    cut = pieces()[4][0]
    js = JS.PeaqStream(channels=2, chunk_frames=CHUNK, dtype="float64")
    feed(js, ref, test, upto=cut)
    JCK.save_state(str(tmp_path / "jax"), js.state)
    assert (tmp_path / "jax.npz").exists()
    s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
    s.state = CK.load_state(str(tmp_path / "jax"), s.state)
    s.pending = [[js._buf_ref[None].copy(), js._buf_test[None].copy()]]
    for start, size in fed_from(cut):
        s.feed(ref[start:start + size], test[start:start + size])
    assert_result(s.finalize(), jax_stream()[1], BAR)


def test_state_converters_round_trip():
    """stream_state_from_jax takes a JAX state to the port's tree of
    tensors (same dtypes), which a port stream resumes from, and
    stream_state_to_numpy gives it back unchanged."""
    state = jax_stream()[0]
    port = convert.stream_state_from_jax(state, "cpu")
    assert all(isinstance(x, torch.Tensor) for x in CK.tree_flatten(port))
    back = convert.stream_state_to_numpy(port)
    for g, w in zip(CK.tree_flatten(back), jax.tree.flatten(state)[0]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
    s.state = port
    assert np.isfinite(s.current().di)


@pytest.mark.parametrize("found", [None, 2])
def test_checkpoint_version_mismatch_raises(tmp_path, found):
    """A checkpoint of another state format, or of none, is refused with
    the JAX package's messages."""
    s = PeaqStream(channels=1, chunk_frames=CHUNK, device="cpu")
    leaves = {f"leaf_{i}": np.asarray(x)
              for i, x in enumerate(CK.tree_flatten(
                  convert.stream_state_to_numpy(s.state)))}
    if found is not None:
        leaves["format_version"] = np.int64(found)
    np.savez(str(tmp_path / "old.npz"), **leaves)
    match = "no state-format version" if found is None else "version 2"
    with pytest.raises(ValueError, match=match):
        CK.load_state(str(tmp_path / "old"), s.state)
    with pytest.raises(FileNotFoundError, match="npz form"):
        CK.load_state(str(tmp_path / "missing"), s.state)


def test_pool_matches_scalar_streams():
    """Three lockstep streams fed in two ragged pieces equal three scalar
    streams, and the pool's state has JAX's leading [N] axis."""
    ref, test = stereo_pair()
    sigs = [(ref, test), (ref, 0.9 * test), (ref, 0.5 * ref + 0.5 * test)]
    pool = PeaqStreamPool(3, channels=2, chunk_frames=CHUNK, device="cpu")
    refs = np.stack([r for r, _ in sigs])
    tests = np.stack([t for _, t in sigs])
    cut = 17_321
    pool.feed(refs[:, :cut], tests[:, :cut])
    pool.feed(refs[:, cut:], tests[:, cut:])
    got = pool.finalize()
    jpool = JS.PeaqStreamPool(3, channels=2, chunk_frames=CHUNK,
                              dtype="float64")
    for leaf, jleaf in zip(CK.tree_flatten(pool.state),
                           jax.tree.flatten(jpool.state)[0]):
        assert tuple(leaf.shape) == jleaf.shape
    for i, (r, t) in enumerate(sigs):
        s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
        s.feed(r, t)
        want = s.finalize()
        assert abs(got.odg[i] - want.odg) <= 1e-12, i
        for name, w in want.movs.items():
            assert abs(got.movs[name][i] - w) <= 1e-12 * (1 + abs(w)), name
    with pytest.raises(ValueError, match="lockstep"):
        PeaqStreamPool(3, channels=2, device="cpu").feed(refs[:, :5],
                                                         tests[:, :6])


def test_int16_feed_bit_equal():
    """int16 PCM feeds ship raw and dequantize on the device; the result
    is bit-equal to feeding x / 32768 as float32."""
    rng = np.random.default_rng(7)
    ri = (rng.integers(-2000, 2000, (N, 2)) * 8).astype(np.int16)
    ti = (ri * 0.9).astype(np.int16)
    results = []
    for r, t in ((ri, ti), (ri.astype(np.float32) / 32768.0,
                            ti.astype(np.float32) / 32768.0)):
        s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
        feed(s, r, t)
        results.append(s.finalize())
    got, want = results
    assert got.odg == want.odg or (np.isnan(got.odg) and np.isnan(want.odg))
    for name, w in want.movs.items():
        g = got.movs[name]
        assert g == w or (np.isnan(g) and np.isnan(w)), (name, g, w)


def test_trailing_silence_keeps_committed():
    """Trailing silence leaves the committed value alone (quiet-tail
    suppression, src/movaccum.c:34-41): once the pair's own frames are
    processed, chunks of silence change no reading, and the final result
    is the one-shot peaq's of the whole program."""
    ref, test = stereo_pair()
    silence = np.zeros((16 * 1024, 2), np.float32)
    s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
    s.feed(ref, test)
    s.feed(silence, silence)
    before = s.current()
    s.feed(silence, silence)
    assert s.current() == before
    got = s.finalize()
    want = api.peaq(np.concatenate([ref, silence, silence]),
                    np.concatenate([test, silence, silence]),
                    dtype="float64", device="cpu")
    assert_result(got, want, SELF_BAR)


def test_current_mid_stream_is_finite():
    """current() reads any prefix; finalize() twice gives one result."""
    ref, test = stereo_pair()
    s = PeaqStream(channels=2, chunk_frames=CHUNK, device="cpu")
    feed(s, ref, test)
    assert np.isfinite(s.current().di)
    first = s.finalize()
    assert s.finalize() == first
    with pytest.raises(RuntimeError, match="finalized"):
        s.feed(ref[:10], test[:10])


def test_stream_needs_cuda_unless_cpu(monkeypatch):
    """device=None means CUDA and raises without it: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PeaqStream(), lambda: PeaqStreamPool(2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
