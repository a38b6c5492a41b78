"""The port's data parallelism over several devices (parallel/shard.py and
the multi-device PeaqStreamPool), on the CPU, where a list of devices
repeats "cpu".

Tolerances: peaq_sharded against the port's peaq_batch within 1e-12 (ODG,
DI; MOVs times 1 + |w|) in float64, and against the JAX package's
peaq_batch within 1e-9; train_cognitive_sharded over eight shards against
the JAX package's on its eight virtual CPU devices within 1e-12 relative
(losses and parameters); the two-part pool against the one-device pool
within 1e-12, and its checkpoint leaf for leaf.
"""

import numpy as np
import pytest
import torch

from gstpeaq_tpu.parallel import batch as JB
from gstpeaq_tpu.parallel import shard as JS
from gstpeaq_tpu_torch import PeaqStreamPool
from gstpeaq_tpu_torch.parallel import batch as PB
from gstpeaq_tpu_torch.parallel import shard as PS
from gstpeaq_tpu_torch.utils import checkpoint as CK
from gstpeaq_tpu_torch.utils import testsignals as TS


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def close(got: dict, want: dict, bar: float) -> None:
    for key in ("odg", "di"):
        assert np.abs(got[key] - want[key]).max() <= bar, key
    assert (np.abs(got["movs"] - want["movs"])
            / (1 + np.abs(want["movs"]))).max() <= bar


@pytest.fixture(scope="module")
def pairs():
    """Five ~2 s mono pairs of different lengths."""
    n = 96 * 1024
    refs = [TS.saw(n + 3000 * i, 440.0 + 50 * i) for i in range(5)]
    tests = [TS.triangle(n + 3000 * i, 440.0 + 50 * i) for i in range(5)]
    return refs, tests


@pytest.fixture(scope="module")
def batched(pairs):
    """The port's peaq_batch of the pairs per mode, in float64."""
    return {advanced: PB.peaq_batch(*pairs, advanced=advanced,
                                    granularity=8, device="cpu")
            for advanced in (False, True)}


@pytest.mark.parametrize("n_dev,advanced", [(2, False), (3, False),
                                            (2, True), (3, True)])
def test_sharded_equals_batch(pairs, batched, n_dev, advanced):
    """Five pairs over two and three shards (one and one padding pair):
    the port's peaq_batch within 1e-12."""
    got = PS.peaq_sharded(*pairs, devices=["cpu"] * n_dev,
                          advanced=advanced, granularity=8, microbatch=2)
    assert got["odg"].shape == (5,) and np.isfinite(got["odg"]).all()
    close(got, batched[advanced], 1e-12)


@pytest.mark.parametrize("advanced", [False, True])
def test_sharded_matches_jax_batch(pairs, batched, advanced):
    """The port's sharded run against the JAX package's peaq_batch within
    1e-9."""
    got = PS.peaq_sharded(*pairs, devices=["cpu"] * 2, advanced=advanced,
                          granularity=8)
    want = JB.peaq_batch(*pairs, advanced=advanced, granularity=8)
    close(got, {k: np.asarray(v) for k, v in want.items()}, 1e-9)


def test_default_devices_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.default_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.peaq_sharded([np.zeros(4096)], [np.zeros(4096)])


@pytest.mark.parametrize("advanced,n", [(False, 64), (True, 61)])
def test_train_sharded_matches_jax(advanced, n):
    """Ten steps over eight shards (61 examples: three padded from the
    first ones) against the JAX package's over its eight virtual CPU
    devices: losses and parameters within 1e-12; the loss decreases."""
    import jax
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(5 + advanced)
    movs = rng.standard_normal((n, 5 if advanced else 11)) * 10 + 50
    target = rng.standard_normal(n)
    params, losses = PS.train_cognitive_sharded(
        movs, target, devices=["cpu"] * 8, advanced=advanced, steps=10)
    jparams, jlosses = JS.train_cognitive_sharded(movs, target,
                                                  advanced=advanced,
                                                  steps=10)
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert rel(losses, jlosses) < 1e-12
    for name, p in params.items():
        assert p.dtype == torch.float64 and not p.requires_grad
        assert rel(p, jparams[name]) < 1e-12, name


def test_train_sharded_equals_one_device():
    """Eight shards against one: the mean of equal shards' gradients is
    the whole batch's gradient, within 1e-12."""
    rng = np.random.default_rng(9)
    movs = rng.standard_normal((64, 11)) * 10 + 50
    target = rng.standard_normal(64)
    p8, l8 = PS.train_cognitive_sharded(movs, target, devices=["cpu"] * 8,
                                        steps=5)
    p1, l1 = PS.train_cognitive_sharded(movs, target, devices=["cpu"],
                                        steps=5)
    assert rel(l8, l1) < 1e-12
    for name in p1:
        assert rel(p8[name], p1[name]) < 1e-12, name


def leaf_close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Floating leaves: NaN where want is NaN, and within 1e-12 of want's
    largest finite value elsewhere; other leaves equal."""
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    d = np.abs(got[~nan] - want[~nan]).max(initial=0.0)
    assert d <= 1e-12 * np.abs(want[~nan]).max(initial=0.0), what


def feed_pieces(pool, refs, tests, lo, hi, piece=9000):
    for start in range(lo, hi, piece):
        stop = min(start + piece, hi)
        pool.feed(refs[:, start:stop], tests[:, start:stop])


@pytest.mark.parametrize("advanced", [False, True])
def test_two_part_pool_equals_one_device(tmp_path, advanced):
    """A pool of four stereo streams over ["cpu", "cpu"] (two parts of two)
    against the pool on one device: current() mid-stream and after
    finalize within 1e-12; the checkpoints leaf for leaf, with the same
    keys, dtypes, shapes and NaNs, each leaf within 1e-12 of its largest
    value; the one-device pool's checkpoint resumed in a two-part pool
    gives the same result."""
    rng = np.random.default_rng(21 + advanced)
    t = 96 * 1024               # past the MOV gates' 25 frames at t / 2
    tone = np.arange(t)[None, :, None] / 48000.0 * np.array(
        [[[440.0, 550.0]], [[3500.0, 3300.0]], [[9200.0, 9400.0]]])
    refs = np.stack([
        (0.3 * np.sin(2 * np.pi * (1 + 0.1 * i) * tone[0])
         + 0.1 * np.sin(2 * np.pi * tone[1]) + 0.03 * np.sin(
             2 * np.pi * tone[2]) + 2e-5 * rng.standard_normal((t, 2)))
        for i in range(4)]).astype(np.float32)
    tests = (refs + 0.01 * rng.standard_normal((4, t, 2))).astype(np.float32)
    kw = dict(channels=2, chunk_frames=4, advanced=advanced, dtype="float64")
    one = PeaqStreamPool(4, device="cpu", **kw)
    two = PeaqStreamPool(4, device=["cpu", "cpu"], **kw)
    for pool in (one, two):
        feed_pieces(pool, refs, tests, 0, t // 2)

    def agree(a, b):
        assert np.isfinite(b.odg).all()
        assert np.abs(a.odg - b.odg).max() <= 1e-12
        for name in b.movs:
            assert (np.abs(a.movs[name] - b.movs[name])
                    <= 1e-12 * (1 + np.abs(b.movs[name]))).all(), name

    agree(two.current(), one.current())
    CK.save_state(str(tmp_path / "one"), one.state)
    CK.save_state(str(tmp_path / "two"), two.state)
    with np.load(str(tmp_path / "one.npz")) as a, \
            np.load(str(tmp_path / "two.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and \
                a[key].shape == b[key].shape, key
            leaf_close(b[key], a[key], key)
    resumed = PeaqStreamPool(4, device=["cpu", "cpu"], **kw)
    resumed.state = CK.load_state(str(tmp_path / "one"), resumed.state)
    resumed._parts[0].pending = [[b[:2].copy() for b in bufs]
                                 for bufs in one._parts[0].pending]
    resumed._parts[1].pending = [[b[2:].copy() for b in bufs]
                                 for bufs in one._parts[0].pending]
    for pool in (one, two, resumed):
        feed_pieces(pool, refs, tests, t // 2, t)
    final = one.finalize()
    agree(two.finalize(), final)
    agree(resumed.finalize(), final)


def test_pool_devices_must_divide_streams():
    with pytest.raises(ValueError, match="multiple"):
        PeaqStreamPool(3, device=["cpu", "cpu"])
