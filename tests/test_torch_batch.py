"""The port's batched PEAQ, gstpeaq_tpu_torch.parallel.batch, on the CPU in
float64: against the JAX package's peaq_batch, against the port's own
per-pair peaq, across microbatch sizes, and the PCM16 ship.

The pairs are drift corpus v2 items (stereo, program-like, so no ODG
saturates and the bandwidth MOVs are open) cut to mixed lengths, so that
they share a bucket of more frames than most of them have; granularity 8
and microbatch 2 leave a last chunk padded with a duplicate.
"""

import functools

import numpy as np
import pytest
import torch

from gstpeaq_tpu import constants as JC
from gstpeaq_tpu.parallel import batch as JB
from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch.ops import framing
from gstpeaq_tpu_torch.parallel import batch as PB
from gstpeaq_tpu_torch.tools import bench as TB
from gstpeaq_tpu_torch.utils import benchpairs
from gstpeaq_tpu_torch.utils import corpus

BAR = 1e-9            # port against JAX: ODG, DI; MOVs times (1 + |w|)
SELF_BAR = 1e-12      # batch against the port's per-pair peaq
KW = dict(granularity=8, microbatch=2, dtype="float64")


@functools.cache
def pairs():
    """Three stereo corpus items at 40 * 1024 + 3000 i samples."""
    refs, tests = corpus.realistic_pairs(3, 1.0)
    n = [40 * 1024 + 3000 * i for i in range(3)]
    return ([r[:k] for r, k in zip(refs, n)],
            [t[:k] for t, k in zip(tests, n)])


@functools.cache
def port_batch(advanced: bool):
    return PB.peaq_batch(*pairs(), advanced=advanced, device="cpu", **KW)


def assert_within(got, want, bar):
    """got/want: peaq_batch dicts; NaN where the other is NaN."""
    for key in ("odg", "di", "movs"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        assert np.array_equal(np.isnan(g), np.isnan(w)), key
        ok = ~np.isnan(w)
        scale = 1.0 + np.abs(w[ok]) if key == "movs" else 1.0
        assert np.all(np.abs(g[ok] - w[ok]) <= bar * scale), (key, g, w)


@pytest.mark.parametrize("advanced", [False, True])
def test_batch_matches_jax_peaq_batch(advanced):
    """Port peaq_batch against JAX peaq_batch on the same pairs, buckets
    and microbatches: ODG and DI within 1e-9, each MOV within
    1e-9 (1 + |w|)."""
    want = JB.peaq_batch(*pairs(), advanced=advanced, **KW)
    got = port_batch(advanced)
    assert got["movs"].shape == (3, 5 if advanced else 11)
    assert np.isfinite(got["odg"]).all()
    assert_within(got, want, BAR)


@pytest.mark.parametrize("advanced", [False, True])
def test_batch_equals_per_pair_peaq(advanced):
    """Bucket padding changes no pair: peaq_batch equals the port's
    per-pair peaq (each pair at its own frame counts) within 1e-12."""
    names = JC.MOV_ADVANCED_NAMES if advanced else JC.MOV_BASIC_NAMES
    singles = [api.peaq(r, t, advanced=advanced, dtype="float64",
                        device="cpu") for r, t in zip(*pairs())]
    want = {"odg": [s.odg for s in singles], "di": [s.di for s in singles],
            "movs": [[s.movs[n] for n in names] for s in singles]}
    assert_within(port_batch(advanced), want, SELF_BAR)


def test_microbatch_remainder_equals_one_chunk():
    """Five pairs in microbatches of 2 (the last chunk padded with a
    duplicate) equal one chunk of 8, within 1e-12."""
    refs, tests = pairs()
    refs, tests = refs + refs[:2], tests + tests[::-1][:2]
    kw = dict(granularity=8, dtype="float64", device="cpu")
    timings = {}
    two = PB.peaq_batch(refs, tests, microbatch=2, timings=timings, **kw)
    eight = PB.peaq_batch(refs, tests, microbatch=8, **kw)
    assert two["odg"].shape == (5,)
    assert set(timings) == {"stage", "dispatch", "first_sync", "drain"}
    assert_within(two, eight, SELF_BAR)


@pytest.mark.parametrize("advanced", [False, True])
def test_pcm16_ship_equals_float(advanced):
    """int16 sources ship raw and dequantize on the device; on
    int16-representable sources the results equal the float ship's bit
    for bit (the 1/32768 scale is a power of two)."""
    refs, tests = pairs()
    q = [np.clip(np.round(s * 32768.0), -32768, 32767)
         for s in (*refs[:2], *tests[:2])]
    fl = [np.float32(x / 32768.0) for x in q]
    i16 = [x.astype(np.int16) for x in q]
    sig, _ = PB.prepare_chunk(i16[:2], i16[2:], (64,))
    assert sig.dtype == torch.int16
    kw = dict(advanced=advanced, device="cpu", **KW)
    out_f = PB.peaq_batch(fl[:2], fl[2:], **kw)
    out_i = PB.peaq_batch(i16[:2], i16[2:], **kw)
    for key in ("odg", "di", "movs"):
        np.testing.assert_array_equal(out_i[key], out_f[key])


def test_buckets_match_jax():
    """bucket_frames and compute_buckets equal JAX's over a sweep of
    lengths and granularities, the FB grid's lcm-256 rule included."""
    rng = np.random.default_rng(0)
    for g in (1, 8, 31, 32, 48, 64, 100):
        for n in (0, 1, g - 1, g, g + 1, 1000, 4097):
            assert PB.bucket_frames(n, g) == JB.bucket_frames(n, g)
        lengths = rng.integers(1000, 500_000, size=(4, 2))
        refs = [np.zeros((int(a), 1), np.float32) for a, _ in lengths]
        tests = [np.zeros((int(b), 1), np.float32) for _, b in lengths]
        for advanced in (False, True):
            assert PB.compute_buckets(refs, tests, advanced, g) == \
                JB.compute_buckets(refs, tests, advanced, g)


def test_prepare_chunk_layout():
    """One [2(ref, test), B, CH, T] array (prepare_batch: prepare_chunk
    at the pairs' buckets): basic truncates each pair at its own flush
    frame, advanced (the unified input) at T; valid holds each pair's own
    frame counts per path."""
    refs, tests = pairs()
    for advanced in (False, True):
        buckets = PB.compute_buckets(refs, tests, advanced, 8)
        sig, valid = PB.prepare_batch(refs, tests, advanced, 8)
        assert sig.shape[-1] == max((buckets[0] + 1) * 1024,
                                    192 * buckets[-1] if advanced else 0)
        t = sig.shape[-1]
        assert sig.shape[:3] == (2, 3, 2) and sig.dtype == torch.float32
        assert valid.shape == (len(buckets), 3)
        for i, (r, s) in enumerate(zip(refs, tests)):
            n_fft = framing.num_frames(len(r), len(s), 2048, 1024)
            assert valid[0, i] == n_fft
            keep = t if advanced else (n_fft + 1) * 1024
            take = min(keep, len(r))
            np.testing.assert_array_equal(sig[0, i, :, :take].numpy(),
                                          r[:take].T)
            assert not sig[0, i, :, take:].any()


def test_bench_staged_batch_equals_peaq_batch():
    """tools/bench.py times a batch staged in microbatches (its last chunk
    not padded with duplicates): it scores what peaq_batch scores, within
    1e-12."""
    pairs = benchpairs.make_pairs(3, 1.0)
    dispatch = TB.staged(True, "float64", 2, pairs, device="cpu")
    got = np.concatenate([out.numpy() for out in dispatch()])
    want = PB.peaq_batch(*pairs, advanced=True, microbatch=2,
                         dtype="float64", device="cpu")
    assert got.shape == (3, 7)
    assert_within({"odg": got[:, 0], "di": got[:, 1], "movs": got[:, 2:]},
                  want, SELF_BAR)


def test_peaq_batch_needs_cuda_unless_cpu(monkeypatch):
    """device=None means CUDA and raises without it: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PB.peaq_batch(*pairs())
    with pytest.raises(ValueError, match="dtype"):
        PB.peaq_batch(*pairs(), dtype="bfloat16", device="cpu")
