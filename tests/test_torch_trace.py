"""The port's spans (gstpeaq_tpu_torch/utils/trace.py) on the CPU: the
span tree of one microbatch through parallel.batch's `dispatch` and
`results` under torch.profiler, nothing but views launched in the batch
span outside the layer spans, no `record_function` entered while no
profiler runs, and the same bits with and without a profiler.

Two stereo corpus pairs of 40 * 1024 and 40 * 1024 + 3000 samples, basic and
advanced, float64.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch import constants as C
from gstpeaq_tpu_torch.parallel import batch as PB
from gstpeaq_tpu_torch.utils import corpus
from gstpeaq_tpu_torch.utils import trace

LAYERS = {False: {"peaq.fft_ear", "peaq.band", "peaq.movs"},
          True: {"peaq.fft_ear", "peaq.fb_ear", "peaq.band", "peaq.movs"}}
# operators that make a view of their input and launch nothing: all that
# the batch span may run outside its layer spans
VIEWS = {"aten::select", "aten::slice", "aten::unbind", "aten::as_strided",
         "aten::alias", "aten::view", "aten::unsqueeze", "aten::squeeze",
         "aten::transpose", "aten::permute", "aten::movedim",
         "aten::expand", "aten::narrow", "aten::split"}


@functools.cache
def microbatch(advanced: bool):
    """(pipeline, buckets, sig, valid): two corpus pairs of one bucket."""
    refs, tests = corpus.realistic_pairs(2, 1.0)
    refs = [r[:40 * 1024 + 3000 * i] for i, r in enumerate(refs)]
    tests = [t[:40 * 1024 + 3000 * i] for i, t in enumerate(tests)]
    pipe = PB.batch_pipeline(advanced, 92.0, C.DEFAULT_SETTINGS, "float64",
                             torch.device("cpu"))
    buckets = PB.compute_buckets(refs, tests, advanced, granularity=8)
    sig, valid = PB.prepare_chunk(refs, tests, buckets)
    return pipe, buckets, sig, valid


def score(advanced: bool) -> torch.Tensor:
    """One microbatch through `dispatch` and `results`, [B, 2 + M]."""
    pipe, buckets, sig, valid = microbatch(advanced)
    with api.full_precision_matmuls(), torch.inference_mode():
        return PB.results(PB.dispatch(pipe, buckets, sig, valid))


@functools.cache
def profiled(advanced: bool):
    """(results, the profiler's events) of one traced microbatch."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = score(advanced)
    return out, prof.events()


def span_of(event):
    """The innermost `peaq.*` range around an event (itself excluded)."""
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith(trace.PREFIX):
        parent = parent.cpu_parent
    return parent


@pytest.mark.parametrize("advanced", [False, True],
                         ids=["basic", "advanced"])
def test_span_tree(advanced):
    """One `peaq.batch.dispatch` over the layer spans of the mode, each of
    which runs operators; `peaq.batch.results` after it."""
    _, events = profiled(advanced)
    spans = [e for e in events if e.name.startswith(trace.PREFIX)]
    dispatch = [e for e in spans if e.name == "peaq.batch.dispatch"]
    results = [e for e in spans if e.name == "peaq.batch.results"]
    assert len(dispatch) == 1 and len(results) == 1
    assert span_of(dispatch[0]) is None and span_of(results[0]) is None
    layers = [e for e in spans if e not in dispatch + results]
    assert {e.name for e in layers} == LAYERS[advanced]
    for e in layers:
        assert span_of(e) is dispatch[0], e.name
    # a layer span may open more than once; each layer runs operators
    assert {e.name for e in layers if e.cpu_children} == LAYERS[advanced]
    assert results[0].time_range.start >= dispatch[0].time_range.end
    assert {c.name for c in results[0].cpu_children} >= {"aten::cat",
                                                         "aten::to"}


@pytest.mark.parametrize("advanced", [False, True],
                         ids=["basic", "advanced"])
def test_batch_span_holds_only_views_outside_the_layers(advanced):
    """Every operator in `peaq.batch.dispatch` outside each layer span is
    a view: the layer spans cover the pipeline's work."""
    _, events = profiled(advanced)
    loose = {e.name for e in events
             if not e.name.startswith(trace.PREFIX)
             and span_of(e) is not None
             and span_of(e).name == "peaq.batch.dispatch"}
    assert loose <= VIEWS, loose - VIEWS


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler running a span is one shared no-op and no
    `record_function` is made."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("batch.dispatch") is trace.span("movs")
    for advanced in (False, True):
        assert score(advanced).shape == (2, 7 if advanced else 13)


@pytest.mark.parametrize("advanced", [False, True],
                         ids=["basic", "advanced"])
def test_same_bits_with_and_without_a_profiler(advanced):
    plain = score(advanced).numpy()
    traced = profiled(advanced)[0].numpy()
    assert np.isfinite(plain).all()
    assert np.array_equal(plain, traced)
