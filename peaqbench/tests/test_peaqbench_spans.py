"""The reduction of the program's spans (peaqbench/spans.py) on a made-up
event list: two program spans in the loop's submit range, a blocking call,
device operations launched inside and outside them, and the spans' device
mirrors.  Its fields, the readings' arithmetic and the gap names; then the
trace reduction and every existing reader, unchanged by the program's
events; then the spans of a small run of the harness on the CPU."""

import pathlib
import types

import pytest
from torch.autograd import DeviceType

from peaqbench import client, harness, roofline, spans, tracing

ROOT = pathlib.Path(__file__).resolve().parents[2]
RULES = tracing.kernel_table(ROOT / "peaqbench" / "kernels")
MB = 2


class Event:
    """What the reductions read of a torch.profiler FunctionEvent."""

    def __init__(self, name, start, end, parent=None, id=0, device=False,
                 mark=False):
        self.name = name
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.cpu_parent = parent
        self.id = id
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = mark


class Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def canned(program=True):
    """The event list, in us; without the program's spans and their
    mirrors when `program` is false (a program without spans)."""
    ev = []

    def host(name, start, end, parent=None, id=0, mark=False):
        if name.startswith("peaq.") and not program:
            return parent
        ev.append(Event(name, start, end, parent, id, mark=mark))
        return ev[-1]

    def device(name, start, end, id=0, mark=False):
        if name.startswith("peaq.") and not program:
            return
        ev.append(Event(name, start, end, None, id, True, mark))

    submit = host("peaqbench.submit", 0, 1000, mark=True)
    dispatch = host("peaq.batch.dispatch", 10, 755, submit, mark=True)
    fft = host("peaq.fft_ear", 20, 300, dispatch, mark=True)
    mul = host("aten::mul", 30, 60, fft)
    host("cudaLaunchKernel", 40, 50, mul, id=101)
    device("at::native::mul_kernel", 100, 200, id=101)
    # a hand kernel through ctypes: its launch sits in the span itself
    host("cudaLaunchKernel", 70, 80, fft, id=102)
    device("void fir_bank_kernel<double>()", 200, 260, id=102)
    movs = host("peaq.movs", 300, 750, dispatch, mark=True)
    where = host("aten::where", 302, 308, movs, id=101)   # an operator's id
    host("cudaLaunchKernel", 304, 306, where, id=103)
    device("at::native::where_kernel", 310, 400, id=103)
    copy = host("aten::copy_", 310, 700, movs)
    host("cudaMemcpyAsync", 320, 330, copy, id=104)
    device("Memcpy HtoD (Pageable -> Device)", 600, 601, id=104)
    host("cudaStreamSynchronize", 330, 690, copy, id=105)
    add = host("aten::add", 705, 720, movs)
    host("cudaLaunchKernel", 712, 718, add, id=106)
    device("at::native::add_kernel", 720, 760, id=106)
    results = host("peaq.batch.results", 760, 800, submit, mark=True)
    cat = host("aten::cat", 765, 790, results)
    host("cudaLaunchKernel", 770, 775, cat, id=107)
    device("at::native::cat_kernel", 780, 805, id=107)
    out = host("aten::copy_", 910, 950, submit)
    host("cudaMemcpyAsync", 920, 930, out, id=108)
    device("Memcpy DtoH (Device -> Pinned)", 1100, 1110, id=108)
    wait = host("peaqbench.wait", 1000, 1500, mark=True)
    host("cudaEventSynchronize", 1000, 1490, wait, id=109)
    # the ranges' mirrors on the device timeline
    device("peaqbench.submit", 100, 805, mark=True)
    device("peaq.batch.dispatch", 100, 760, mark=True)
    device("peaq.movs", 310, 760, mark=True)
    return ev


def program():
    return spans.reduce(Profile(canned()), MB)


def test_reduce_keeps_spans_waits_and_launches():
    p = program()
    assert [(n, s, e, p.name_of(par)) for n, s, e, par in p.spans] == [
        ("peaq.batch.dispatch", 10, 755, None),
        ("peaq.fft_ear", 20, 300, "peaq.batch.dispatch"),
        ("peaq.movs", 300, 750, "peaq.batch.dispatch"),
        ("peaq.batch.results", 760, 800, None)]
    assert [(c, s, e, p.name_of(sp)) for c, s, e, sp in p.waits] == [
        ("cudaStreamSynchronize", 330, 690, "peaq.movs"),
        ("cudaEventSynchronize", 1000, 1490, None)]
    assert [(o[0], p.name_of(o[3])) for o in p.ops] == [
        ("at::native::mul_kernel", "peaq.fft_ear"),
        ("void fir_bank_kernel<double>()", "peaq.fft_ear"),
        ("at::native::where_kernel", "peaq.movs"),
        ("Memcpy HtoD (Pageable -> Device)", "peaq.movs"),
        ("at::native::add_kernel", "peaq.movs"),
        ("at::native::cat_kernel", "peaq.batch.results"),
        ("Memcpy DtoH (Device -> Pinned)", None)]
    assert p.launched_early() == 0
    # launched at 40, 70, 304, 320 | none | 712, 770, 920, and started 60,
    # 130, 6, 280 | | 8, 10, 180 us later
    assert p.launch_lags(3) == [6, None, 8]


def test_an_operation_before_its_span_is_counted():
    events = canned()
    kernel = next(e for e in events if e.name == "at::native::mul_kernel")
    kernel.time_range.start = 15                  # before peaq.fft_ear, 20
    assert spans.reduce(Profile(events), MB).launched_early() == 1


def test_readings():
    r = program().readings()
    assert r == pytest.approx({
        "dispatch_host_ms": (745 + 40) / 1e3 / MB,
        "host_wait_ms": 360 / 1e3 / MB,        # the loop's wait not counted
        "host_syncs": 1 / MB,
        "fft_ear_span_ms": (100 + 60) / 1e3 / MB,
        "movs_span_ms": (90 + 1 + 40) / 1e3 / MB,
        "unspanned_ms": 10 / 1e3 / MB})
    # no reading of a span that never opened, none at all without spans
    assert "band_span_ms" not in r and "fb_ear_span_ms" not in r
    assert spans.reduce(Profile(canned(False)), MB).readings() == {}


def test_the_layers_and_the_rest_sum_to_the_device_ms():
    p = program()
    trace = tracing.reduce(Profile(canned()), RULES, MB, 2e-3)
    report = spans.report(p, trace)
    assert report["device_ms"] == pytest.approx(326 / 1e3 / MB)
    # the results' cat is neither a layer's nor unspanned
    assert report["layers_and_unspanned_ms"] == pytest.approx(
        (326 - 25) / 1e3 / MB)
    assert report["device_ops"] == report["program_ops"] == 7 / MB
    assert report["spans"]["peaq.movs"] == pytest.approx(
        {"opened": 0.5, "host_ms": 0.225, "device_ms": 0.0655})


def test_gaps_named_by_program_span_and_call():
    trace = tracing.reduce(Profile(canned()), RULES, MB, 2e-3)
    names = [(name.split(" (")[0], round(s * 1e6))
             for name, s in spans.idle_gaps(trace, program())]
    assert names == [
        ("peaqbench.submit", 295),                  # outside every span
        ("peaqbench.submit/peaq.movs/cudaStreamSynchronize", 200),
        ("peaqbench.submit/peaq.movs/cudaStreamSynchronize", 119),
        ("peaqbench.submit/peaq.fft_ear", 50),
        ("peaqbench.submit/peaq.batch.results", 20)]
    # the gap's place as trace.idle_gaps gives it
    assert [g[0].split(" (")[1] for g in spans.idle_gaps(
        trace, program())] == [g[0].split(" (")[1]
                               for g in trace.idle_gaps()]


def run_of(t):
    window = client.Window(0.0, 1.0, [object()] * 4, [], 0.02)
    return harness.Run({}, {}, window, 2**30, t,
                       roofline.ear_work("basic", "float64", 2, 2, 48000))


def test_the_trace_and_its_readers_unchanged_by_the_spans():
    with_spans = tracing.reduce(Profile(canned()), RULES, MB, 2e-3)
    without = tracing.reduce(Profile(canned(False)), RULES, MB, 2e-3)
    assert with_spans == without
    assert not any(name.startswith("peaq.") for name, *_ in with_spans.ops)
    assert with_spans.busy_s() == without.busy_s()
    assert with_spans.top_ops() == without.top_ops()
    assert with_spans.idle_gaps() == without.idle_gaps()
    bench = harness.Bench(ROOT)
    for m in bench.spec["per_layer"]:
        read = bench.reader(m["name"])
        assert read(run_of(with_spans)) == read(run_of(without)), m["name"]


@pytest.mark.parametrize("name,layers", [
    ("basic.sweep", {"fft_ear", "band", "movs"}),
    ("advanced.sweep", {"fft_ear", "fb_ear", "band", "movs"})])
def test_a_small_traced_run_of_the_harness(monkeypatch, name, layers):
    """The spans of a traced run on the CPU: each microbatch's dispatch,
    results and layer spans, no device operation and no wait."""
    held = {}
    plain = tracing.reduce

    def reduce_both(prof, rules, microbatches, window_s):
        held["program"] = spans.reduce(prof, microbatches)
        return plain(prof, rules, microbatches, window_s)

    monkeypatch.setattr(tracing, "reduce", reduce_both)
    harness.run_cell(harness.Bench(ROOT), name, 2**31 + 24, 0.2, True,
                     "cpu", overrides={"item_seconds": 1.0, "microbatch": 2,
                                       "pool_microbatches": 2,
                                       "trace_seconds": 0.2})
    p = held["program"]
    opened = {}
    for n, *_, parent in p.spans:
        opened[n] = opened.get(n, 0) + 1
        assert (p.name_of(parent) == "peaq.batch.dispatch") == (
            n not in ("peaq.batch.dispatch", "peaq.batch.results"))
    assert opened["peaq.batch.dispatch"] == p.microbatches
    assert opened["peaq.batch.results"] == p.microbatches
    r = p.readings()
    assert r["dispatch_host_ms"] > 0 and r["host_syncs"] == 0
    assert {k[:-len("_span_ms")] for k in r if k.endswith("_span_ms")} \
        == layers
