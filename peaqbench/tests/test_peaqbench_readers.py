"""The trace reduction and the per-layer readers on made-up readings: busy
time as the union of operations, layers by the kernel table, idle gaps
named by the loop's host ranges, and no reading where there is nothing to
read."""

import pathlib

import pytest

from peaqbench import client, harness, roofline, tracing

ROOT = pathlib.Path(__file__).resolve().parents[2]
RULES = tracing.kernel_table(ROOT / "peaqbench" / "kernels")


def op(name, start, end):
    return (name, start, end, tracing.layer_of(name, RULES))


def trace(ops, microbatches=2, window_s=1e-3):
    ranges = [("peaqbench.submit", 0.0, 100.0),
              ("peaqbench.wait", 100.0, 1000.0)]
    return tracing.Trace(ops, ranges, microbatches, window_s)


OPS = [op("void (anonymous namespace)::fir_bank_kernel<double>()", 10, 110),
       op("void (anonymous namespace)::pair_frames_kernel<float, double>()",
          50, 150),                               # overlaps the first
       op("void (anonymous namespace)::band_movs_kernel<2>()", 300, 400),
       op("Memcpy DtoH (Device -> Pinned)", 420, 430)]


def test_trace_sums():
    t = trace(OPS)
    assert t.busy_s() == pytest.approx(250e-6)    # 10-150, 300-400, 420-430
    assert t.device_ms() == pytest.approx(0.31 / 2)
    assert t.layer_ms("fb_ear") == pytest.approx(0.05)
    assert t.layer_ms("fft_ear") == pytest.approx(0.05)
    assert t.layer_ms("band") == pytest.approx(0.05)
    assert t.layer_ms("eager") == pytest.approx(0.005)
    assert [name for name, _ in t.top_ops(2)] == [OPS[0][0], OPS[1][0]]


def test_idle_gaps_named_by_the_host_range():
    gaps = trace(OPS).idle_gaps()
    assert len(gaps) == 2
    assert gaps[0][0].startswith("peaqbench.wait") and \
        gaps[0][1] == pytest.approx(150e-6)
    assert gaps[1][1] == pytest.approx(20e-6)


def run_of(t, version="advanced"):
    window = client.Window(0.0, 1.0, [object()] * 4, [], 0.02)
    return harness.Run({}, {}, window, 2**30, t,
                       roofline.ear_work(version, "float64", 2, 2, 48000))


def test_readers():
    bench = harness.Bench(ROOT)
    read = lambda name, run: bench.reader(name)(run)
    run = run_of(trace(OPS))
    assert read("enqueue_ms.sweep", run) == pytest.approx(5.0)
    assert read("peak_gib.sweep", run) == 1.0
    assert read("idle.sweep", run) == pytest.approx(75.0)
    assert read("device_ops.sweep", run) == 2.0
    assert read("fb_ear_roofline.sweep", run) == pytest.approx(
        100 * run.work["fb_ear"][0] / 0.05)
    # nothing to read: no trace, or no operation of the layer
    untraced = run_of(None)
    for m in bench.spec["per_layer"]:
        if m["name"] not in ("enqueue_ms.sweep", "peak_gib.sweep"):
            assert read(m["name"], untraced) is None, m["name"]
    basic = run_of(trace(OPS[1:]), "basic")
    assert read("fb_ear_ms.sweep", basic) is None
    assert read("fb_ear_roofline.sweep", basic) is None
