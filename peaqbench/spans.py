"""The port's own spans in a torch.profiler trace of a traced window.

While a profiler runs, the port opens `record_function` ranges named
`peaq.*` at its layer boundaries (gstpeaq_tpu_torch/utils/trace.py): the
batch layer's `peaq.batch.dispatch` around the layer spans `peaq.fft_ear`,
`peaq.fb_ear`, `peaq.band` and `peaq.movs`, and `peaq.batch.results`.  The
profiler stamps them on the timeline of its device trace, where host and
device stamps can drift apart by microseconds (`Program.launch_lags`
shows by how much).  `reduce` keeps:

- the program's spans: name, start, end and the span around each;
- the host's blocking CUDA runtime calls (`WAITS`), each with the
  innermost program span it was made in, or none;
- every device operation with the innermost program span that launched
  it, or none.  The link is the profiler's own: a device operation and
  the runtime call that launched it share a correlation id, and the call
  lies in the host ranges open when it was made.  No kernel name is read.

`Program.readings()` gives the per-microbatch numbers that per-layer
metrics of these spans read, and `idle_gaps` names a window's idle gaps by
the loop range, the program span and the blocking call the host was in
when each began.  `tracing.reduce` does not call `reduce`: that takes an
edit to it and to `Trace.idle_gaps`.  Until then

    python3 -m peaqbench.spans --workload basic.sweep --seed 7 --seconds 10

runs a cell as run.py does, traced, with this reduction beside
`tracing.reduce`: it prints run.py's result line, then one JSON line of
the program's readings.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

from . import tracing

PROGRAM_PREFIX = "peaq."
# the CUDA runtime calls that hold the host until the device has done the
# work queued before them
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
         "cudaMemcpy3D")
# a device-side mirror of a host range is no operation
MIRRORS = (tracing.LOOP_PREFIX, PROGRAM_PREFIX)


def innermost(event, index: dict):
    """The index of the innermost program span around a host event (the
    event itself excluded), or None."""
    parent = event.cpu_parent
    while parent is not None and id(parent) not in index:
        parent = parent.cpu_parent
    return None if parent is None else index[id(parent)]


@dataclasses.dataclass
class Program:
    """The program's spans [(name, start_us, end_us, parent)], its blocking
    calls [(call, start_us, end_us, span)] and the device operations
    [(name, start_us, end_us, span, launched_us)] of a traced window of
    `microbatches` microbatches; a parent or span is an index into
    `spans`, or None, and `launched_us` the start of the runtime call that
    launched the operation, or None."""
    spans: list
    waits: list
    ops: list
    microbatches: int

    def name_of(self, span) -> str | None:
        return None if span is None else self.spans[span][0]

    def host_ms(self, *names) -> float:
        """Host ms a microbatch inside the spans of these names."""
        return sum(e - s for n, s, e, _ in self.spans
                   if n in names) / 1e3 / self.microbatches

    def device_ms(self, name: str | None) -> float:
        """Device ms a microbatch of the operations launched with the
        span `name` innermost (None: outside every span)."""
        return sum(e - s for _, s, e, span, _ in self.ops
                   if self.name_of(span) == name) / 1e3 / self.microbatches

    def program_waits(self) -> list:
        return [w for w in self.waits if w[3] is not None]

    def launched_early(self) -> int:
        """Device operations that start before the span that launched them
        (0 where the host ranges and the device share one clock)."""
        return sum(1 for _, s, _, span, _ in self.ops
                   if span is not None and s < self.spans[span][1])

    def launch_lags(self, parts: int = 10) -> list:
        """The least lag, us, from a launch call's start to its operation's
        start in each of `parts` equal slices of the window's launches: on
        one clock, positive and level; a trend is a drift between the host's
        and the device's clocks."""
        lags = sorted((t, s - t) for _, s, _, _, t in self.ops
                      if t is not None)
        if not lags:
            return []
        first, width = lags[0][0], lags[-1][0] - lags[0][0] or 1.0
        least = [None] * parts
        for t, lag in lags:
            k = min(int((t - first) / width * parts), parts - 1)
            least[k] = lag if least[k] is None else min(least[k], lag)
        return least

    def readings(self) -> dict:
        """The per-microbatch readings; none where the trace holds no
        program span, and a layer's only where its span opened."""
        names = {n for n, *_ in self.spans}
        if not names:
            return {}
        waits = self.program_waits()
        out = {"dispatch_host_ms": self.host_ms("peaq.batch.dispatch",
                                                "peaq.batch.results"),
               "host_wait_ms": sum(e - s for _, s, e, _ in waits)
               / 1e3 / self.microbatches,
               "host_syncs": len(waits) / self.microbatches}
        for layer in ("fft_ear", "fb_ear", "band", "movs"):
            if PROGRAM_PREFIX + layer in names:
                out[f"{layer}_span_ms"] = self.device_ms(
                    PROGRAM_PREFIX + layer)
        out["unspanned_ms"] = self.device_ms(None)
        return out


def reduce(prof, microbatches: int) -> Program:
    """The Program of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType
    events = prof.events()
    host = [ev for ev in events if ev.device_type == DeviceType.CPU]
    marks = [ev for ev in host if ev.name.startswith(PROGRAM_PREFIX)]
    index = {id(ev): i for i, ev in enumerate(marks)}
    spans = [(ev.name, ev.time_range.start, ev.time_range.end,
              innermost(ev, index)) for ev in marks]
    # the runtime calls by correlation id (operators number apart)
    calls = {ev.id: ev for ev in host if ev.name.startswith("cu")}
    waits = [(ev.name, ev.time_range.start, ev.time_range.end,
              innermost(ev, index)) for ev in calls.values()
             if ev.name in WAITS]
    ops = []
    for ev in events:
        if ev.device_type != DeviceType.CUDA or ev.name.startswith(
                MIRRORS) or getattr(ev, "is_user_annotation", False):
            continue
        call = calls.get(ev.id)
        ops.append((ev.name, ev.time_range.start, ev.time_range.end)
                   + ((None, None) if call is None else
                      (innermost(call, index), call.time_range.start)))
    return Program(spans, sorted(waits, key=lambda w: w[1]), ops,
                   microbatches)


def idle_gaps(trace: tracing.Trace, program: Program, n: int = 10) -> list:
    """`trace.idle_gaps(n)` with each gap's loop range followed by the
    innermost program span the host was in when it began and, where the
    host was then in a blocking call, the call."""
    gaps, reach = [], None
    for _, s, e, _ in sorted(trace.ops, key=lambda o: o[1]):
        if reach is not None and s > reach:
            gaps.append((reach, s))
        reach = e if reach is None else max(reach, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        what = next((name for name, rs, re_ in trace.ranges
                     if rs <= s < re_), "host")
        inside = [sp for sp in program.spans if sp[1] <= s < sp[2]]
        if inside:
            what += "/" + max(inside, key=lambda sp: sp[1])[0]
            call = next((w[0] for w in program.waits
                         if w[1] <= s < w[2]), None)
            if call is not None:
                what += "/" + call
        named.append([f"{what} (gap at {s / 1e6:.6f} s)", (e - s) / 1e6])
    return named


def report(program: Program, trace: tracing.Trace) -> dict:
    """The readings beside what checks them: the layer spans' ms and the
    unspanned ms, summed, against the trace's device ms; the operations
    both count; the operations that start before their span; the named
    gaps; each span's host and device ms a microbatch."""
    readings = program.readings()
    covered = sum(v for k, v in readings.items()
                  if k.endswith("_span_ms") or k == "unspanned_ms")
    per = {}
    for name, s, e, _ in program.spans:
        row = per.setdefault(name, {"opened": 0, "host_ms": 0.0})
        row["opened"] += 1 / program.microbatches
        row["host_ms"] += (e - s) / 1e3 / program.microbatches
    for name in per:
        per[name]["device_ms"] = program.device_ms(name)
    return {"readings": readings,
            "device_ms": trace.device_ms() if trace.ops else None,
            "layers_and_unspanned_ms": covered,
            "device_ops": len(trace.ops) / trace.microbatches,
            "program_ops": len(program.ops) / program.microbatches,
            "launched_early": program.launched_early(),
            "launch_lag_us": program.launch_lags(),
            "idle_gaps": idle_gaps(trace, program),
            "spans": per}


def main(argv=None) -> int:
    """run.py's traced run of a cell, with the program's reduction."""
    # one host thread, set as run.py sets it, before torch loads
    os.environ["OMP_NUM_THREADS"] = "1"
    from . import harness, run
    argv = list(sys.argv[1:] if argv is None else argv)
    held = {}
    plain_reduce, plain_run = tracing.reduce, harness.run_cell

    def reduce_both(prof, rules, microbatches, window_s):
        held["program"] = reduce(prof, microbatches)
        held["trace"] = plain_reduce(prof, rules, microbatches, window_s)
        return held["trace"]

    def run_cell(*args, **kwargs):
        held["result"] = plain_run(*args, **kwargs)
        return held["result"]

    tracing.reduce, harness.run_cell = reduce_both, run_cell
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        tracing.reduce, harness.run_cell = plain_reduce, plain_run
    if rc or "program" not in held:
        return rc or 1
    trace, result = held["trace"], held["result"][0]
    out = report(held["program"], trace)
    # microbatches a second: the traced window's dispatched ones over its
    # length, the measured window's answered ones over its own
    out["rates"] = {"traced_mb_per_s": trace.microbatches / trace.window_s,
                    "untraced_mb_per_s": result["run"]["in_window"]
                    / result["run"]["window_s"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
