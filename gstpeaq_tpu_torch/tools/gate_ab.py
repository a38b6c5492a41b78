#!/usr/bin/env python3
"""G1 `frame_gate` (csrc/gate.cu) of this checkout against another's, on one
CUDA card.  Run from the repository root:

    python3 gstpeaq_tpu_torch/tools/gate_ab.py --parent DIR
    python3 gstpeaq_tpu_torch/tools/gate_ab.py --split

DIR is the root of another checkout (e.g. the parent commit from `git
archive`).  Each checkout runs in a subprocess of its own, its package and
its chip_smoke.py imported from its root and its kernels built under its
own gstpeaq_tpu_torch/_build/, in the order parent, this, this, parent.
Each run takes the inputs chip_smoke.py gives G1 (its gate_cases: per pair,
edge rows, one frame, views; its batch cases: the basic batch and the
advanced batch's FFT and FB references; its stream cases: every chunk
step at 64 and 1,024 FFT frames, one stream and 16), with float32 and
float64 samples, and runs its own ops/cuda_gate.py::frame_gate on them in
both spectrum dtypes: its bits against the plain gate's, and the device
time of one call between CUDA events (chip_smoke.cuda_ms: the mean of
`calls` calls behind a sleep that covers the host's enqueue, median of 5
rounds) beside the bytes bound (chip_smoke.bound).  Prints the card's
name and power limit, a table of the four readings per dtype and case,
then one JSON object of the runs.

--split reads G1 of the checkout it runs in apart, in one process: the
build's registers and spills (chip_smoke.py phase 2) and, at each batch
case in both spectrum dtypes, the card's read floor for the same bytes
(`sig.amax()`, one PyTorch reduction that reads them once, timed as G1
is: a yardstick, not a library call, since it does not gate), G1's call,
and the call split by torch.profiler into G1's kernel and the rest of the
wrapper's device work (the output's fill where the wrapper zeroes it),
with the launch plan where the checkout has `gate_plan`.  Prints its
readings, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def gate_cases_of(S, dtype, pair10) -> list:
    """chip_smoke's G1 cases in the spectrum dtype `dtype` (module S):
    gate_cases, then those of its batch and stream cases."""
    import numpy as np
    cases = S.gate_cases(dtype, pair10)
    for c in (S.batch_cases(dtype, np.random.default_rng(1), pair10)
              + S.stream_cases(dtype, pair10)):
        if c.name == "frame_gate":
            cases.append(c)
    return cases


def child(root: str) -> None:
    """One checkout's bits and times, as a JSON line on stdout."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as S
    from gstpeaq_tpu_torch.ops import cuda_gate
    for module in (S, cuda_gate):
        assert pathlib.Path(module.__file__).resolve().is_relative_to(
            pathlib.Path(root).resolve()), module.__file__
    pair10 = S.ten_second_pair()
    out = {"root": root}
    for dtype in S.DTYPES:
        times = {}
        for c in gate_cases_of(S, dtype, pair10):
            got = c.kernel()
            same = torch.equal(got, c.plain())
            big = c.inputs[0].numel() > 4_000_000
            ms, _ = S.cuda_ms(c.kernel, calls=5 if big else 20, rounds=5,
                              cover_host=True)
            bound_ms, _ = S.bound(c.name, dtype, c.inputs, got)
            times[c.case] = {"ms": ms, "bound_ms": bound_ms, "equal": same}
            del got
        out[str(dtype).removeprefix("torch.")] = times
        S.GATE_SIGNALS.clear()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def device_split(fn, calls: int = 10) -> dict:
    """fn() under torch.profiler, `calls` times after a warm-up: the device
    ms a call of G1's kernel and of everything else."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    kernel = sum(e.self_device_time_total for e in device
                 if "frame_gate_kernel" in e.key)
    rest = sum(e.self_device_time_total for e in device) - kernel
    return {"kernel_ms": kernel / 1e3 / calls, "rest_ms": rest / 1e3 / calls,
            "rest": sorted({e.key[:60] for e in device
                            if "frame_gate_kernel" not in e.key})}


def split() -> int:
    """G1 of this checkout read apart (the module docstring's --split)."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as S
    from gstpeaq_tpu_torch import constants as C
    from gstpeaq_tpu_torch.ops import cuda_gate
    card = S.phase_card()
    S.phase_build()
    pair10 = S.ten_second_pair()
    result = {"card": card, "cases": {}}
    for dtype in S.DTYPES:
        name = str(dtype).removeprefix("torch.")
        cases = [c for c in S.batch_cases(dtype, np.random.default_rng(1),
                                          pair10)
                 if c.name == "frame_gate"]
        result["cases"][name] = {}
        for c in cases:
            sig = c.inputs[0]
            got = c.kernel()
            same = torch.equal(got, c.plain())
            bound_ms, _ = S.bound(c.name, dtype, c.inputs, got)
            floor_ms, _ = S.cuda_ms(lambda: sig.amax(), calls=5, rounds=5,
                                    cover_host=True)
            ms, _ = S.cuda_ms(c.kernel, calls=5, rounds=5, cover_host=True)
            parts = device_split(c.kernel)
            reading = dict(bound_ms=bound_ms, floor_ms=floor_ms, ms=ms,
                           equal=same, **parts)
            if hasattr(cuda_gate, "gate_plan"):
                hop = (C.FB_FRAMESIZE if "FB" in c.case
                       else C.FFT_STEPSIZE)
                plan = cuda_gate.gate_plan(
                    sig.shape[0], sig.shape[1], got.shape[-1], hop,
                    "FB" not in c.case, sig.dtype,
                    torch.cuda.get_device_properties(
                        0).multi_processor_count)
                reading["plan"] = plan._asdict()
            result["cases"][name][c.case] = reading
            print(f"  frame_gate {c.case} {dtype}: bits equal {same}; "
                  f"bound {bound_ms:.4f} ms, read floor (amax) "
                  f"{floor_ms:.4f} ms ({bound_ms / floor_ms:.1%}), G1 "
                  f"{ms:.4f} ms ({bound_ms / ms:.1%}): kernel "
                  f"{parts['kernel_ms']:.4f} ms, rest {parts['rest_ms']:.4f}"
                  f" ms {parts['rest']}"
                  + (f"; plan {reading['plan']}" if "plan" in reading
                     else ""), flush=True)
            del got
        S.GATE_SIGNALS.clear()
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="root of the checkout to compare "
                        "with")
    parser.add_argument("--split", action="store_true",
                        help="read G1 of this checkout apart")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    if args.split:
        return split()
    if not args.parent:
        parser.error("give --parent DIR or --split")
    sys.path.insert(0, str(ROOT))
    from gstpeaq_tpu_torch.tools import ab
    card = ab.card()
    print(card, flush=True)
    runs = ab.runs(__file__, args.parent)
    print("dtype, case: ms, parent / this / this / parent (share of the "
          "bytes bound); bits equal the plain gate's in every run")
    worst = ab.table(runs, lambda t: f"{t['ms']:.4f} "
                     f"({t['bound_ms'] / t['ms']:.1%})"
                     + ("" if t["equal"] else " BITS DIFFER"))
    equal = all(t["equal"] for run in runs for d in ab.DTYPES
                for t in run[d].values())
    print(f"worst this / parent (this's faster run against the parent's "
          f"faster): {worst:.3f}; bits equal everywhere: {equal}")
    print(json.dumps({"card": card, "runs": runs}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
