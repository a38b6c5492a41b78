#!/usr/bin/env python3
"""The batch throughput of this checkout against another's, on one CUDA
card.  Run from the repository root:

    python3 gstpeaq_tpu_torch/tools/batch_ab.py --parent DIR

DIR is the root of another checkout (e.g. the parent commit from `git
archive`).  Each checkout runs in a subprocess of its own, its package
imported from its root and its kernels built under its own
gstpeaq_tpu_torch/_build/, in the order parent, this, this, parent.  Each
run scores bench.py's 64 stereo 10 s pairs with its own tools/bench.py:
basic float64, float32 and accurate (microbatch 64) and advanced
float64, float32 and accurate (microbatch 32).  Per configuration: the
staged rate (`bench()`: audio-s/s, the median of 3 repeats with the least
and the most), the device time of one staged batch (the sum of
torch.profiler's device rows over one dispatch) and its device operations
(kernels and copies, the rows' counts), and the peak device memory of one
staged dispatch (`max_memory_allocated`, the staged chunks included).
Prints the card's name and power limit, then one JSON object of the
runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIGS = (("basic", "float64", 64), ("basic", "float32", 64),
           ("basic", "accurate", 64), ("advanced", "float64", 32),
           ("advanced", "float32", 32), ("advanced", "accurate", 32))


def child(root: str) -> None:
    """One checkout's readings, as a JSON line on stdout."""
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gstpeaq_tpu_torch.tools import bench as B
    from gstpeaq_tpu_torch.utils.benchpairs import make_pairs
    assert pathlib.Path(B.__file__).resolve().is_relative_to(
        pathlib.Path(root).resolve()), B.__file__
    pairs = make_pairs(B.BATCH, B.SECONDS)
    out = {"root": root}
    for mode, tier, microbatch in CONFIGS:
        advanced = mode == "advanced"
        rates = B.bench(advanced, dtype=tier, microbatch=microbatch,
                        pairs=pairs)
        dispatch = B.staged(advanced, tier, microbatch, pairs)
        [o.cpu() for o in dispatch()]                  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        [o.cpu() for o in dispatch()]
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            [o.cpu() for o in dispatch()]
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in device) / 1e3
        out[f"{mode} {tier} ({microbatch})"] = {
            **B.spread(rates), "device_ms": device_ms,
            "device_ops": sum(e.count for e in device),
            "peak_gib": peak / 2**30}
        del dispatch
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child)
        return 0

    sys.path.insert(0, str(ROOT))
    from gstpeaq_tpu_torch.tools import ab
    card = ab.card()
    runs = ab.runs(__file__, args.parent, "--parent", args.parent,
                   echo=True)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
