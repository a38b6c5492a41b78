#!/usr/bin/env python3
"""F1 `fir_bank` of this checkout against another's, on one CUDA card.  Run
from the repository root:

    python3 gstpeaq_tpu_torch/tools/fir_ab.py --parent DIR

DIR is the root of another checkout (e.g. the parent commit from `git
archive`).  Each checkout runs in a subprocess of its own, its package
imported from its root and its kernels built under its own
gstpeaq_tpu_torch/_build/, in the order parent, this, this, parent.  Each
run times its own ops/cuda_fir.py::fir_bank, in float32 and float64, at
the seven shapes the port gives it (SHAPES: one pair, the advanced batch,
the chunk-64 and chunk-1,024 FB steps of one stream and of 16 with a
history, the one-hour one shot), on the same random samples (a seeded
generator on the card): the device time of one call between CUDA events,
the median of 5 rounds of `calls` calls, each round behind a ~1 ms sleep.
Prints the card's name and power limit, a table of the four readings per
dtype and shape, then one JSON object of the runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
# (label, [rows, samples], with a history, calls a round)
SHAPES = (("pair", (4, 480000), False, 20),
          ("batch", (128, 491520), False, 5),
          ("chunk 64 N=1", (4, 196608), True, 20),
          ("chunk 64 N=16", (64, 196608), True, 10),
          ("chunk 1024 N=1", (4, 3145728), True, 10),
          ("chunk 1024 N=16", (64, 3145728), True, 3),
          ("hour", (4, 172800000), False, 2))


def child(root: str) -> None:
    """One checkout's times, as a JSON line on stdout."""
    sys.path.insert(0, root)
    import torch

    from gstpeaq_tpu_torch import earparams as EP
    from gstpeaq_tpu_torch.ops import cuda_fir
    from gstpeaq_tpu_torch.ops import fb_ear as FB
    assert pathlib.Path(cuda_fir.__file__).resolve().is_relative_to(
        pathlib.Path(root).resolve()), cuda_fir.__file__

    def device_ms(fn, calls: int) -> float:
        for _ in range(2):
            fn()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)

    out = {"root": root}
    for dtype in (torch.float32, torch.float64):
        k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(71)
        times = {}
        for label, shape, with_history, calls in SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            hist = (torch.randn((shape[0], FB.HIST_LEN), generator=gen,
                                device="cuda", dtype=dtype)
                    if with_history else None)
            times[label] = device_ms(
                lambda: cuda_fir.fir_bank(x, k.fir_weight, k.fir_plan, hist),
                calls)
            del x, hist
            torch.cuda.empty_cache()
        out[str(dtype).removeprefix("torch.")] = times
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    parent = str(pathlib.Path(args.parent).resolve())
    runs = []
    for root in (parent, str(ROOT), str(ROOT), parent):
        done = subprocess.run(
            [sys.executable, __file__, "--parent", parent, "--child", root],
            check=True, capture_output=True, text=True, cwd=root)
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    print("dtype, shape: ms, parent / this / this / parent")
    for dtype in ("float32", "float64"):
        for label, *_ in SHAPES:
            print(f"  {dtype} {label:16s} " + " / ".join(
                f"{run[dtype][label]:.4f}" for run in runs))
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
