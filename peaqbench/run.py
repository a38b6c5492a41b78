"""Runs one cell of the port's benchmark once, from the root of a checkout:

    python3 peaqbench/run.py --workload advanced.sweep --seed 7 \
        --seconds 10 --trace 0

Prints the compared numbers beside their limits as its last lines on
standard error, and one JSON object as the last line of standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), `device` and, traced,
`breakdown`; then `run` (the seed, counts and host times of the run:
`run.build_s` is the part of `setup_s` that built the port's kernels, 0
once a checkout holds them) and `checks`, the compared numbers.  Exits 1
without a result when CUDA is absent or has fewer devices than the cell
asks for, and 3 when JAX, Flax or the JAX package is loaded once the
window has closed.
`--tier` replaces the configuration's precision (the control, never the
benchmark's own runs).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--tier", default=None,
                        help="precision tier in place of the configuration's")
    args = parser.parse_args(argv)

    # every build and kernel cache at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # one host thread for PyTorch's and OpenMP's CPU work: the loop's host
    # is the main thread, and idle pool threads spinning beside it spread
    # the basic cell's runs (2.0% against 0.5% in three runs each)
    os.environ["OMP_NUM_THREADS"] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from peaqbench import harness

    bench = harness.Bench(ROOT)
    if args.workload not in bench.cells:
        print(f"run.py: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = bench.cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 1
    # a checkout's first run builds the port's kernels, in a child process:
    # built inside this one, the window's enqueue read ~3% slower
    # (its time stays in setup_s and is reported apart as run.build_s)
    from gstpeaq_tpu_torch.ops import _build
    build_s = 0.0
    if not _build.library_path().exists():
        import subprocess
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", "from gstpeaq_tpu_torch.ops "
                        "import _build; _build.build()"], cwd=ROOT,
                       check=True)
        build_s = time.perf_counter() - t
    result, checks = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", args.tier, t_start=T_START, build_s=build_s)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit, ok in checks:
        print(f"{name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
