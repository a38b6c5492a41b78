#!/usr/bin/env python3
"""Whether torch's CPU elementwise functions give the same bits on their
first call in a process as on their second.  Run from anywhere:

    python3 gstpeaq_tpu_torch/tools/cpu_first_call.py [--runs 32] [--jobs 8]

For each function (torch.log, torch.exp, torch.log10, torch.log1p,
torch.sqrt and the port's exact.log, exact.log10, exact.exp and
exact.sqrt) it starts `runs` fresh Python processes, `jobs` at a time so
that the machine is busy, each at torch's default thread count.  Each process calls the function twice on
the same float64 array [4, 24, 512] made from its own seed, and reports
how many values the first call gave differently from the second, and the
largest relative difference.  Prints one line per function: the runs whose
first call differed, of all runs, and the largest difference seen.  A
first call that differs is what made a float64 CPU result change from
run to run (ROADMAP.md queue C, C3, C5 and C6).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FUNCTIONS = ("torch.log", "torch.exp", "torch.log10", "torch.log1p",
             "torch.sqrt", "exact.log", "exact.log10", "exact.exp",
             "exact.sqrt")
CHILD = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[3])
from gstpeaq_tpu_torch.ops import exact
rng = np.random.default_rng(int(sys.argv[2]))
name = sys.argv[1]
low = -0.4 if name == "torch.log1p" else 0.1
x = torch.from_numpy(rng.uniform(low, 10.0, (4, 24, 512)))
fn = eval(name)
first, second = fn(x), fn(x)
diff = first != second
rel = ((first - second).abs() / second.abs().clamp_min(1e-300)).max()
print(json.dumps({"differ": int(diff.sum()), "rel": float(rel)}))
"""


def run(name: str, seed: int) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, name, str(seed),
                          str(ROOT)], capture_output=True, text=True,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=32)
    ap.add_argument("--jobs", type=int, default=8)
    args = ap.parse_args(argv)
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for name in FUNCTIONS:
            got = list(pool.map(lambda s: run(name, s), range(args.runs)))
            bad = [g for g in got if g["differ"]]
            worst = max((g["rel"] for g in got), default=0.0)
            print(f"{name}: first call differed in {len(bad)} of "
                  f"{len(got)} fresh processes; largest relative "
                  f"difference {worst:.3g}", flush=True)


if __name__ == "__main__":
    main()
