"""What the A/B tools (tools/*_ab.py) share: a tool's readings of this
checkout against another's on one CUDA card, each checkout in subprocesses
of its own in the order parent, this, this, parent, and the table of those
readings.  A tool imports this module in its own process only, never in a
child, which runs from the other checkout's root."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
DTYPES = ("float32", "float64")


def card() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def runs(tool: str, parent: str, *args: str, echo: bool = False) -> list:
    """`python tool *args --child ROOT` from each ROOT in the order parent,
    this, this, parent, a subprocess each; the JSON object each prints on
    its last line (each printed as it comes with `echo`).  A child that
    fails ends the tool with its exit code, the ends of its output on
    stderr."""
    parent = str(pathlib.Path(parent).resolve())
    out = []
    for root in (parent, str(ROOT), str(ROOT), parent):
        done = subprocess.run([sys.executable, tool, *args, "--child", root],
                              capture_output=True, text=True, cwd=root)
        if done.returncode:
            sys.stderr.write(done.stdout[-4000:] + done.stderr[-4000:])
            raise SystemExit(done.returncode)
        out.append(json.loads(done.stdout.strip().splitlines()[-1]))
        if echo:
            print(f"  {out[-1]}", flush=True)
    return out


def table(readings: list, cell, ms=lambda t: t["ms"]) -> float:
    """Prints a line for each dtype and case of `readings` (runs' four
    objects, each {dtype: {case: reading}}): `cell` of each run's reading,
    "-" where a run has none; this checkout's cases first, then the
    parent's alone.  Returns the worst ratio of this checkout's faster
    time (`ms` of a reading) to the parent's faster, over the cases both
    have (0.0 where none)."""
    worst = 0.0
    for dtype in DTYPES:
        labels = list(readings[1][dtype]) + [
            label for label in readings[0][dtype]
            if label not in readings[1][dtype]]
        for label in labels:
            got = [run[dtype].get(label) for run in readings]
            print(f"  {dtype} {label}: " + " / ".join(
                "-" if t is None else cell(t) for t in got), flush=True)
            old = [ms(t) for t in (got[0], got[3]) if t is not None]
            if old and got[1] is not None and got[2] is not None:
                worst = max(worst, min(ms(got[1]), ms(got[2])) / min(old))
    return worst
