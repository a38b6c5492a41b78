#!/usr/bin/env python3
"""The wall of one float64 stream chunk step in this checkout against
another's, on one CUDA card.  Run from the repository root:

    python3 gstpeaq_tpu_torch/tools/stream_step_ab.py --parent DIR

DIR is the root of another checkout (e.g. the parent commit from `git
archive`).  Each checkout runs in a subprocess of its own, its package
imported from its root and its kernels built under its own
gstpeaq_tpu_torch/_build/, in the order parent, this, this, parent.  The
program is 60 s of longform_bench.py's stereo program, fed in 1 s pieces
at chunk_frames 64 (chip_smoke.py phase 10's chunk).  Per run and mode:
the median wall of a chunk step over the first 30 s (the card synchronized
before and after each step), the audio-s/s of a fresh stream over the
whole 60 s, and that stream's peak device memory.  Prints the card's name
and power limit, then one JSON object of the runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
CHUNK = 64
SR = 48000


def child(root: str, program: str) -> None:
    """One checkout's readings, as a JSON line on stdout."""
    sys.path.insert(0, root)
    import torch
    from gstpeaq_tpu_torch.parallel import stream as PS
    assert pathlib.Path(PS.__file__).resolve().is_relative_to(
        pathlib.Path(root).resolve()), PS.__file__
    data = np.load(program)
    ref, test = data["ref"], data["test"]
    seconds = ref.shape[0] // SR
    out = {"root": root}
    for mode, cls in (("basic", PS.PeaqStream),
                      ("advanced", PS.PeaqStreamAdvanced)):
        stream = cls(chunk_frames=CHUNK, dtype="float64")
        walls = []
        step = stream._step

        def timed_step(*args):
            torch.cuda.synchronize()
            start = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)

        stream._step = timed_step
        for i in range(seconds // 2):
            stream.feed(ref[i * SR:(i + 1) * SR], test[i * SR:(i + 1) * SR])
        del stream
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stream = cls(chunk_frames=CHUNK, dtype="float64")
        start = time.perf_counter()
        for i in range(seconds):
            stream.feed(ref[i * SR:(i + 1) * SR], test[i * SR:(i + 1) * SR])
        odg = stream.finalize().odg
        wall = time.perf_counter() - start
        out[mode] = {"step_ms": statistics.median(walls) * 1e3,
                     "steps": len(walls),
                     "audio_s_per_s": seconds / wall,
                     "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                     "odg": float(odg)}
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--program", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child, args.program)
        return 0

    sys.path.insert(0, str(ROOT))
    from gstpeaq_tpu_torch.tools import longform_bench as L
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ref, test = (np.concatenate(x) for x in zip(
        *L.feeds(*L.base_program(), 60 * SR)))
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        program = str(pathlib.Path(tmp) / "program.npz")
        np.savez(program, ref=ref, test=test)
        parent = str(pathlib.Path(args.parent).resolve())
        for root in (parent, str(ROOT), str(ROOT), parent):
            done = subprocess.run(
                [sys.executable, __file__, "--parent", parent, "--child",
                 root, "--program", program], capture_output=True,
                text=True, cwd=root)
            if done.returncode:
                print(done.stderr[-3000:], file=sys.stderr)
                return done.returncode
            runs.append(json.loads(done.stdout.splitlines()[-1]))
            print(f"  {runs[-1]}", flush=True)
    print(card)
    print(json.dumps({"card": card, "chunk_frames": CHUNK, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
