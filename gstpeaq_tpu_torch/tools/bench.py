#!/usr/bin/env python3
"""PEAQ throughput of the PyTorch/CUDA port on one CUDA card: the port of
bench.py.  Run from the repository root:

    python3 gstpeaq_tpu_torch/tools/bench.py

Prints one JSON line per measurement, under bench.py's metric names
("audio-seconds/sec/chip (basic PEAQ, batch 64)", then the advanced mode
and the accurate tier in both modes), each with its precision tier and the
card's name and power limit as nvidia-smi reports them.  The inputs are
bench.py's: `make_pairs(64, 10.0)`, 64 stereo 10 s pairs from seed 0
(gstpeaq_tpu_torch/utils/benchpairs.py).  The rate is audio-seconds scored
per second: the batch is padded and copied to the card before the clock,
`iters` batches are dispatched back to back, and the clock stops when their
results are on the host; the median of `repeats` runs, with the least and
the most.  There is no fallback: without CUDA, or when a kernel fails, the
script fails.  It writes no file.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gstpeaq_tpu_torch import api  # noqa: E402
from gstpeaq_tpu_torch import constants as C  # noqa: E402
from gstpeaq_tpu_torch.parallel import batch as PB  # noqa: E402
from gstpeaq_tpu_torch.utils.benchpairs import make_pairs  # noqa: E402

BATCH = 64
SECONDS = 10.0


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def staged(advanced: bool, dtype: str, microbatch: int, pairs,
           device="cuda"):
    """The batch `pairs` (refs, tests) padded in microbatches and copied to
    `device` (page-locked, non_blocking).  Returns dispatch: dispatch()
    scores every chunk and returns their results on the device without
    waiting for them, [B, 2 + M] float64 (ODG, DI, MOVs) per chunk."""
    dev = torch.device(device)
    refs, tests = pairs
    buckets = PB.compute_buckets(refs, tests, advanced)
    pipe = PB.batch_pipeline(advanced, 92.0, C.DEFAULT_SETTINGS, dtype, dev)
    mb = min(microbatch, len(refs))
    chunks = [PB.stage(PB.prepare_chunk(refs[s:s + mb], tests[s:s + mb],
                                        buckets, pin=dev.type == "cuda"),
                       dev)
              for s in range(0, len(refs), mb)]

    def dispatch():
        with api.full_precision_matmuls(), torch.inference_mode():
            return [PB.results(PB.dispatch(pipe, buckets, *chunk))
                    for chunk in chunks]

    return dispatch


def bench(advanced: bool, batch: int = BATCH, seconds: float = SECONDS,
          dtype: str = "float32", iters: int = 2, microbatch: int = 32,
          repeats: int = 3, pairs=None) -> list[float]:
    """Audio-seconds per second of `iters` batches dispatched back to back
    and read at the end, one rate per repeat (bench.py::bench).  pairs:
    (refs, tests), by default make_pairs(batch, seconds)."""
    pairs = pairs or make_pairs(batch, seconds)
    audio = sum(r.shape[0] for r in pairs[0]) / C.SAMPLING_RATE
    dispatch = staged(advanced, dtype, microbatch, pairs)
    [out.cpu() for out in dispatch()]        # warm: cuFFT plans, cuDNN
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        outs = []
        for _ in range(iters):
            outs += dispatch()
        [out.cpu() for out in outs]          # the results on the host
        rates.append(iters * audio / (time.perf_counter() - start))
    return rates


def spread(rates: list[float]) -> dict:
    """The median of the repeats, with the least and the most."""
    return {"value": statistics.median(rates),
            "spread": [min(rates), max(rates)], "n_repeats": len(rates)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench: CUDA is not available")
    name_limit = card()
    pairs = make_pairs(BATCH, SECONDS)
    for metric, kwargs in [
            (f"audio-seconds/sec/chip (basic PEAQ, batch {BATCH})",
             dict(advanced=False, dtype="float32", iters=4, microbatch=64)),
            (f"audio-seconds/sec/chip (advanced PEAQ, batch {BATCH})",
             dict(advanced=True, dtype="float32", microbatch=32)),
            (f"audio-seconds/sec/chip (basic PEAQ, accurate tier, batch "
             f"{BATCH})", dict(advanced=False, dtype="accurate",
                               microbatch=32)),
            (f"audio-seconds/sec/chip (advanced PEAQ, accurate tier, batch "
             f"{BATCH})", dict(advanced=True, dtype="accurate",
                               microbatch=32))]:
        rates = bench(pairs=pairs, **kwargs)
        print(json.dumps({"metric": metric, "unit": "audio-sec/s",
                          "dtype": kwargs["dtype"],
                          "microbatch": kwargs["microbatch"],
                          **spread(rates), "card": name_limit}), flush=True)


if __name__ == "__main__":
    main()
