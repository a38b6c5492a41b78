#!/usr/bin/env python3
"""Codec-eval sweep: batched ODG for thousands of ref/test pairs, on one
device (the port of tools/codec_sweep.py, BASELINE config 5).

Every pair is scored by one `parallel.batch.peaq_batch` call in
microbatches of `--microbatch` pairs (length buckets, host padding into
page-locked memory, every chunk staged on the device first when the
padded pairs fit `--prefetch-gb`).  Run from anywhere:

  python3 gstpeaq_tpu_torch/tools/codec_sweep.py MANIFEST.tsv [--advanced]
      [--out results.tsv] [--pcm16] [--microbatch N] [--precision TIER]
  python3 gstpeaq_tpu_torch/tools/codec_sweep.py --demo N [...]

MANIFEST.tsv: one pair per line, "ref_path<TAB>test_path"; blank lines and
lines starting with "#" are skipped.  With --demo N, N synthetic codec-like
10 s stereo pairs (utils/benchpairs.make_pairs) stand in for the manifest.

Writes "item<TAB>odg<TAB>di" (the test path, or demo<i>) to --out or to
stdout, and three lines to stderr: the pairs, audio-seconds and rate with
the peak host RSS; the phases of peaq_batch's `timings`; the rate without
`first_sync`.  The device is CUDA unless GSTPEAQ_PLATFORM names another
(`cpu`); without CUDA and without that variable the tool exits 1.
"""

from __future__ import annotations

import argparse
import pathlib
import resource
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gstpeaq_tpu_torch import api  # noqa: E402
from gstpeaq_tpu_torch.parallel import batch as B  # noqa: E402
from gstpeaq_tpu_torch.utils import native  # noqa: E402
from gstpeaq_tpu_torch.utils.benchpairs import make_pairs  # noqa: E402


def load_manifest(path):
    pairs = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ref, test = line.split("\t")[:2]
            pairs.append((ref, test))
    return pairs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("manifest", nargs="?")
    parser.add_argument("--advanced", action="store_true")
    parser.add_argument("--precision", choices=sorted(api.DTYPES),
                        default=None,
                        help=f"precision tier (default {api.DEFAULT_DTYPE})")
    parser.add_argument("--demo", type=int, default=0,
                        help="run N synthetic pairs instead of a manifest")
    parser.add_argument("--out", default=None)
    parser.add_argument("--microbatch", type=int, default=32)
    parser.add_argument("--pcm16", action="store_true",
                        help="ship inputs as raw int16 PCM and dequantize "
                        "on the device (framing.dequantize): halves "
                        "host->device transfer bytes; exact for "
                        "PCM16-sourced audio")
    parser.add_argument("--prefetch-gb", type=float, default=6.0,
                        help="stage all input chunks on the device before "
                        "the first dispatch when they fit this budget")
    args = parser.parse_args(argv)

    device = api.platform_device("codec_sweep")
    if device is None:
        return 1

    if args.demo:
        names = [f"demo{i}" for i in range(args.demo)]
        refs, tests = make_pairs(args.demo, 10.0)
    else:
        if not args.manifest:
            parser.error("need MANIFEST or --demo N")
        pairs = load_manifest(args.manifest)
        names = [t for _, t in pairs]
        load = (native.load_audio_48k_ship if args.pcm16
                else native.load_audio_48k)
        refs = [load(r) for r, _ in pairs]
        tests = [load(t) for _, t in pairs]

    if args.pcm16:
        # float-sourced pairs (demo / non-PCM16 files) quantize here;
        # raw PCM16 loads pass through
        refs = [B.to_pcm16(r) for r in refs]
        tests = [B.to_pcm16(t) for t in tests]

    t0 = time.time()
    phases = {}
    out = B.peaq_batch(refs, tests, advanced=args.advanced,
                       dtype=args.precision, microbatch=args.microbatch,
                       prefetch_gb=args.prefetch_gb, timings=phases,
                       device=device)
    dt = time.time() - t0
    audio = sum(r.shape[0] for r in refs) / 48000.0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"# {len(refs)} pairs, {audio:.0f} audio-sec in {dt:.1f}s "
          f"({audio/dt:.0f} audio-sec/s), peak host RSS {peak_gb:.1f} GB",
          file=sys.stderr)
    # first_sync is the first chunk's wait for its results, paid once per
    # call; stage + dispatch + drain is the rest
    steady = audio / max(dt - phases.get("first_sync", 0.0), 1e-9)
    print("# phases: "
          + " ".join(f"{k} {v:.1f}s" for k, v in phases.items())
          + f"; excl. one-time program-load stall: {steady:.0f} "
          "audio-sec/s", file=sys.stderr)

    lines = [f"{n}\t{o:.4f}\t{d:.4f}"
             for n, o, d in zip(names, out["odg"], out["di"])]
    text = "item\todg\tdi\n" + "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
