#!/usr/bin/env python3
"""E1 `ehs_frames` (csrc/ehs.cu) of this checkout against another's, on one
CUDA card.  Run from the repository root:

    python3 gstpeaq_tpu_torch/tools/ehs_ab.py --parent DIR
    python3 gstpeaq_tpu_torch/tools/ehs_ab.py --split

DIR is the root of another checkout (e.g. the parent commit from `git
archive`).  Each checkout runs in a subprocess of its own, its package and
its chip_smoke.py imported from its root and its kernels built under its
own gstpeaq_tpu_torch/_build/, in the order parent, this, this, parent.
Each run takes the inputs chip_smoke.py gives E1 (its ehs_cases per pair:
the 10 s pair's d under each flag, the edge rows, the branch rows, mono, 3
channels, one frame; S2's d of bench's batch shapes, basic [64, 2, 512,
512] and advanced [32, 2, 512, 512], under each flag; the FFT chunk
steps' d at 64 and 1,024 frames, one stream and 16) in float32 and
float64, and runs its own ops/cuda_ehs.py::ehs_frames on them: the frames
against the plain version's (chip_smoke.ehs_check: EHS_BARS, exact 0 on
zero and non-finite rows), and the device time of one call between CUDA
events (chip_smoke.cuda_ms: the mean of `calls` calls behind a sleep that
covers the host's enqueue, median of 5 rounds) beside the bound
(chip_smoke.bound).  Prints the card's name and power limit, a table of
the four readings per dtype and case, then one JSON object of the runs.

--split reads E1 of the checkout it runs in apart, in one process: the
build's registers, spills and shared memory of E1, the instructions of
E1's row loop in its SASS (cuobjdump: all, FP64, and the bytes of shared
memory and shuffles they move), and at each shape E1 runs at on the main
path (per pair, both batches, the chunk steps at 64 and 1,024 frames
with one stream and 16), in both dtypes: E1's time, its bound, a read
floor for the same bytes (`d.sum()`, one PyTorch reduction that reads d
once: a yardstick, not a library call, since it computes no EHS), the
FP64 floor of the direct lags (65,536 multiply-adds a row at the card's
measured rate of FP64 instructions: chip_smoke.band_math_rates'
"muladd", an unfused multiply and add, two instructions a step) and the
floor of the normalisation's divisions (256 a row at the card's
measured rate of double divisions, "div").  Prints its readings, then
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
# the direct lags' multiply-adds a row, and the normalisation's divisions
DIRECT_LAG_FMAS = 256 * 256
DIVISIONS = 256
# cuobjdump's SASS of E1's double kernel: the bytes of shared memory (and
# of a shuffle, its 32 lanes' words) one warp-wide instruction moves
SASS_BYTES = {"LDS.128": 512, "STS.128": 512, "LDS.64": 256, "STS.64": 256,
              "LDS": 128, "STS": 128, "SHFL": 128}


def shape_cases(S, dtype, pair10, every: bool = False) -> list:
    """E1 at the shapes the main path gives it: the per-pair main case,
    S2's d of bench's basic and advanced batch shapes under each flag, and
    the FFT chunk steps' d at 64 and 1,024 frames, one stream and the
    pool's 16 (chip_smoke's batch and stream cases, built alone); with
    `every`, then the rest of chip_smoke's per-pair E1 cases (edge and
    branch rows, mono, 3 channels, one frame) of the checkout S is."""
    import torch

    from gstpeaq_tpu_torch import constants as C
    from gstpeaq_tpu_torch import earparams as EP
    from gstpeaq_tpu_torch.ops import fft_ear as FE
    per_pair = S.ehs_cases(dtype, pair10)
    cases = [c for c in per_pair if c.case == "main"]
    frames = S.batch_shapes()["basic"][-1]
    for label, lead, z in (("basic", S.MICROBATCH["basic"],
                            C.BASIC_BAND_COUNT),
                           ("advanced", S.MICROBATCH["advanced"],
                            C.ADVANCED_FFT_BAND_COUNT)):
        kf = FE.build_consts(EP.fft_ear_params(z), dtype, "cuda")
        spectra = S.spectra_of(kf, S.fft_blocks(pair10, lead, frames))
        d = S.ehs_difference(kf, spectra)
        del spectra
        torch.cuda.empty_cache()
        for flag in (False, True):
            cases.append(S.ehs_case(f"batch {label} {list(d.shape)}", d,
                                    flag))
    kb = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT), dtype,
                         "cuda")
    for chunk in (S.STREAM_CHUNK, S.TOOL_CHUNK):
        for n in (1, S.POOL):
            spectra = S.spectra_of(kb, S.fft_blocks(pair10, n, chunk))
            d = S.ehs_difference(kb, spectra)
            del spectra
            cases.append(S.ehs_case(f"chunk {chunk} N={n} {list(d.shape)}",
                                    d))
    return cases + [c for c in per_pair if every and c.case != "main"]


def child(root: str) -> None:
    """One checkout's checks and times, as a JSON line on stdout."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as S
    from gstpeaq_tpu_torch.ops import cuda_ehs
    for module in (S, cuda_ehs):
        assert pathlib.Path(module.__file__).resolve().is_relative_to(
            pathlib.Path(root).resolve()), module.__file__
    pair10 = S.ten_second_pair()
    out = {"root": root}
    for dtype in S.DTYPES:
        times = {}
        for c in shape_cases(S, dtype, pair10, every=True):
            d = c.inputs[0]
            got = c.kernel()
            _, rel, ok, _ = S.ehs_check(got, c.plain(), d, dtype)
            same = torch.equal(got, c.kernel())
            big = d.numel() > 4_000_000
            ms, _ = S.cuda_ms(c.kernel, calls=5 if big else 20, rounds=5,
                              cover_host=True)
            bound_ms, _ = S.bound(c.name, dtype, c.inputs, got)
            times[c.case] = {"ms": ms, "bound_ms": bound_ms, "rel": rel,
                             "ok": bool(ok and same)}
            del got
        out[str(dtype).removeprefix("torch.")] = times
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def build_report(S) -> list[str]:
    """ptxas's lines for E1's kernels (registers, spills, static shared
    memory) from the build's log, and the dynamic shared memory a block
    where the checkout's chip_smoke.py reads it from the source."""
    from gstpeaq_tpu_torch.ops import _build, cuda_ehs
    path, _ = _build.build()
    lines, entry, spills = [], None, ""
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"ehs_frames_kernelI([fd])", line)
            entry = m and ("float" if m[1] == "f" else "double")
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "Used" in line:
            lines.append(f"E1 {entry} rows: {line.split(':', 1)[1].strip()}"
                         f"; {spills}")
            entry = None
    if hasattr(S, "ehs_shared"):
        lines.append(f"E1 dynamic shared memory a block: "
                     f"{S.ehs_shared()} B; {cuda_ehs.WARPS} row warps and "
                     f"a helper, {cuda_ehs.RESIDENT} blocks an SM")
    return lines


def sass_mix(path) -> str:
    """E1's double kernel in the built library `path` as cuobjdump disassembles
    it: the instructions of its row loop (from the first branch back over
    more than 512 instructions to its target), the FP64 ones among them,
    and the shared memory and shuffle bytes they move, a row; or why
    there is no reading."""
    import collections
    cuobjdump = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    done = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True)
    if done.returncode:
        return f"no SASS reading ({done.stderr.strip()[:200]})"
    body = next((part for part in re.split(r"\n\s+Function : ", done.stdout)
                 if "ehs_frames_kernelId" in part[:400]), "")
    code = [(int(m[1], 16), m[3], m[4]) for m in re.finditer(
        r"/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);", body)]
    back = [(at, int(t[1], 16)) for at, op, rest in code
            if op.startswith("BRA")
            and (t := re.search(r"0x([0-9a-f]+)", rest))
            and int(t[1], 16) < at - 16 * 512]
    if not back:
        return "no SASS reading (no row loop found)"
    end, start = back[0]
    ops = collections.Counter(op for at, op, _ in code if start <= at <= end)
    fp64 = sum(n for op, n in ops.items()
               if op.split(".")[0] in ("DADD", "DMUL", "DFMA"))
    moved = sum(n * SASS_BYTES.get(op, SASS_BYTES.get(op.split(".")[0], 0))
                for op, n in ops.items()
                if op.split(".")[0] in ("LDS", "STS", "SHFL"))
    return (f"E1's row loop (SASS): {sum(ops.values())} warp instructions a "
            f"row, {fp64} of them FP64, {moved / 1024:.1f} KB of shared "
            f"memory and shuffles")


def split() -> int:
    """E1 of this checkout read apart (the module docstring's --split)."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as S
    card = S.phase_card()
    S.phase_build()
    report = build_report(S)
    from gstpeaq_tpu_torch.ops import _build
    report.append(sass_mix(_build.build()[0]))
    for line in report:
        print(f"  {line}", flush=True)
    rates = S.band_math_rates()
    fp64 = 2 * rates[torch.float64]["muladd"]
    div = rates[torch.float64]["div"]
    print(f"  card FP64 instructions {fp64 / 1e12:.3f} T/s (2 x muladd "
          f"steps), double divisions {div / 1e9:.1f} G/s", flush=True)
    pair10 = S.ten_second_pair()
    result = {"card": card, "build": report, "fp64_per_s": fp64,
              "div_per_s": div, "cases": {}}
    for dtype in S.DTYPES:
        name = str(dtype).removeprefix("torch.")
        result["cases"][name] = {}
        for c in shape_cases(S, dtype, pair10):
            d = c.inputs[0]
            rows = d.numel() // d.shape[-1]
            got = c.kernel()
            _, rel, ok, _ = S.ehs_check(got, c.plain(), d, dtype)
            bound_ms, bound_by = S.bound(c.name, dtype, c.inputs, got)
            big = d.numel() > 4_000_000
            floor_ms, _ = S.cuda_ms(lambda: d.sum(), calls=5 if big else 20,
                                    rounds=5, cover_host=True)
            ms, _ = S.cuda_ms(c.kernel, calls=5 if big else 20, rounds=5,
                              cover_host=True)
            lags_ms = rows * DIRECT_LAG_FMAS / fp64 * 1e3
            div_ms = rows * DIVISIONS / div * 1e3
            ops_ms = S.ops_of(c.name, c.inputs) / S.PEAK_OPS_PER_S[
                torch.float64] * 1e3
            reading = dict(rows=rows, ms=ms, bound_ms=bound_ms,
                           bound_by=bound_by, read_floor_ms=floor_ms,
                           direct_lags_ms=lags_ms, divisions_ms=div_ms,
                           fft_form_ops_at_fp64_ms=ops_ms, rel=rel,
                           ok=bool(ok))
            result["cases"][name][c.case] = reading
            print(f"  ehs_frames {c.case} {dtype}: within bars {ok} "
                  f"(rel {rel:.2e}); E1 {ms:.4f} ms, {bound_ms / ms:.1%} of "
                  f"its bound {bound_ms:.4f} ms ({bound_by}); the FFT "
                  f"form's operations at the FP64 peak {ops_ms:.4f} ms "
                  f"({ops_ms / ms:.1%}); read floor (d.sum) {floor_ms:.4f} "
                  f"ms; direct lags' FP64 floor {lags_ms:.4f} ms "
                  f"({lags_ms / ms:.1%} of E1); divisions' floor "
                  f"{div_ms:.4f} ms", flush=True)
            del got
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="root of the checkout to compare "
                        "with")
    parser.add_argument("--split", action="store_true",
                        help="read E1 of this checkout apart")
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
          "bound); every frame within EHS_BARS of the plain version's, "
          "exact 0 on zero and non-finite rows, two launches bit for bit")
    worst = ab.table(runs, lambda t: f"{t['ms']:.4f} "
                     f"({t['bound_ms'] / t['ms']:.1%})"
                     + ("" if t["ok"] else " FAILS"))
    ok = all(t["ok"] for run in runs for d in ab.DTYPES
             for t in run[d].values())
    print(f"worst this / parent (this's faster run against the parent's "
          f"faster): {worst:.3f}; every check held: {ok}")
    print(json.dumps({"card": card, "runs": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
