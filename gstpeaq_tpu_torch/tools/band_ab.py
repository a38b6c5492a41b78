#!/usr/bin/env python3
"""L1 `levcorr`, L2 `pattern_adapt` and M1 `band_movs` (csrc/band.cu) of
this checkout against another's, on one CUDA card.  Run from the repository
root:

    python3 gstpeaq_tpu_torch/tools/band_ab.py --parent DIR
    python3 gstpeaq_tpu_torch/tools/band_ab.py --split

DIR is the root of another checkout (e.g. the parent commit from `git
archive`).  Each checkout runs in a subprocess of its own, its package and
its chip_smoke.py imported from its root and its kernels built under its
own gstpeaq_tpu_torch/_build/, in the order parent, this, this, parent.
Each run takes the inputs chip_smoke.py's phase 3 gives the band kernels
(its band_cases, band_batch_cases and band_stream_cases: one peaq() of the
10 s pair per mode, and in float32 its accurate tier; bench's 64 pairs
through peaq_batch(); the first chunk step of each stream path at 64 and
1,024 FFT frames, one stream and 16) and times its own wrappers on them in
float32 and float64: the device time of one call between CUDA events
(chip_smoke.cuda_ms: the mean of `calls` calls behind a sleep that covers
the host's enqueue, median of 5 rounds) beside the bytes bound
(chip_smoke.bound).  Prints the card's name and power limit, a table of
the four readings per dtype and case, then one JSON object of the runs.

--split reads M1 of this checkout apart, in one process: the build's
registers and spills (chip_smoke.py phase 2), M1 at the basic batch site
with its row parts alone (ModDiff, loudness, NMR), its pair part alone
(the detection) and both; the card's rate of each library call M1 makes
and M1's math floor at each batch site from them (chip_smoke's
band_math_floor), for the calls csrc/band.cu makes and for the pow forms
(pow(l, 4) and 0.5^tb as pow, each quotient on its own); and M1 at every
batch site and per pair with every pow, exp, exp2 and log10 replaced by a
multiply (a copy of csrc/ rewritten and built under
gstpeaq_tpu_torch/_build/band_nomath/), in the order shipped, rewritten,
rewritten, shipped.  Prints its readings, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
# M1's library calls per band element in the pow forms (chip_smoke's
# M1_CALLS before the reformulations)
POW_FORMS = {"basic": {"pow": 7, "exp": 1, "log10": 2, "div": 14},
             "fb": {"pow": 8, "exp": 3, "div": 15},
             "fft": {"div": 2}}
# csrc/band.cu's math library calls and what --split puts in their place
NOMATH = {"return powf(x, y);": "return x * y;",
          "return pow(x, y);": "return x * y;",
          "return expf(x);": "return 0.5f * x;",
          "return exp(x);": "return 0.5 * x;",
          "return exp2f(x);": "return 0.5f * x;",
          "return exp2(x);": "return 0.5 * x;",
          "return log10f(x);": "return 0.4342944819f * x;",
          "return log10(x);": "return 0.4342944819 * x;"}


def cases_of(S, dtype, pair10) -> list:
    """chip_smoke's phase-3 band cases of `dtype` (module S) that carry
    their inputs."""
    cases = S.band_cases(dtype, pair10) + S.band_batch_cases(dtype)
    for chunk in (S.STREAM_CHUNK, S.TOOL_CHUNK):
        for n in (1, S.POOL):
            cases += S.band_stream_cases(dtype, pair10, chunk, n)
    return [c for c in cases if c.inputs]


def child(root: str) -> None:
    """One checkout's times, as a JSON line on stdout."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as S
    from gstpeaq_tpu_torch.ops import cuda_band
    for module in (S, cuda_band):
        assert pathlib.Path(module.__file__).resolve().is_relative_to(
            pathlib.Path(root).resolve()), module.__file__
    pair10 = S.ten_second_pair()
    out = {"root": root}
    for dtype in S.DTYPES:
        times = {}
        for c in cases_of(S, dtype, pair10):
            label = f"{c.name} {c.case}"
            big = c.inputs[0].numel() > 4_000_000
            ms, _ = S.cuda_ms(c.kernel, calls=5 if big else 20, rounds=5,
                              cover_host=True)
            bound_ms, _ = S.bound(c.name, dtype, c.inputs, c.kernel())
            times[label] = {"ms": ms, "bound_ms": bound_ms}
        out[str(dtype).removeprefix("torch.")] = times
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def nomath_sources(variant: pathlib.Path,
                   csrc: pathlib.Path) -> pathlib.Path:
    """A copy of csrc/ under `variant` whose band.cu computes a multiply
    where it called pow, exp, exp2 or log10."""
    shutil.rmtree(variant, ignore_errors=True)
    copy = variant / "csrc"
    shutil.copytree(csrc, copy)
    src = copy / "band.cu"
    text = src.read_text()
    for call, product in NOMATH.items():
        if text.count(call) != 1:
            raise SystemExit(f"band.cu no longer has one `{call}`")
        text = text.replace(call, product)
    src.write_text(text)
    return copy


def split() -> int:
    """M1 of this checkout read apart (the module docstring's --split)."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as S
    from gstpeaq_tpu_torch.ops import _build, cuda_band
    from gstpeaq_tpu_torch.parallel import batch as PB
    card = S.phase_card()
    S.phase_build()
    shipped = (_build.CSRC, _build.BUILD_DIR)
    variant = _build.BUILD_DIR / "band_nomath"
    forms = {"shipped": shipped,
             "nomath": (nomath_sources(variant, _build.CSRC),
                        variant / "build")}

    def use(form: str) -> None:
        _build.CSRC, _build.BUILD_DIR = forms[form]
        _build.library.cache_clear()
        _build.library()
    use("nomath")
    use("shipped")
    pair10 = S.ten_second_pair()
    result = {"card": card, "parts": {}, "floor": {}, "nomath": {}}
    rates = S.band_math_rates()
    result["rates"] = {str(d).removeprefix("torch."): r
                       for d, r in rates.items()}
    for dtype, by_op in rates.items():
        print(f"  band math rates {dtype}, G calls/s: " + ", ".join(
            f"{op} {rate / 1e9:.2f}" for op, rate in by_op.items()))
    for dtype in S.DTYPES:
        name = str(dtype).removeprefix("torch.")
        basic = S.band_calls(lambda: PB.peaq_batch(
            *S.bench_pairs(), dtype=name, microbatch=S.MICROBATCH["basic"]))
        args, kwargs = basic["band_movs", "basic"]
        whole = cuda_band.SITES["basic"]
        parts = {"rows": whole & ~cuda_band.PROB, "pairs": cuda_band.PROB,
                 "all": whole}
        result["parts"][name] = {}
        try:
            for label, bits in parts.items():
                cuda_band.SITES["basic"] = bits
                ms, _ = S.cuda_ms(lambda: cuda_band.band_movs(*args,
                                                              **kwargs),
                                  calls=5, rounds=5, cover_host=True)
                result["parts"][name][label] = ms
                print(f"  band_movs batch basic {label} parts ({bits}) "
                      f"{dtype}: {ms:.4f} ms", flush=True)
        finally:
            cuda_band.SITES["basic"] = whole
        cases = [c for c in (S.band_cases(dtype, pair10)
                             + S.band_batch_cases(dtype))
                 if c.name == "band_movs" and c.inputs]
        result["floor"][name] = {}
        for c in cases:
            if not c.case.startswith("batch"):
                continue
            site = c.case.split()[2]
            bound_ms, _ = S.bound(c.name, dtype, c.inputs, c.kernel())
            floors = {form: S.band_math_floor(site, c.inputs, dtype, rates,
                                              calls)
                      for form, calls in (("shipped", S.M1_CALLS),
                                          ("pow forms", POW_FORMS))}
            result["floor"][name][c.case] = dict(bytes_ms=bound_ms,
                                                 **floors)
            print(f"  band_movs {c.case} {dtype}: math floor "
                  f"{floors['shipped']:.4f} ms shipped, "
                  f"{floors['pow forms']:.4f} ms in the pow forms; bytes "
                  f"bound {bound_ms:.4f} ms", flush=True)
        readings = {c.case: [] for c in cases}
        for form in ("shipped", "nomath", "nomath", "shipped"):
            use(form)
            for c in cases:
                big = c.inputs[0].numel() > 4_000_000
                ms, _ = S.cuda_ms(c.kernel, calls=5 if big else 20,
                                  rounds=5, cover_host=True)
                readings[c.case].append(ms)
        use("shipped")
        result["nomath"][name] = readings
        for case, ms in readings.items():
            print(f"  band_movs {case} {dtype}, ms shipped / no math / no "
                  f"math / shipped: " + " / ".join(f"{t:.4f}" for t in ms),
                  flush=True)
        del cases, args, kwargs, basic
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="root of the checkout to compare "
                        "with")
    parser.add_argument("--split", action="store_true",
                        help="read M1 of this checkout apart")
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
    print("dtype, kernel and case: ms, parent / this / this / parent "
          "(share of the bytes bound)")
    ab.table(runs, lambda t: f"{t['ms']:.4f} "
             f"({t['bound_ms'] / t['ms']:.1%})")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
