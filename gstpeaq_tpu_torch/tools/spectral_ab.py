#!/usr/bin/env python3
"""S2 `spectral_movs` (csrc/spectral.cu) of this checkout against another's,
on one CUDA card.  Run from the repository root:

    python3 gstpeaq_tpu_torch/tools/spectral_ab.py --parent DIR
    python3 gstpeaq_tpu_torch/tools/spectral_ab.py --split
    python3 gstpeaq_tpu_torch/tools/spectral_ab.py --sweep

DIR is the root of another checkout (e.g. the parent commit from `git
archive`).  Each checkout runs in a subprocess of its own, its package and
its chip_smoke.py imported from its root and its kernels built under its
own gstpeaq_tpu_torch/_build/, in the order parent, this, this, parent.
Each run takes the inputs chip_smoke.py gives S2 at every shape the main
path gives it (shape_cases: per pair with the basic and the advanced
call's flags, bench's basic and advanced batches, the basic and advanced
FFT chunk steps at 64 and 1,024 frames with one stream and 16) in
float32 and float64, and runs its own ops/cuda_spectral.py::spectral_movs
on them: the outputs against the plain version's (chip_smoke.
spectral_check: BARS, the bandwidth indices and validity equal), two
launches bit for bit, and the device time of one call between CUDA
events (chip_smoke.cuda_ms: the mean of `calls` calls behind a sleep that
covers the host's enqueue, median of 5 rounds).  This checkout counts
each case's bound in bytes over the bins the call reads (bound_ms).
Prints the card's name and power limit, a table of the four readings per
dtype and case, then one JSON object of the runs.

--split reads S2 of this checkout apart, in one process: the build's
registers, spills and shared memory of S2 and the blocks an SM they leave
resident (occupancy()), and at each shape, in both dtypes: S2's time; its
bound counted both as first (all 1,025 bins of both spectra) and over the
bins the call reads (cuda_spectral.bins_read); a read floor for those
bins (`spectra[..., :bins, :].sum()`, one PyTorch reduction that reads
them once: a yardstick, not a library call, since it computes no MOV);
and a math floor, the square roots, divisions and log1p a row
(row_calls) at the card's measured rates of each (chip_smoke.
band_math_rates).  Prints its readings, then one JSON object.

--sweep times S2 of this checkout at each shape and dtype in each launch
movs_plan may take: a row a block without and with the L2 prefetch, and
the ring at every depth (1 up to the rows of a block and what its shared
memory holds, at most MAX_SWEEP), in the shipped source and in each of VARIANTS (a copy of
csrc/ with one constant rewritten, built under
gstpeaq_tpu_torch/_build/spectral_<name>/), every reading held to the
plain version; the shipped plan is marked.  Prints its readings, then one
JSON object.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import re
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BINS = 1025             # an rDFT row's bins
# an H100's register file, threads and blocks an SM
SM_REGISTERS = 65536
SM_THREADS = 2048
SM_BLOCKS = 32
# --sweep: the deepest ring it times, and the variants of csrc/spectral.cu
# beside the shipped one (name: the line and the line it becomes)
MAX_SWEEP = 6
VARIANTS = {"reduce8": ("constexpr int kReduceWarps = 4;",
                        "constexpr int kReduceWarps = 8;"),
            "lanes4": ("constexpr int kMaxBandLanesFloat = 1;",
                       "constexpr int kMaxBandLanesFloat = 4;")}


def row_calls(hi: int) -> dict:
    """The library calls one row of S2 makes, by name of
    chip_smoke.band_math_rates: the noise spectrum's two square roots and
    division at each bin below group_bin_hi, and EHS's division and log1p
    (or log) at each of its 512 bins."""
    return {"sqrt": 2 * hi, "div": hi + 512, "log1p": 512}


def shape_cases(S, dtype, pair10) -> list:
    """S2 at the shapes the main path gives it, as (case, flags, k,
    spectra): per pair with the basic and the advanced call's flags,
    bench's basic and advanced batch, the FFT chunk steps at 64 and 1,024
    frames with one stream and the pool's 16 under the basic and the
    advanced step's flags (chip_smoke's S2 cases, built alone)."""
    from gstpeaq_tpu_torch import constants as C
    from gstpeaq_tpu_torch import earparams as EP
    from gstpeaq_tpu_torch.ops import fft_ear as FE
    kb, ka = (FE.build_consts(EP.fft_ear_params(z), dtype, "cuda")
              for z in (C.BASIC_BAND_COUNT, C.ADVANCED_FFT_BAND_COUNT))
    out = []

    def add(label, k, spectra, ref_only, bandwidth):
        out.append((S.movs_case(k, label, spectra, ref_only, bandwidth),
                    (ref_only, bandwidth), k, spectra))

    spectra = S.spectra_of(kb, S.fft_blocks(pair10, 1, S.MAIN[3]))
    add(f"pair basic {list(spectra.shape)}", kb, spectra, False, True)
    add("pair advanced (ref only)", ka, spectra, True, False)
    frames = S.batch_shapes()["basic"][-1]
    for label, lead, k, flags in (
            ("basic", S.MICROBATCH["basic"], kb, (False, True)),
            ("advanced (ref only)", S.MICROBATCH["advanced"], ka,
             (True, False))):
        spectra = S.spectra_of(k, S.fft_blocks(pair10, lead, frames))
        add(f"batch {label} {list(spectra.shape)}", k, spectra, *flags)
    for chunk in (S.STREAM_CHUNK, S.TOOL_CHUNK):
        for n in (1, S.POOL):
            spectra = S.spectra_of(kb, S.fft_blocks(pair10, n, chunk))
            add(f"chunk {chunk} basic N={n}", kb, spectra, False, True)
            add(f"chunk {chunk} FFT step N={n}", ka, spectra, False, False)
    return out


def traffic(S, spectra, k, bandwidth: bool, case, got) -> dict:
    """What S2's bytes bound counts of a case: the spectra's bytes a bin
    (both spectra, every row), the bytes of the call's other inputs and of
    its outputs, and what decides the bins read."""
    rest = sum(t.numel() * t.element_size()
               for t in (*case.inputs[1:], *S.tensors_of(got)))
    return {"bytes_a_bin": spectra.numel() // BINS * spectra.element_size(),
            "rest": rest, "hi": k.group_bin_hi, "bandwidth": bandwidth}


def bound_ms(reading: dict, bytes_per_s: float, bins: int | None = None):
    """S2's bytes bound in ms of a reading with traffic()'s keys: over the
    bins the call reads (cuda_spectral.bins_read), or over `bins`."""
    from gstpeaq_tpu_torch.ops import cuda_spectral
    if bins is None:
        bins = cuda_spectral.bins_read(reading["hi"], reading["bandwidth"])
    return ((reading["bytes_a_bin"] * bins + reading["rest"])
            / bytes_per_s * 1e3)


def calls_of(spectra) -> int:
    """Calls a round: 5 at the batch shapes, 20 elsewhere."""
    return 5 if spectra.numel() > 40_000_000 else 20


def child(root: str) -> None:
    """One checkout's checks and times, as a JSON line on stdout."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as S
    from gstpeaq_tpu_torch.ops import cuda_spectral
    for module in (S, cuda_spectral):
        assert pathlib.Path(module.__file__).resolve().is_relative_to(
            pathlib.Path(root).resolve()), module.__file__
    pair10 = S.ten_second_pair()
    out = {"root": root}
    for dtype in S.DTYPES:
        times = {}
        for c, (_, bandwidth), k, spectra in shape_cases(S, dtype, pair10):
            got = c.kernel()
            _, rel, ok, _ = S.spectral_check(c.name, got, c.plain(), dtype)
            same = torch.equal(S.stacked(got), S.stacked(c.kernel()))
            ms, _ = S.cuda_ms(c.kernel, calls=calls_of(spectra), rounds=5,
                              cover_host=True)
            times[c.case] = dict(ms=ms, rel=rel, ok=bool(ok and same),
                                 **traffic(S, spectra, k, bandwidth, c, got))
            del got
        out[str(dtype).removeprefix("torch.")] = times
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def occupancy(regs: int, static: int, dynamic: int, threads: int) -> int:
    """The blocks an SM that a kernel of `regs` registers a thread,
    `static` + `dynamic` bytes of shared memory and `threads` threads a
    block leaves resident on an H100, counted as the CUDA occupancy
    calculator counts them (registers in 256 a warp)."""
    from gstpeaq_tpu_torch.ops.cuda_fir import BLOCK_RESERVED, SM_SHARED
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // 256) * 256
    by_regs = SM_REGISTERS // (per_warp * warps)
    by_shared = SM_SHARED // (static + dynamic + BLOCK_RESERVED)
    return min(SM_BLOCKS, SM_THREADS // threads, by_regs, by_shared)


def build_report(plan_shared: dict) -> tuple[list[str], dict]:
    """ptxas's lines for S2's kernels (registers, spills, static shared
    memory) from the build's log, the dynamic shared memory a block and
    the resident blocks an SM (occupancy) of each launch and dtype at the
    basic call's shapes (plan_shared: the launch's dynamic bytes by
    (launch, dtype name); the ring at the batch, a row a block per pair)."""
    from gstpeaq_tpu_torch.ops import _build, cuda_spectral
    threads = {"ring": cuda_spectral.MOVS_THREADS,
               "row": cuda_spectral.ROW_THREADS}
    path, _ = _build.build()
    lines, entry, spills, resident = [], None, "", {}
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"spectral_movs(_row)?_kernelI([fd])", line)
            entry = m and ("row" if m[1] else "ring",
                           "float32" if m[2] == "f" else "float64")
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            static = int(smem[1]) if smem else 0
            dynamic = plan_shared.get(entry, 0)
            n = threads[entry[0]]
            resident[" ".join(entry)] = occupancy(regs, static, dynamic, n)
            lines.append(f"S2 {' '.join(entry)}: "
                         f"{line.split(':', 1)[1].strip()}; {spills}; {n} "
                         f"threads and {dynamic} B of dynamic shared memory "
                         f"a block: {resident[' '.join(entry)]} blocks an "
                         "SM")
            entry = None
    return lines, resident


def basic_plans(S) -> dict:
    """movs_plan's dynamic shared memory a block at the basic call's
    shapes, by (launch, dtype name): the ring at the batch, a row a block
    per pair."""
    import torch

    from gstpeaq_tpu_torch import constants as C
    from gstpeaq_tpu_torch import earparams as EP
    from gstpeaq_tpu_torch.ops import cuda_spectral
    from gstpeaq_tpu_torch.ops import fft_ear as FE
    k = FE.build_consts(EP.fft_ear_params(C.BASIC_BAND_COUNT))
    batch = 2 * S.MICROBATCH["basic"] * S.batch_shapes()["basic"][-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype in S.DTYPES:
        name = str(dtype).removeprefix("torch.")
        for launch, rows in (("ring", batch), ("row", 2 * S.MAIN[3])):
            out[launch, name] = cuda_spectral.movs_plan(
                rows, k.group_bin_hi, True, dtype, sms, k.band_count,
                k.group_weights.numel(), rowwise=launch == "row").shared
    return out


def split() -> int:
    """S2 of this checkout read apart (the module docstring's --split)."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as S
    card = S.phase_card()
    S.phase_build()
    report, resident = build_report(basic_plans(S))
    for line in report:
        print(f"  {line}", flush=True)
    rates = S.band_math_rates()
    for dtype, by_op in rates.items():
        print(f"  card rates {dtype}, G calls/s: " + ", ".join(
            f"{op} {by_op[op] / 1e9:.1f}" for op in ("sqrt", "div", "log1p",
                                                      "muladd")), flush=True)
    pair10 = S.ten_second_pair()
    result = {"card": card, "build": report, "resident": resident,
              "rates": {str(d).removeprefix("torch."): r
                        for d, r in rates.items()}, "cases": {}}
    for dtype in S.DTYPES:
        name = str(dtype).removeprefix("torch.")
        result["cases"][name] = {}
        for c, (_, bandwidth), k, spectra in shape_cases(S, dtype, pair10):
            rows = spectra.numel() // (4 * BINS)
            got = c.kernel()
            _, rel, ok, _ = S.spectral_check(c.name, got, c.plain(), dtype)
            t = traffic(S, spectra, k, bandwidth, c, got)
            needed = bound_ms(t, S.MEMORY_BYTES_PER_S)
            first = bound_ms(t, S.MEMORY_BYTES_PER_S, BINS)
            bins = c.inputs[0].shape[-2]
            calls = calls_of(spectra)
            read = c.inputs[0]
            floor_ms, _ = S.cuda_ms(lambda: read.sum(), calls=calls,
                                    rounds=5, cover_host=True)
            ms, _ = S.cuda_ms(c.kernel, calls=calls, rounds=5,
                              cover_host=True)
            used = row_calls(k.group_bin_hi)
            math_ms = rows * sum(n / rates[dtype][op]
                                 for op, n in used.items()) * 1e3
            reading = dict(rows=rows, bins=bins, ms=ms, bound_first_ms=first,
                           bound_ms=needed, read_floor_ms=floor_ms,
                           math_floor_ms=math_ms, calls_a_row=used, rel=rel,
                           ok=bool(ok))
            result["cases"][name][c.case] = reading
            print(f"  spectral_movs {c.case} {dtype}: within bars {ok} "
                  f"(rel {rel:.2e}); S2 {ms:.4f} ms; bound {needed:.4f} ms "
                  f"over {bins} bins ({needed / ms:.1%}), as first counted "
                  f"{first:.4f} ms ({first / ms:.1%}); read floor "
                  f"({bins} bins' sum) {floor_ms:.4f} ms; math floor "
                  f"{math_ms:.4f} ms ({used} a row)", flush=True)
            del got
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


def variant_sources(name: str, csrc: pathlib.Path,
                    build_dir: pathlib.Path) -> pathlib.Path:
    """A copy of csrc/ under build_dir/spectral_<name>/ whose spectral.cu
    has VARIANTS[name]'s line in place of the shipped one."""
    old, new = VARIANTS[name]
    variant = build_dir / f"spectral_{name}"
    shutil.rmtree(variant, ignore_errors=True)
    copy = variant / "csrc"
    shutil.copytree(csrc, copy)
    src = copy / "spectral.cu"
    text = src.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"spectral.cu no longer has one `{old}`")
    src.write_text(text.replace(old, new))
    return copy


def sweep() -> int:
    """S2 of this checkout at every ring depth, shipped and in each
    variant (the module docstring's --sweep)."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as S
    from gstpeaq_tpu_torch.ops import _build, cuda_spectral
    card = S.phase_card()
    S.phase_build()
    forms = {"shipped": (_build.CSRC, _build.BUILD_DIR)}
    for name in VARIANTS:
        forms[name] = (variant_sources(name, _build.CSRC, _build.BUILD_DIR),
                       _build.BUILD_DIR / f"spectral_{name}" / "build")

    def use(form: str) -> None:
        _build.CSRC, _build.BUILD_DIR = forms[form]
        _build.library.cache_clear()
        _build.library()
    for form in forms:
        use(form)
    shipped_plan = cuda_spectral.movs_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pair10 = S.ten_second_pair()
    result = {"card": card, "cases": {}}
    print("dtype, case (rows): ms a row a block, a row a block with the "
          "L2 prefetch, then the ring at depth 1, 2, ...; * the shipped "
          "plan; every reading within BARS of the plain version, bandwidth "
          "indices and validity equal")
    try:
        for dtype in S.DTYPES:
            name = str(dtype).removeprefix("torch.")
            result["cases"][name] = {}
            for c, (_, bandwidth), k, spectra in shape_cases(S, dtype,
                                                             pair10):
                rows = spectra.numel() // (4 * BINS)
                args = (rows, k.group_bin_hi, bandwidth, dtype, sms,
                        k.band_count, k.group_weights.numel())
                plan = shipped_plan(*args)
                chosen = (int(plan.prefetch) if plan.rowwise
                          else 1 + plan.stages)
                deepest = min(MAX_SWEEP, shipped_plan(
                    *args, stages=1 << 30, rowwise=False).stages)
                launches = [dict(rowwise=True, prefetch=False),
                            dict(rowwise=True, prefetch=True)] + [
                    dict(rowwise=False, stages=depth)
                    for depth in range(1, deepest + 1)]
                want = c.plain()
                readings = {}
                for form in forms:
                    use(form)
                    by_depth = []
                    for launch in launches:
                        cuda_spectral.movs_plan = functools.partial(
                            shipped_plan, **launch)
                        _, _, ok, _ = S.spectral_check(c.name, c.kernel(),
                                                       want, dtype)
                        ms, _ = S.cuda_ms(c.kernel, calls=calls_of(spectra),
                                          rounds=5, cover_host=True)
                        by_depth.append({"ms": ms, "ok": bool(ok)})
                    cuda_spectral.movs_plan = shipped_plan
                    readings[form] = by_depth
                    print(f"  {name} {c.case} ({rows}) {form}: " + ", ".join(
                        f"{t['ms']:.4f}" + ("*" if d == chosen else "")
                        + ("" if t["ok"] else " FAILS")
                        for d, t in enumerate(by_depth)), flush=True)
                result["cases"][name][c.case] = dict(
                    rows=rows, plan=chosen, **readings)
                del want
            torch.cuda.empty_cache()
    finally:
        cuda_spectral.movs_plan = shipped_plan
        use("shipped")
    print(json.dumps(result))
    ok = all(t["ok"] for d in result["cases"].values() for case in d.values()
             for form in forms for t in case[form])
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="root of the checkout to compare "
                        "with")
    parser.add_argument("--split", action="store_true",
                        help="read S2 of this checkout apart")
    parser.add_argument("--sweep", action="store_true",
                        help="time S2 of this checkout at every ring depth")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    if args.split:
        return split()
    if args.sweep:
        return sweep()
    if not args.parent:
        parser.error("give --parent DIR, --split or --sweep")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from gstpeaq_tpu_torch.tools import ab
    card = ab.card()
    print(card, flush=True)
    runs = ab.runs(__file__, args.parent)
    for run in runs:
        for dtype in ab.DTYPES:
            for t in run[dtype].values():
                t["bound_ms"] = bound_ms(t, S.MEMORY_BYTES_PER_S)
    print("dtype, case: ms, parent / this / this / parent (share of the "
          "bound over the bins read); every output within BARS of the "
          "plain version's, bandwidth indices and validity equal, two "
          "launches bit for bit")
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
