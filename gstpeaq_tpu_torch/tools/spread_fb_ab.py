#!/usr/bin/env python3
"""D2 `spread_fb` of the PyTorch/CUDA port in its shipped form (one thread per
part, real or imaginary, of each instant; tiles of 64 / 32 instants in
float / double, one tile a block in shared memory) against its variants,
and optionally against another checkout's D2, on one CUDA card.  Run from
the repository root:

    python3 gstpeaq_tpu_torch/tools/spread_fb_ab.py [--parent DIR]
        [--forms A,B,...]

Each variant (FORMS) is a copy of csrc/ with some of fb_spread.cu's D2
lines rewritten, built by ops/_build.py into a directory of its own
under the git-ignored gstpeaq_tpu_torch/_build/: "tile32" and "tile64"
give both types tiles of 32 or 64 instants, "group32" moves 32 sources of
the upper walk at once in place of 16, "blocks1" runs one block an SM,
"div32" finds a tile's lead by a 32-bit division where the flat index
and n fit one;
"diag-copy-only", "diag-walk-only", "diag-neither", "diag-no-stores" and
"diag-nothing" leave out the walk, the copies, both, the stores of E0 (a
store whose condition never holds keeps the work alive) or all three, to
time the rest (their results are not checked).  With --parent, DIR is the
root of another checkout (e.g. the parent commit from `git archive`): its
csrc/ is built the same way and its D2 called through its own C entry,
which takes the [40, 40] lower table in place of CL (the form before the
recurrence); it is skipped at lead counts its grid refuses (> 65,535).

At each D2 shape of chip_smoke.py's phase 3 (the 10 s stereo pair's FB rows
[2, 2, 40, 15000] as phase 3 makes them, then random inputs at I = 37 and 1
and at the flat grid's edges), in float32 and float64, each form's error
against the plain version (max|d| / max|plain|) and its device time between
CUDA events (chip_smoke.cuda_ms: the mean of 20 calls behind a sleep that
covers the host's enqueue, median of 10 rounds), the host's time to enqueue
one call, and the kernel's own time per launch under torch.profiler (20
calls), in the order parent,
shipped, the variants, the variants again in reverse, shipped, parent;
and, as a floor, the time of torch.addcmul on the same three inputs, which
moves D2's bytes in one streaming pass.
Prints ptxas's report (registers, spills) of each form's D2, the card's
name and power limit, then one JSON object of the times in ms per dtype,
shape and form.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
from gstpeaq_tpu_torch import api  # noqa: E402
from gstpeaq_tpu_torch import earparams as EP  # noqa: E402
from gstpeaq_tpu_torch.ops import _build, cuda_dc, cuda_fb  # noqa: E402
from gstpeaq_tpu_torch.ops import fb_ear as FB  # noqa: E402

SHIPPED_TILE = "constexpr int kTileInstants = sizeof(T) == 4 ? 64 : 32;"
SHIPPED_GROUP = ("constexpr int kWalkGroup = 16;          // sources the "
                 "upper walk moves at once")
WALK = "  for (int top = kZ - 2; top >= 0; top -= kWalkGroup) {"
COPIES = ("  for (int row = row0; row < kZ; row += kStride, re += step) {",
          "  for (int row = row0; row < kZ; row += kStride, im += step) {",
          "  for (int row = row0; row < kZ - 1; row += kStride, c += step) {")
NO_WALK = [(WALK, WALK.replace("top = kZ - 2", "top = -1"))]
NO_COPIES = [(line, line.replace("row = row0", "row = kZ")) for line in COPIES]
STORE = "    if (live && part == (c & 1)) e0[base + c * n] = e;"
NO_STORES = [(STORE, STORE.replace("part == (c & 1)", "e == T(-1)"))]
GRID = "      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);"
DIV = "  const long long lead = g / n;"
DIV32 = ("  const long long lead = (g | n) <= 0xffffffffLL\n"
         "      ? static_cast<long long>(static_cast<unsigned>(g) /\n"
         "                               static_cast<unsigned>(n))\n"
         "      : g / n;")
# each form: fb_spread.cu's lines rewritten.  The "diag-" forms leave out a
# part of the work to time the rest, so their results are not checked
FORMS = {
    "tile32": [(SHIPPED_TILE,
                "constexpr int kTileInstants = sizeof(T) == 4 ? 32 : 32;")],
    "tile64": [(SHIPPED_TILE,
                "constexpr int kTileInstants = sizeof(T) == 4 ? 64 : 64;")],
    "group32": [(SHIPPED_GROUP, "constexpr int kWalkGroup = 32;")],
    "blocks1": [(GRID, GRID.replace("(per_sm > 0 ? per_sm : 1)", "1"))],
    "div32": [(DIV, DIV32)],
    "diag-copy-only": NO_WALK,
    "diag-walk-only": NO_COPIES,
    "diag-neither": NO_WALK + NO_COPIES,
    "diag-no-stores": NO_STORES,
    "diag-nothing": NO_WALK + NO_COPIES + NO_STORES,
}
# the D2 entry before the recurrence: (re, im, cu, lower, e0, leads, n,
# stream), lower the [40, 40] table
_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
PARENT_ARGS = (_P, _P, _P, _P, _P, _I64, _I64, _P)
PARENT_MAX_LEADS = 65535
RANDOM_SHAPES = ((2, 40, 37), (2, 40, 1), (70000, 40, 3), (5, 40, 7),
                 (9, 40, 13), (3, 40, 10))


def variant_sources(variant: pathlib.Path, rewrites) -> pathlib.Path:
    """A copy of csrc/ under `variant` with fb_spread.cu's lines rewritten,
    each (old, new) of `rewrites`."""
    shutil.rmtree(variant, ignore_errors=True)
    csrc = variant / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "fb_spread.cu"
    text = src.read_text()
    for old, new in rewrites:
        if text.count(old) != 1:
            raise SystemExit(f"fb_spread.cu no longer holds {old!r}, which "
                             "this script rewrites")
        text = text.replace(old, new)
    src.write_text(text)
    return csrc


def use(csrc: pathlib.Path, build_dir: pathlib.Path) -> pathlib.Path:
    """Load (building first if needed) the kernels of `csrc`; returns the
    library's path."""
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    _build.library.cache_clear()
    _build.library()
    return _build.library_path()


def ptxas_lines(lib: pathlib.Path) -> list[str]:
    """ptxas's registers and spills of each spread_fb kernel in lib's
    build log."""
    out, entry, spills = [], None, ""
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"spread_fb_kernelI([fd])Li(\d+)E", line)
            entry = m and (f"{'double' if m[1] == 'd' else 'float'} "
                           f"copies of {m[2]}")
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "Used" in line:
            out.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spills}")
            entry = None
    return out


def parent_call(lib_path: pathlib.Path):
    """The parent checkout's D2 as fn(re, im, cu, lower) -> e0."""
    lib = ctypes.CDLL(str(lib_path))
    entries = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"peaq_spread_fb_{suffix}")
        fn.argtypes, fn.restype = PARENT_ARGS, ctypes.c_int
        entries[dtype] = fn

    def call(re_, im, cu, lower):
        e0 = torch.empty_like(re_)
        n = re_.shape[-1]
        status = entries[re_.dtype](
            re_.data_ptr(), im.data_ptr(), cu.data_ptr(), lower.data_ptr(),
            e0.data_ptr(), re_.numel() // (40 * n), n,
            torch.cuda.current_stream().cuda_stream)
        S.check(status == 0, f"parent spread_fb: CUDA error {status}")
        return e0
    return call


def profiled_ms(fn, calls: int = 20) -> float:
    """The spread_fb kernel's own device time per launch in ms over `calls`
    calls of fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spread_fb" in e.key]
    return (sum(e.self_device_time_total for e in rows) / 1e3
            / max(sum(e.count for e in rows), 1))


def shapes(dtype, pair10, rng):
    """(label, re, im, cu, k) at each D2 shape of chip_smoke.py's phase 3."""
    k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
    hp2, _ = cuda_dc.dc_chain_plain(S.fb_rows(pair10, k), k.level)
    with api.full_precision_matmuls():
        re_, im = FB.filter_bank(k, hp2)
    cu = cuda_fb.slope_state_plain(re_, im, 24.0 + 230.0 / k.fc, k.slope_a)
    out = [(f"main {list(re_.shape)}", re_, im, cu, k)]
    for shape in RANDOM_SHAPES:
        t = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")
        out.append((f"{list(shape)}",
                    t(rng.standard_normal(shape) * 100.0),
                    t(rng.standard_normal(shape) * 100.0),
                    t(rng.uniform(0.2, 0.9, shape)), k))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="root of another checkout whose D2 to time too")
    ap.add_argument("--forms", default=",".join(FORMS),
                    help="the variants to time, from " + ", ".join(FORMS))
    args = ap.parse_args()
    card = S.phase_card()
    shipped = (_build.CSRC, _build.BUILD_DIR)
    variants = [f for f in args.forms.split(",") if f]
    forms = {"shipped": shipped}
    for form in variants:
        where = shipped[1] / f"spread_fb_{form}"
        forms[form] = (variant_sources(where, FORMS[form]), where / "build")
    libs = {form: use(*where) for form, where in forms.items()}
    parent = None
    if args.parent is not None:
        where = (args.parent / "gstpeaq_tpu_torch" / "csrc",
                 shipped[1] / "spread_fb_parent")
        libs["parent"] = use(*where)
        parent = parent_call(libs["parent"])
    for form, lib in libs.items():
        for line in ptxas_lines(lib):
            print(f"ptxas {form} spread_fb {line}")
    order = ["shipped", *variants, *variants[::-1], "shipped"]
    if parent is not None:
        order = ["parent"] + order + ["parent"]
    pair10 = S.ten_second_pair()
    rng = np.random.default_rng(9)
    times = {}
    for dtype in S.DTYPES:
        for label, re_, im, cu, k in shapes(dtype, pair10, rng):
            want = cuda_fb.spread_fb_plain(re_, im, cu, k.lower_matrix)
            stream, _ = S.cuda_ms(lambda: torch.addcmul(re_, im, cu),
                                  calls=20, cover_host=True)
            print(f"stream floor (torch.addcmul: D2's bytes, 3 read, 1 "
                  f"written) {dtype} {label}: {stream:.5f} ms", flush=True)
            times.setdefault(str(dtype), {}).setdefault(
                label, {})["addcmul"] = [stream]
            for form in order:
                if form == "parent":
                    if re_.numel() // (40 * re_.shape[-1]) > PARENT_MAX_LEADS:
                        continue
                    fn = lambda: parent(re_, im, cu, k.lower_matrix)
                else:
                    use(*forms[form])
                    fn = lambda: cuda_fb.spread_fb(re_, im, cu, k.cl)
                got = fn()
                rel = ((got - want).abs().max() / want.abs().max()).item()
                ms, host = S.cuda_ms(fn, calls=20, cover_host=True)
                print(f"spread_fb {form} {dtype} {label}: {ms:.5f} ms, "
                      f"kernel {profiled_ms(fn):.5f} ms under the profiler, "
                      f"host enqueue {host:.4f} ms, max|d|/max|plain| "
                      f"{rel:.3e}", flush=True)
                S.check(form.startswith("diag-") or rel < S.BARS[dtype],
                        f"{form} {dtype} {label} disagrees with the plain "
                        "version")
                times.setdefault(str(dtype), {}).setdefault(
                    label, {}).setdefault(form, []).append(ms)
    use(*shipped)
    print(card)
    print(json.dumps({"spread_fb_ms": times}))


if __name__ == "__main__":
    main()
