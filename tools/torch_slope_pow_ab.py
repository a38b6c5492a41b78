#!/usr/bin/env python3
"""D1 `slope_state` of the PyTorch/CUDA port with its drive's DIST^s as
exp(s ln DIST), the form in gstpeaq_tpu_torch/csrc/fb_spread.cu, against
pow(DIST, s), on one CUDA card.  Run from the repository root:

    python3 tools/torch_slope_pow_ab.py

The pow form is a copy of csrc/ with slope_drive's last line rewritten,
built by ops/_build.py into a directory of its own under the git-ignored
gstpeaq_tpu_torch/_build/.  On the 10 s stereo pair's FB rows
[2, 2, 40, 15000] (as chip_smoke.py's phase 3 makes them), in float32 and
float64, each form's error against the plain version (max|d| / max|plain|)
and its device time between CUDA events (chip_smoke.cuda_ms: the mean of
20 calls behind a sleep that covers the host's enqueue, median of 10
rounds), in the order exp, pow, pow, exp.  Prints the card's name and power
limit, then one JSON object of the times in ms per dtype and form.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
from gstpeaq_tpu_torch import api  # noqa: E402
from gstpeaq_tpu_torch import earparams as EP  # noqa: E402
from gstpeaq_tpu_torch.ops import _build, cuda_dc, cuda_fb  # noqa: E402
from gstpeaq_tpu_torch.ops import fb_ear as FB  # noqa: E402

EXP_DEF = "__device__ __forceinline__ double exp_t(double x) { return exp(x); }"
POW_DEFS = (
    "\n__device__ __forceinline__ float pow_t(float x, float y) "
    "{ return powf(x, y); }\n"
    "__device__ __forceinline__ double pow_t(double x, double y) "
    "{ return pow(x, y); }")
EXP_DRIVE = "  return oma * exp_t(s * static_cast<T>(kLnDist));"
# DIST, src/fbearmodel.c:50
POW_DRIVE = "  return oma * pow_t(static_cast<T>(0.921851456499719), s);"


def pow_sources(variant: pathlib.Path) -> pathlib.Path:
    """A copy of csrc/ under `variant` whose D1 drive is pow(DIST, s)."""
    shutil.rmtree(variant, ignore_errors=True)
    csrc = variant / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "fb_spread.cu"
    text = src.read_text()
    if text.count(EXP_DEF) != 1 or text.count(EXP_DRIVE) != 1:
        raise SystemExit("fb_spread.cu's slope_drive is no longer the exp "
                         "form this script rewrites")
    src.write_text(text.replace(EXP_DEF, EXP_DEF + POW_DEFS)
                   .replace(EXP_DRIVE, POW_DRIVE))
    return csrc


def use(csrc: pathlib.Path, build_dir: pathlib.Path) -> None:
    """Load (building first if needed) the kernels of `csrc`."""
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    _build.library.cache_clear()
    _build.library()


def main() -> None:
    card = S.phase_card()
    variant = _build.BUILD_DIR / "slope_pow"
    forms = {"exp": (_build.CSRC, _build.BUILD_DIR),
             "pow": (pow_sources(variant), variant / "build")}
    for csrc, build_dir in forms.values():
        use(csrc, build_dir)
    pair10 = S.ten_second_pair()
    times = {}
    for dtype in S.DTYPES:
        k = FB.build_consts(EP.fb_ear_params(), dtype, "cuda")
        c1 = 24.0 + 230.0 / k.fc
        hp2, _ = cuda_dc.dc_chain_plain(S.fb_rows(pair10, k), k.level)
        with api.full_precision_matmuls():
            re, im = FB.filter_bank(k, hp2)
        want = cuda_fb.slope_state_plain(re, im, c1, k.slope_a)
        for form in ("exp", "pow", "pow", "exp"):
            use(*forms[form])
            got = cuda_fb.slope_state(re, im, c1, k.slope_a)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            ms, _ = S.cuda_ms(
                lambda: cuda_fb.slope_state(re, im, c1, k.slope_a),
                calls=20, cover_host=True)
            print(f"slope_state {form} {dtype} {tuple(re.shape)}: "
                  f"{ms:.5f} ms, max|d|/max|plain| {rel:.3e}", flush=True)
            S.check(rel < S.BARS[dtype], f"{form} {dtype} disagrees with "
                    "the plain version")
            times.setdefault(str(dtype), {}).setdefault(form, []).append(ms)
    print(card)
    print(json.dumps({"slope_state_ms": times}))


if __name__ == "__main__":
    main()
