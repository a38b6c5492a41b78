#!/usr/bin/env python3
"""Sweep the standard-ambiguity settings for best conformance (the port of
tools/optimize_settings.py, itself the Python equivalent of the
reference's src/optimize_settings.hs): evaluate all 2^5 combinations of
the Settings flags on the BS.1387 conformance items and report the DI
RMSE against the ITU reference values.  Requires CONFORMANCEDATADIR
(exit 77 without it).

  python3 gstpeaq_tpu_torch/tools/optimize_settings.py [--advanced]
      [--precision TIER]

The device is CUDA unless GSTPEAQ_PLATFORM names another (`cpu`); without
CUDA and without that variable the tool exits 1.
"""

from __future__ import annotations

import argparse
import itertools
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gstpeaq_tpu_torch import api  # noqa: E402
from gstpeaq_tpu_torch import conformance  # noqa: E402
from gstpeaq_tpu_torch.constants import Settings  # noqa: E402

FLAGS = [
    "swap_mod_patts_for_noise_loudness_movs",
    "center_ehs_correlation_window",
    "ehs_subtract_dc_before_window",
    "use_floor_for_steps_above_threshold",
    "clamp_movs",
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--advanced", action="store_true")
    parser.add_argument("--precision", choices=sorted(api.DTYPES),
                        default=None,
                        help=f"precision tier (default {api.DEFAULT_DTYPE})")
    args = parser.parse_args(argv)
    if conformance.data_dir() is None:
        print("CONFORMANCEDATADIR not set, sweep NOT run.")
        return 77
    device = api.platform_device("optimize_settings")
    if device is None:
        return 1
    results = []
    for bits in itertools.product([False, True], repeat=len(FLAGS)):
        settings = Settings(**dict(zip(FLAGS, bits)))
        rows = conformance.run(args.advanced, args.precision,
                               settings=settings, device=device)
        d_itu = np.array([r.delta_itu for r in rows])
        rmse = float(np.sqrt((d_itu ** 2).mean()))
        results.append((rmse, bits))
        print(f"{''.join(str(int(b)) for b in bits)}  RMSE {rmse:.4f}",
              flush=True)
    results.sort()
    best_rmse, best_bits = results[0]
    print("\nbest:", dict(zip(FLAGS, best_bits)), f"RMSE {best_rmse:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
