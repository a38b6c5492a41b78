#!/usr/bin/env python3
"""The device time of one staged batch split by the call sites of its
eager work, on one CUDA card, for this checkout or another.  Run from the
repository root:

    python3 gstpeaq_tpu_torch/tools/epilogue_sites.py [--parent DIR]

Each checkout runs in a subprocess of its own (with --parent: parent,
this, this, parent), its package imported from its root.  It wraps each
function of SITES its package has in a torch.profiler.record_function
range of the function's name, on the module the pipelines call it
through: the band-domain epilogues (the level adapter after its stage-1
smoothing, `level_adapt.adapt_stage2`, or `adapt_stage2_factors` where
the kernels L1 and L2 run; `movs.modulation_difference`,
`noise_loudness`, `nmr_from_bands`, `prob_detect`, the gates'
`fft_ear.loudness`, and `cuda_band.band_movs`, M1), and every function
the pipelines call eagerly: the signals' `framing.dequantize` and
`blocks_hop`, the FFT ear's `stateless_pair_movs` (around S1, the rDFT,
S2 and K3) and `time_smear` (around K1), EHS's `movs.ehs_from_difference`
(or `cuda_ehs.ehs_frames`, E1, and `movs.ehs_valid` where E1 runs), the
accumulators of `accum`, `loudness_gates` and `energy_totals`, the
cognitive model's forward, and the FB ear's `process_signal` (its casts,
around D3, F1, D1, D2) and `back_and_forward_masking` (its state's
slices, around W1 and K1).
Then, per configuration (basic float64 and float32 at microbatch 64,
advanced float64 and float32 at 32, bench.py's 64 stereo 10 s pairs, one
staged dispatch under the profiler): the batch's device ms (the device
rows but the ranges' own) and operations; per range its calls and the
device ms and count of the PyTorch kernels launched inside it and not
inside a range nested in it (the hand kernels, csrc/*.cu, are left out
of every range: the eager work alone); each hand kernel's device ms by
its name; and the device ms outside every range and every hand kernel
(`outside_ms`: the batch's less the ranges' and the hand kernels'), with
the part of it each top-level operation launched (`outside_ops`, the
largest first).  Prints the card's name and power limit, then one JSON
object.  `chip_smoke.py` phase 9 calls `profile_sites` on this
checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIGS = (("basic", "float64", 64), ("basic", "float32", 64),
           ("advanced", "float64", 32), ("advanced", "float32", 32))
# (module of the package, function): the ranges, where the module has it;
# a function imported by name into a second module is wrapped in both
SITES = (("models.level_adapt", "adapt_stage2"),
         ("models.level_adapt", "adapt_stage2_factors"),
         ("models.movs", "modulation_difference"),
         ("models.movs", "noise_loudness"),
         ("models.movs", "nmr_from_bands"),
         ("models.movs", "prob_detect"),
         ("ops.fft_ear", "loudness"),
         ("ops.cuda_band", "band_movs"),
         ("ops.framing", "dequantize"),
         ("ops.framing", "blocks_hop"),
         ("ops.fft_ear", "stateless_pair_movs"),
         ("ops.fft_ear", "time_smear"),
         ("models.movs", "ehs_from_difference"),
         ("ops.cuda_ehs", "ehs_frames"),
         ("models.movs", "ehs_valid"),
         ("models.accum", "activity"),
         ("models.accum", "avg"),
         ("models.accum", "avg_log"),
         ("models.accum", "rms"),
         ("models.accum", "rms_asym"),
         ("models.accum", "adb"),
         ("models.accum", "filtered_max"),
         ("models.accum", "avg_window"),
         ("models.basic", "loudness_gates"),
         ("models.advanced", "loudness_gates"),
         ("models.basic", "energy_totals"),
         ("models.advanced", "energy_totals"),
         ("models.nn", "CognitiveModel.forward"),
         ("ops.fb_ear", "process_signal"),
         ("ops.fb_ear", "back_and_forward_masking"))
HAND = re.compile(r"\b(recurrence_banded|fused_mod_smoothers|spread_fft|"
                  r"slope_state|spread_fb|dc_chain|fir_bank|pair_frames|"
                  r"spectral_movs|frame_gate|levcorr|pattern_adapt|"
                  r"band_movs|ehs_frames|mask_frames)(_\w+)?_kernel")


@contextlib.contextmanager
def ranges():
    """Wrap each site the package has in a range of its function's name
    (a method's with its class); yields the names, and restores the
    functions on exit."""
    import torch
    saved = []
    try:
        for module_name, path in SITES:
            try:
                owner = importlib.import_module(
                    f"gstpeaq_tpu_torch.{module_name}")
            except ImportError:
                continue
            *outer, fn_name = path.split(".")
            for attr in outer:
                owner = getattr(owner, attr, None)
            fn = getattr(owner, fn_name, None)
            if fn is None:
                continue

            def ranged(*args, _fn=fn, _name=path, **kwargs):
                with torch.profiler.record_function(_name):
                    return _fn(*args, **kwargs)
            setattr(owner, fn_name, ranged)
            saved.append((owner, fn_name, fn, path))
        yield sorted({name for *_, name in saved})
    finally:
        for owner, fn_name, fn, _ in reversed(saved):
            setattr(owner, fn_name, fn)


def kernels_of(event, names, inside: str = "") -> list:
    """The (name, us) of the PyTorch kernels an event and its children
    launched, the hand kernels and those of a child range (any of `names`
    but `inside`, the event's own range) left out."""
    out = [(k.name, k.duration) for k in getattr(event, "kernels", [])
           if not HAND.search(k.name)]
    for child in event.cpu_children:
        if child.name == inside or child.name not in names:
            out += kernels_of(child, names, inside)
    return out


def profile_sites(configs, pairs) -> dict:
    """Per (mode, tier, microbatch) of `configs`, one staged dispatch of
    `pairs` under the profiler with the sites in ranges: the batch's device
    ms and operations, each range's calls, device ms and kernels, and each
    hand kernel's device ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gstpeaq_tpu_torch.tools import bench as B
    out = {}
    with ranges() as names:
        for mode, tier, microbatch in configs:
            dispatch = B.staged(mode == "advanced", tier, microbatch, pairs)
            [o.cpu() for o in dispatch()]                  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                [o.cpu() for o in dispatch()]
                torch.cuda.synchronize()
            device = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.key not in names]
            sites, outside = {}, {}
            for e in prof.events():
                if e.device_type != DeviceType.CPU:
                    continue
                if e.name not in names:
                    if e.cpu_parent is None:
                        # a top-level operation: its kernels are outside
                        # every range
                        us = sum(d for _, d in kernels_of(e, names))
                        if us:
                            outside[e.name] = outside.get(e.name, 0.0) \
                                + us / 1e3
                    continue
                # a range inside a range of its own name counts once
                parent, nested = e.cpu_parent, False
                while parent is not None:
                    nested = nested or parent.name == e.name
                    parent = parent.cpu_parent
                if nested:
                    continue
                ks = kernels_of(e, names, e.name)
                site = sites.setdefault(e.name, {"calls": 0,
                                                 "device_ms": 0.0,
                                                 "kernels": 0})
                site["calls"] += 1
                site["device_ms"] += sum(us for _, us in ks) / 1e3
                site["kernels"] += len(ks)
            hand = {}
            for e in device:
                m = HAND.search(e.key)
                if m:
                    hand[m[1]] = (hand.get(m[1], 0.0)
                                  + e.self_device_time_total / 1e3)
            device_ms = sum(e.self_device_time_total for e in device) / 1e3
            out[f"{mode} {tier} ({microbatch})"] = {
                "device_ms": device_ms,
                "device_ops": sum(e.count for e in device),
                "sites": sites, "hand_kernels_ms": hand,
                "outside_ms": device_ms - sum(
                    s["device_ms"] for s in sites.values())
                - sum(hand.values()),
                "outside_ops": dict(sorted(outside.items(),
                                           key=lambda kv: -kv[1])[:8])}
            del dispatch
            torch.cuda.empty_cache()
    return out


def child(root: str) -> None:
    """One checkout's readings, as a JSON line on stdout."""
    sys.path.insert(0, root)
    from gstpeaq_tpu_torch.tools import bench as B
    from gstpeaq_tpu_torch.utils.benchpairs import make_pairs
    assert pathlib.Path(B.__file__).resolve().is_relative_to(
        pathlib.Path(root).resolve()), B.__file__
    pairs = make_pairs(B.BATCH, B.SECONDS)
    print(json.dumps({"root": root, **profile_sites(CONFIGS, pairs)}),
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="root of a checkout to compare "
                        "with (parent, this, this, parent)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    roots = [str(ROOT)]
    if args.parent:
        parent = str(pathlib.Path(args.parent).resolve())
        roots = [parent, str(ROOT), str(ROOT), parent]
    runs = []
    for root in roots:
        done = subprocess.run(
            [sys.executable, __file__, "--child", root],
            capture_output=True, text=True, cwd=root)
        if done.returncode:
            print(done.stderr[-3000:], file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.splitlines()[-1]))
        print(f"  {runs[-1]}", flush=True)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
