#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PEAQ (gstpeaq_tpu_torch) on one NVIDIA GPU
and check it.  Run from the repository root:

    python3 chip_smoke.py        # needs one CUDA card, nvcc, no JAX

Phases, each on its own lines:
  1 card      nvidia-smi's name and power limit
  2 build     nvcc builds the kernels K1-K3 from gstpeaq_tpu_torch/csrc
  3 kernels   each kernel against its plain PyTorch version on the card, at
              the main path's shapes and edge shapes, in float32 and float64
  4 float64   the main path: the pinned ODGs 0.171 / -2.007 / -2.007 (stereo
              upmix), and a 10 s stereo pair against the NumPy spec
              (gstpeaq_tpu.utils.numpy_ref, framework-free)
  5 float32   the float32 tier on the same pairs, and the cause of its
              identical-sine ODG: the float32 rDFT's rounding floor
  6 counters  one float32 peaq() call of a 10 s stereo pair goes through
              every kernel
  7 times     CUDA-event medians of each kernel and its plain version, and
              peaq() wall time per 10 s stereo pair per tier
  8 profile   torch.profiler over five peaq() calls per tier: device time
              per call, its share of the wall time, and time by kernel

The line before the last is one JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.  Any
failed check exits non-zero without that last line.  Without CUDA the
script exits non-zero at once and prints no result.  No JAX is imported.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from gstpeaq_tpu_torch import api
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_iir
from gstpeaq_tpu_torch.ops import cuda_spread_fft
from gstpeaq_tpu_torch.ops import fft_ear as FE
from gstpeaq_tpu import constants as C
from gstpeaq_tpu import earparams as EP
from gstpeaq_tpu.utils import numpy_ref
from gstpeaq_tpu.utils import testsignals as TS

MAIN = (2, 2, 109, 468)      # [sig, CH, Z, F] of a 10 s stereo pair
TIERS = ("float64", "float32")
KERNELS = {
    "recurrence_banded": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/recurrence.cu",
        replaces="gstpeaq_tpu/ops/pallas_iir.py:102"),
    "fused_mod_smoothers": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/recurrence.cu",
        replaces="gstpeaq_tpu/ops/pallas_iir.py:180"),
    "spread_fft": dict(
        route="cuda", source="gstpeaq_tpu_torch/csrc/spread_fft.cu",
        replaces="gstpeaq_tpu/ops/pallas_spread_fft.py:106"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def stacked(out) -> torch.Tensor:
    return torch.stack(out) if isinstance(out, tuple) else out


def cuda_ms(fn, calls: int, rounds: int = 10) -> float:
    """Device time of one fn() in ms between CUDA events: the median over
    `rounds` of the mean of `calls` back-to-back calls, after warm-up.
    Each round is queued behind a ~1 ms sleep kernel, so that the host's
    launch overhead is hidden wherever fn() keeps the device busier than
    the host; a host-bound fn() (the plain recurrences' frame loops) is
    timed at its host-bound rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_card() -> str:
    print("phase 1 card", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {card}")
    return card


def phase_build() -> None:
    print("phase 2 build", flush=True)
    path, seconds = _build.build()
    _build.library()
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: {path.name} in "
          f"{seconds:.1f} s")


def kernel_cases(dtype, rng):
    """(kernel, case, cuda fn, plain fn) at main-path and edge shapes;
    each fn returns a tensor or a tuple of tensors."""
    dev = "cuda"
    cases = []
    z = MAIN[2]

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    a = t(np.exp(-rng.uniform(0.01, 0.5, z)))
    for f in (MAIN[3], 37, 1):
        b = t(rng.standard_normal((*MAIN[:3], f)))
        y0 = t(rng.standard_normal(MAIN[:3]))
        cases.append(("recurrence_banded", f"F={f}",
                      lambda a=a, b=b: cuda_iir.recurrence_banded(a, b),
                      lambda a=a, b=b: cuda_iir.recurrence_banded_plain(a, b)))
        cases.append(("recurrence_banded", f"F={f} y0",
                      lambda a=a, b=b, y0=y0:
                      cuda_iir.recurrence_banded(a, b, y0),
                      lambda a=a, b=b, y0=y0:
                      cuda_iir.recurrence_banded_plain(a, b, y0)))
    exc2 = t(rng.uniform(0.01, 10.0, MAIN))
    uns2 = t(rng.uniform(0.01, 10.0, MAIN))
    scale = C.SAMPLING_RATE / C.FFT_STEPSIZE
    cases.append(("fused_mod_smoothers", "main",
                  lambda: cuda_iir.fused_mod_smoothers(a, exc2, uns2, scale),
                  lambda: cuda_iir.fused_mod_smoothers_plain(
                      a, exc2, uns2, scale)))
    for bc in (109, 55):
        k = FE.build_consts(EP.fft_ear_params(bc), dtype, dev)
        p = t(rng.uniform(1e-6, 1e4, (*MAIN[:2], MAIN[3], bc)))
        consts = (k.a_uc, k.g_il, k.lower_matrix, k.spread_norm, k.dz02)
        cases.append(("spread_fft", f"Z={bc}",
                      lambda p=p, c=consts: cuda_spread_fft.spread_fft(p, *c),
                      lambda p=p, c=consts:
                      cuda_spread_fft.spread_fft_plain(p, *c)))
    return cases


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version; returns the main-shape
    float32 numbers per kernel."""
    print("phase 3 kernels against their plain versions", flush=True)
    main = {}
    for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for name, case, kern, plain in kernel_cases(dtype, rng):
            got = stacked(kern())
            torch.cuda.synchronize()
            want = stacked(plain())
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            line = f"  {name} {case} {dtype}: max|d|/max|ref| {rel:.3e}"
            ok = torch.isfinite(got).all().item() and rel < bar
            if name == "spread_fft" and dtype == torch.float32:
                elem = ((got - want).abs() / want.abs()).max().item()
                line += f", elementwise rel {elem:.3e}"
                ok = ok and elem < 1e-4
            print(line, flush=True)
            check(ok, f"{name} {case} {dtype} disagrees with its plain "
                      "version")
            if dtype == torch.float32 and case in ("F=468", "main", "Z=109"):
                main[name] = dict(max_abs_err=err, kernel=kern, plain=plain)
    return main


def ten_second_pair() -> tuple[np.ndarray, np.ndarray]:
    """A 10 s stereo pair from a seed: a 440 Hz sine plus noise below
    16 kHz, and the same plus small white noise.  The content past bin 346
    keeps the bandwidth MOVs' validity gate open."""
    n = 10 * C.SAMPLING_RATE
    rng = np.random.default_rng(0)
    spec = np.fft.rfft(rng.standard_normal((n, 2)), axis=0)
    spec[16000 * n // C.SAMPLING_RATE:] = 0
    noise = np.fft.irfft(spec, n=n, axis=0)
    ref = (0.5 * TS.sine(n, 440)[:, None] + 0.05 * noise).astype(np.float32)
    test = (ref + 0.005 * rng.standard_normal((n, 2))).astype(np.float32)
    return ref, test


def pinned_pairs() -> dict:
    n = 128 * 1024
    sine, saw, tri = TS.sine(n), TS.saw(n), TS.triangle(n)
    return {"sine/sine": (sine, sine), "saw/tri": (saw, tri),
            "saw/tri stereo": (np.stack([saw, saw], 1),
                               np.stack([tri, tri], 1))}


def phase_float64(pair10) -> float:
    print("phase 4 main path, float64", flush=True)
    pinned = {"sine/sine": "0.171", "saw/tri": "-2.007",
              "saw/tri stereo": "-2.007"}
    for label, (ref, test) in pinned_pairs().items():
        odg = api.peaq(ref, test, dtype="float64").odg
        print(f"  {label}: ODG {odg:.6f}")
        check(f"{odg:.3f}" == pinned[label],
              f"float64 {label} ODG {odg:.6f} is not {pinned[label]}")
    got = api.peaq(*pair10, dtype="float64")
    want = numpy_ref.peaq_basic(*pair10)
    print(f"  10 s stereo pair: ODG {got.odg:.9f}, NumPy spec "
          f"{want.odg:.9f}")
    check(abs(got.odg - want.odg) <= 1e-6, "float64 10 s pair ODG")
    for name in C.MOV_BASIC_NAMES:
        w, g = float(want.movs[name]), got.movs[name]
        ok = np.isnan(g) if np.isnan(w) else abs(g - w) <= 1e-6 * (1 + abs(w))
        check(ok, f"float64 10 s pair {name}: {g} against {w}")
    return got.odg


def spectrum_hop_f64(k, blocks):
    """FE._spectrum_hop with the rDFT in float64, rounded to the band
    dtype: with it patched in, the float32 band chain runs on float64
    spectra."""
    frames = torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)
    spec = torch.fft.rfft(frames.double() * k.hann.double(), dim=-1)
    return spec.real.to(k.hann.dtype), spec.imag.to(k.hann.dtype)


def phase_float32(pair10, odg64: float) -> None:
    """The float32 tier: saw/tri within 2e-3 of -2.007 and the 10 s pair
    within 2e-3 of float64.  The identical sine pair misses the 1e-2 bar
    around 0.171: its bandwidth MOVs compare bins against the float32
    rDFT's rounding floor.  The phase shows that on the card (the sine
    pair's bandwidth MOVs and ODG per tier, on the card and on the CPU, and
    the float32 band chain on a float64 rDFT, which must meet the bar) and
    bounds the float32 ODG at 0.05 from 0.171, set from the readings of
    PERF.md section 6."""
    print("phase 5 main path, float32", flush=True)
    pairs = pinned_pairs()
    sine_pair = pairs["sine/sine"]
    readings = {}
    for label, dtype, device in (("float64 card", "float64", "cuda"),
                                 ("float32 card", "float32", "cuda"),
                                 ("float32 cpu", "float32", "cpu")):
        readings[label] = api.peaq(*sine_pair, dtype=dtype, device=device)
    with mock.patch.object(FE, "_spectrum_hop", spectrum_hop_f64):
        readings["float32 on float64 rDFT card"] = api.peaq(
            *sine_pair, dtype="float32")
    for label, res in readings.items():
        others = max(abs(res.movs[n] - readings["float64 card"].movs[n])
                     / (1 + abs(readings["float64 card"].movs[n]))
                     for n in C.MOV_BASIC_NAMES if "Bandwidth" not in n)
        print(f"  sine/sine {label}: ODG {res.odg:.6f}, BandwidthRefB "
              f"{res.movs['BandwidthRefB']:.4f}, BandwidthTestB "
              f"{res.movs['BandwidthTestB']:.4f}, other MOVs within "
              f"{others:.2e} of float64 card")
    bar_f64_rdft = readings["float32 on float64 rDFT card"].odg
    check(abs(bar_f64_rdft - 0.171) <= 1e-2,
          f"float32 band chain on the float64 rDFT: sine/sine {bar_f64_rdft}")
    sine = readings["float32 card"].odg
    check(abs(sine - 0.171) <= 0.05, f"float32 sine/sine ODG {sine}")
    saw = api.peaq(*pairs["saw/tri"], dtype="float32").odg
    ten = api.peaq(*pair10, dtype="float32").odg
    print(f"  float32: saw/tri {saw:.6f}, 10 s pair {ten:.6f} (float64 "
          f"{odg64:.6f})")
    check(abs(saw + 2.007) <= 2e-3, f"float32 saw/tri ODG {saw}")
    check(abs(ten - odg64) <= 2e-3, f"float32 10 s pair ODG {ten}")


def phase_counters(pair10) -> dict:
    print("phase 6 launch counters", flush=True)
    cuda_iir.recurrence_banded_launches = 0
    cuda_iir.fused_mod_smoothers_launches = 0
    cuda_spread_fft.spread_fft_launches = 0
    result = api.peaq(*pair10, dtype="float32")
    counts = {"recurrence_banded": cuda_iir.recurrence_banded_launches,
              "fused_mod_smoothers": cuda_iir.fused_mod_smoothers_launches,
              "spread_fft": cuda_spread_fft.spread_fft_launches}
    print(f"  float32 peaq() of the 10 s pair: ODG {result.odg:.6f}, "
          f"launches {counts}")
    check(np.isfinite(result.odg), "float32 peaq() ODG is not finite")
    for name, least in (("recurrence_banded", 3), ("fused_mod_smoothers", 1),
                        ("spread_fft", 1)):
        check(counts[name] >= least,
              f"{name} launched {counts[name]} times, expected >= {least}")
    return counts


def phase_times(main: dict, pair10, reps: int = 30) -> dict:
    """Kernel and plain device times (cuda_ms), then peaq() host wall time
    per 10 s stereo pair: `reps` calls per tier, the tiers in turn, each
    call ending in the copy of its results to the host.  Returns the
    median wall ms per tier."""
    print("phase 7 times", flush=True)
    for name, entry in main.items():
        entry["ms"] = cuda_ms(entry.pop("kernel"), calls=20)
        entry["plain_ms"] = cuda_ms(entry.pop("plain"), calls=1)
        print(f"  {name}: kernel {entry['ms']:.4f} ms, plain "
              f"{entry['plain_ms']:.4f} ms (median of 10)")
    walls = {tier: [] for tier in TIERS}
    for tier in TIERS:
        api.peaq(*pair10, dtype=tier)                 # warm
    for _ in range(reps):
        for tier in TIERS:
            start = time.perf_counter()
            api.peaq(*pair10, dtype=tier)
            walls[tier].append((time.perf_counter() - start) * 1e3)
    medians = {}
    for tier in TIERS:
        q1, medians[tier], q3 = statistics.quantiles(walls[tier], n=4)
        print(f"  peaq() 10 s stereo pair, {tier}: median "
              f"{medians[tier]:.3f} ms (quartiles {q1:.3f}..{q3:.3f}, "
              f"{reps} calls), {1e4 / medians[tier]:.1f}x realtime")
    return medians


def phase_profile(pair10, walls: dict, calls: int = 5) -> None:
    """Device time per peaq() call under torch.profiler, per tier: the sum
    of the device's own rows (kernels and copies; the CPU op rows repeat
    the time of the kernels they launch), its share of the unprofiled
    median wall time of phase 7, and the hand kernels' part of it."""
    print("phase 8 profile", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tier in TIERS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                api.peaq(*pair10, dtype=tier)
        events = prof.key_averages()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in device) / 1e3
        hand_ms = sum(e.self_device_time_total for e in device
                      if any(f"{name}_kernel" in e.key for name in KERNELS)
                      ) / 1e3
        check(device_ms > 0, "the profiler saw no device time")
        print(f"  {tier}, {calls} calls: device {device_ms / calls:.4f} ms "
              f"per call ({len(device)} kinds), busy "
              f"{device_ms / calls / walls[tier]:.2%} of the unprofiled "
              f"median {walls[tier]:.3f} ms; hand kernels "
              f"{hand_ms / calls:.4f} ms per call "
              f"({hand_ms / device_ms:.2%} of the device time)")
        print(events.table(sort_by="self_device_time_total", row_limit=12))


def main() -> None:
    card = phase_card()
    phase_build()
    rng = np.random.default_rng(1)
    main_kernels = phase_kernels(rng)
    pair10 = ten_second_pair()
    odg64 = phase_float64(pair10)
    phase_float32(pair10, odg64)
    counts = phase_counters(pair10)
    walls = phase_times(main_kernels, pair10)
    phase_profile(pair10, walls)
    check("jax" not in sys.modules, "JAX was imported")
    kernels = [dict(name=name, **KERNELS[name], launches=counts[name],
                    max_abs_err=main_kernels[name]["max_abs_err"],
                    ms=main_kernels[name]["ms"],
                    plain_ms=main_kernels[name]["plain_ms"])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
