"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry, loop,
kernel or per-layer metric is a file of its own, found by the name that
BENCHMARK.json or the traffic file gives: `file` of each configuration,
`traffic/<traffic>.json`, `entries/<entry>.py` and `loops/<loop>.py` as
the traffic file names them, `kernels/*.json`, `metrics/<metric>.py`.  The
entry builds the system under test and dispatches its work; the loop
drives it for the window; this module times, compares and reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import time

import numpy as np
import torch

from . import tracing
from .client import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "gstpeaq_tpu")


class Bench:
    """BENCHMARK.json at `root` and the files it names, read by name."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.dir = self.root / self.spec["paths"][0]

    def config(self, cell: dict) -> dict:
        return json.loads(
            (self.root / self.configs[cell["config"]]["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads(
            (self.dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def per_layer(self, cell: dict) -> list:
        """The per-layer metrics this cell reports."""
        return [m for m in self.spec["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def end_to_end(self, cell: dict) -> list:
        return [m for m in self.spec["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def module(self, kind: str, name: str):
        """`<kind>/<name>.py` under the benchmark's folder, loaded."""
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"peaqbench_{kind}_" + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, name: str):
        return self.module("metrics", name).read

    def entry(self, name: str):
        return self.module("entries", name).build

    def loop(self, name: str):
        return self.module("loops", name).run

    def kernels(self) -> list:
        return tracing.kernel_table(self.dir / "kernels")


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""
    config: dict
    traffic: dict
    window: Window
    window_peak_bytes: int | None
    trace: tracing.Trace | None
    work: dict


def forbidden_modules() -> list:
    """Modules of JAX, Flax or the JAX package loaded in this process,
    by whole top-level names."""
    import sys
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str | None:
    """nvidia-smi's name and power limit of card 0, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", tier: str | None = None,
             fault=None, overrides: dict | None = None,
             t_start: float | None = None,
             build_s: float = 0.0) -> tuple[dict, list]:
    """One run of cell `name`.  Returns (result line, compared numbers as
    (name, value, limit, passes)).  `tier` replaces the configuration's
    precision (the control), `fault` breaks the timed path's answers
    (fault(out) -> out; the tests), `overrides` replaces configuration or
    traffic keys (the tests' small sizes), `build_s` is the part of the
    set-up that built the program's kernels (0 once they are built)."""
    from .reference import torch_ref
    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cells[name]
    cfg, traffic = bench.config(cell), bench.traffic(cell)
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = value
    device = torch.device(device)
    cuda = device.type == "cuda"
    tier = tier or cfg["precision"]
    loop = bench.loop(traffic["loop"])

    system = bench.entry(traffic["entry"])(cfg, traffic, seed, device, tier,
                                           fault)
    with system.context():
        system.warm()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        window = loop(system.submit, seconds, traffic)
        if cuda:
            torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated() if cuda else None

        traced = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                tw = loop(system.submit, traffic["trace_seconds"], traffic)
                if cuda:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
            traced = tracing.reduce(prof, bench.kernels(), len(tw.handles),
                                    t1 - t0)
            del prof
        # the run's peak: set-up's, or the windows' since the reset
        memory_peak = max(setup_peak, torch.cuda.max_memory_allocated()
                          if cuda else 0)

    handles = window.handles + (tw.handles if trace else [])
    # the compared sample, drawn by the entry from the seed among the
    # dispatched items; every answer the windows gave for them is compared
    sample = system.sample(np.random.default_rng([seed, 0xC0DE]), handles)
    groups = system.pairs(sample)
    work = system.work
    system.release()
    del system
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = {}
    for ids, ref_sig, test_sig in groups:
        out = torch_ref.peaq(ref_sig, test_sig, cfg["version"] == "advanced",
                             cfg["playback_level_db_spl"],
                             block=cfg["reference_block"]).cpu().numpy()
        expected.update(zip(ids.tolist(), out))
    del groups
    ref_s = time.perf_counter() - t_ref
    gap, answered = 0.0, set()
    for h in handles:
        if h.values is None:
            continue
        for row, item in enumerate(h.items.tolist()):
            r = expected.get(item)
            if r is None:
                continue
            answered.add(item)
            g = np.abs(h.values[row] - r) / (1.0 + np.abs(r))
            gap = max(gap, float(np.max(np.where(np.isfinite(g), g,
                                                 np.inf))))
    missing = [h for h in handles if h.values is None]
    limits = cfg["correct"]
    checks = [("gap", gap, limits["gap"],
               limits["gap"] is not None and gap <= limits["gap"]),
              ("missing", len(missing), limits["missing"],
               len(missing) <= limits["missing"]),
              ("unanswered", len(expected) - len(answered), 0,
               len(answered) == len(expected))]
    correct = bool(answered) and all(ok for *_, ok in checks)

    run = Run(cfg, traffic, window, window_peak, traced, work)
    metrics = {}
    if trace:
        for m in bench.per_layer(cell):
            value = bench.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        audio = sum(h.audio_s for h in window.in_window)
        window_s = window.close - window.start
        values = {"sweep_rate": audio / window_s, "setup_s": setup_s}
        for m in bench.end_to_end(cell):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": sum(len(h.items) for h in handles),
        "failed": sum(len(h.items) for h in missing),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)},
        "run": {"seed": seed, "tier": tier, "dispatched": len(handles),
                "in_window": len(window.in_window),
                "window_s": window.close - window.start,
                "setup_s": setup_s, "build_s": build_s,
                "reference_s": ref_s, "compared_items": len(sample),
                "power_limit": power_limit() if cuda else None},
    }
    if trace:
        result["device"]["busy_s"] = traced.busy_s()
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in checks}
    return result, checks
