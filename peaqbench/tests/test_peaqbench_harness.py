"""A run of the harness on the CPU at a small size, with the device check
skipped: correct when the timed path is sound, not correct when it is
broken underneath; data files added alone are picked up; run.py refuses to
run without CUDA."""

import json
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from peaqbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = {"item_seconds": 1.0, "microbatch": 2, "pool_microbatches": 2,
         "trace_seconds": 0.5}
SEED = 2**31 + 777


def run(name, trace=False, fault=None, bench=None, seconds=1.0, **kw):
    return harness.run_cell(bench or harness.Bench(ROOT), name, SEED,
                            seconds, trace, "cpu", fault=fault,
                            overrides=dict(SMALL, **kw))


@pytest.mark.parametrize("name", ["basic.sweep", "advanced.sweep"])
def test_sound_run_is_correct(name):
    result, checks = run(name)
    assert result["correct"], checks
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"sweep_rate", "setup_s"}
    assert result["failed"] == 0
    assert result["attempted"] == SMALL["microbatch"] * result["run"][
        "dispatched"] >= SMALL["microbatch"]
    assert all(m["value"] > 0 for m in result["metrics"].values())


def alter(out):
    """An answer altered where it is produced: every ODG moved by 1e-3."""
    out = out.clone()
    out[:, 0] += 1e-3
    return out


def half(out):
    """Half of the microbatch left out: its second half's answers are the
    first half's."""
    out = out.clone()
    h = out.shape[0] // 2
    out[h:] = out[:h]
    return out


class Stale:
    """A unit that returns its state unchanged: each microbatch answers
    with the results of the one dispatched before it."""

    def __init__(self):
        self.last = None

    def __call__(self, out):
        last, self.last = self.last, out.clone()
        return out if last is None else last


@pytest.mark.parametrize("fault", [alter, half, Stale],
                         ids=["alter", "half", "stale"])
def test_broken_timed_path_is_not_correct(fault):
    fault = fault() if isinstance(fault, type) else fault
    result, checks = run("basic.sweep", fault=fault)
    assert not result["correct"], (checks, result["run"])
    assert dict((n, ok) for n, _, _, ok in checks)["gap"] is False


# A second traffic mix with an entry and a loop of its own: one pair a
# call through the port's `api.peaq`, from host arrays, one call at a time.
PAIR_ENTRY = """
import contextlib
import numpy as np
import torch
from peaqbench import items
from peaqbench.client import Handle


class System:
    def __init__(self, cfg, traffic, seed, device, tier, fault):
        from gstpeaq_tpu_torch import api, constants as PC
        self.api, self.cfg, self.tier, self.device = api, cfg, tier, device
        self.settings = PC.Settings(**cfg["settings"])
        self.seconds = traffic["item_seconds"]
        self.sig, _ = items.make(traffic["classes"], traffic["pool_items"],
                                 self.seconds, seed, "cpu")
        self.work = {}

    def context(self):
        return contextlib.nullcontext()

    def warm(self):
        self.submit(0)

    def submit(self, m):
        k = m % self.sig.shape[1]
        r = self.api.peaq(self.sig[0, k].T.numpy(), self.sig[1, k].T.numpy(),
                          self.cfg["version"] == "advanced",
                          self.cfg["playback_level_db_spl"], self.settings,
                          self.tier, device=self.device)
        values = [r.odg, r.di] + [r.movs[n] for n in self.cfg["movs"]]
        host = torch.tensor([values], dtype=torch.float64)
        return Handle(m, np.array([k]), self.seconds, None, host)

    def sample(self, rng, handles):
        return np.unique([h.items[0] for h in handles])[:2]

    def pairs(self, ids):
        where = torch.as_tensor(ids)
        return [(np.asarray(ids), self.sig[0, where], self.sig[1, where])]

    def release(self):
        del self.sig


def build(cfg, traffic, seed, device, tier, fault=None):
    return System(cfg, traffic, seed, device, tier, fault)
"""

SERIAL_LOOP = """
import time
from peaqbench.client import Window


def run(submit, seconds, traffic):
    handles, enqueue = [], 0.0
    start = time.perf_counter()
    while time.perf_counter() < start + seconds or not handles:
        t = time.perf_counter()
        h = submit(len(handles))
        enqueue += time.perf_counter() - t
        h.finish(time.perf_counter())
        handles.append(h)
    close = time.perf_counter()
    return Window(start, close, handles, list(handles), enqueue)
"""


def test_files_added_alone_are_picked_up(tmp_path):
    """A configuration, a cell, a per-layer metric, and a traffic mix with
    an entry and a loop of its own, added as files (and entries in
    BENCHMARK.json) are run and read with no file of the benchmark
    changed."""
    shutil.copytree(ROOT / "peaqbench", tmp_path / "peaqbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "peaqbench").rglob("*")
              if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "peaqbench/configs/basic.json").read_text())
    cfg["name"] = "basic_85db"
    cfg["playback_level_db_spl"] = 85.0
    (tmp_path / "peaqbench/configs/basic_85db.json").write_text(
        json.dumps(cfg))
    spec["configs"].append({"name": "basic_85db", "source": "test",
                            "file": "peaqbench/configs/basic_85db.json",
                            "reduced": [], "why": "test"})
    traffic = json.loads((ROOT / "peaqbench/traffic/sweep.json").read_text())
    traffic.update(entry="pair", loop="serial", pool_items=3)
    (tmp_path / "peaqbench/traffic/pair.json").write_text(json.dumps(traffic))
    (tmp_path / "peaqbench/entries/pair.py").write_text(PAIR_ENTRY)
    (tmp_path / "peaqbench/loops/serial.py").write_text(SERIAL_LOOP)
    spec["workloads"] += [
        {"name": "basic_85db.sweep", "config": "basic_85db",
         "traffic": "sweep", "chips": 1, "why": "test"},
        {"name": "basic_85db.pair", "config": "basic_85db",
         "traffic": "pair", "chips": 1, "why": "test"}]
    (tmp_path / "peaqbench/metrics/dispatched.any.py").write_text(
        "def read(run):\n    return len(run.window.handles)\n")
    spec["per_layer"].append({"name": "dispatched.any", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "batch", "moves": "sweep_rate",
                              "workloads": ["basic_85db.sweep",
                                            "basic_85db.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == b for p, b in before.items())
    bench = harness.Bench(tmp_path)
    for name in ("basic_85db.sweep", "basic_85db.pair"):
        result, checks = run(name, trace=True, bench=bench)
        assert result["correct"], (name, checks)
        # the new cells report the metrics that list them, and only those
        assert set(result["metrics"]) == {"dispatched.any"}
        assert result["metrics"]["dispatched.any"]["value"] >= 1
    result, checks = run("basic_85db.pair", bench=bench)
    assert result["correct"] and result["metrics"]["sweep_rate"]["value"] > 0
    assert result["run"]["compared_items"] == 2


def test_sample_holds_every_row_of_the_microbatch():
    """The compared sample: one item of each microbatch row, from a
    dispatched microbatch drawn from the seed, every one answered."""
    result, checks = run("basic.sweep", microbatch=4, pool_microbatches=3)
    assert result["correct"], checks
    assert result["run"]["compared_items"] == 4
    assert dict((n, v) for n, v, _, _ in checks)["unanswered"] == 0
    batch = harness.Bench(ROOT).module("entries", "batch")
    handles = [types.SimpleNamespace(items=k * 4 + np.arange(4))
               for k in (0, 2, 1, 0, 2)]
    seen = set()
    for seed in range(8):
        fake = types.SimpleNamespace(b=4, stride=1)
        ids = batch.System.sample(fake, np.random.default_rng(seed), handles)
        assert sorted(ids % 4) == [0, 1, 2, 3] and ids.max() < 12
        seen |= set(ids.tolist())
        # one row of every run of `stride`
        fake = types.SimpleNamespace(b=4, stride=2)
        ids = batch.System.sample(fake, np.random.default_rng(seed), handles)
        assert [r // 2 for r in ids % 4] == [0, 1]
    assert len(seen) > 4


def test_run_py_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "peaqbench/run.py"), "--workload",
         "basic.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
