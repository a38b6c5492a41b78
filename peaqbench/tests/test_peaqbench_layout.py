"""BENCHMARK.json against the contract's shapes, the files it names, the
kernel table against the port's sources, and what the benchmark imports."""

import ast
import json
import pathlib
import re
import sys
import types

import pytest

from peaqbench import harness, tracing

ROOT = pathlib.Path(__file__).resolve().parents[2]
PKG = ROOT / "peaqbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "gstpeaq_tpu"}


def line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(line(w) for w in SPEC["command"])
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert (ROOT / SPEC["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    everything = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
                  + SPEC["per_layer"])
    names = [e["name"] for e in everything]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in SPEC[group]]
        assert len(set(group_names)) == len(group_names)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["why"]) and line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"])


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] \
                or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    bench = harness.Bench(ROOT)
    for name in cells:
        cell = bench.cells[name]
        reported = [m["name"] for m in bench.end_to_end(cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(cell)


def test_named_files_exist():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(PKG)
        assert json.loads(path.read_text())["name"] == c["name"]
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    for w in SPEC["workloads"]:
        traffic = json.loads(
            (PKG / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PKG / "entries" / f"{traffic['entry']}.py").is_file()
        assert (PKG / "loops" / f"{traffic['loop']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
    for path in PKG.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


KERNEL = re.compile(r"__global__.*?(\w+_kernel)\s*\(", re.S)
TOOLS_ONLY = {"mma_rate_kernel", "math_rate_kernel"}


def test_every_cuda_source_has_a_kernel_table_file():
    sources = {json.loads(p.read_text())["source"]
               for p in (PKG / "kernels").glob("*.json")}
    for cu in (ROOT / "gstpeaq_tpu_torch" / "csrc").glob("*.cu"):
        assert f"gstpeaq_tpu_torch/csrc/{cu.name}" in sources, cu.name


def test_every_main_path_kernel_has_one_rule():
    rules = tracing.kernel_table(PKG / "kernels")
    for cu in (ROOT / "gstpeaq_tpu_torch" / "csrc").glob("*.cu"):
        for name in set(KERNEL.findall(cu.read_text())) - TOOLS_ONLY:
            # as the profiler names a template instance
            shown = f"void {name}<double>(long long, double*)"
            hits = [r.name for r in rules if r.pattern.search(shown)]
            assert len(hits) == 1, (name, hits)
    for name in ("void at::native::vectorized_elementwise_kernel<4>()",
                 "Memcpy DtoH (Device -> Pinned)"):
        assert tracing.layer_of(name, rules) == tracing.EAGER


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert tops <= {"__future__", "dataclasses", "functools", "math",
                        "numpy", "scipy", "torch"}, (path, tops)


def test_loaded_modules_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gstpeaq_tpu_torch_probe",
                        types.ModuleType("gstpeaq_tpu_torch_probe"))
    monkeypatch.setitem(sys.modules, "jaxline", types.ModuleType("jaxline"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
