"""The A/B runner that the port's tools/*_ab.py share
(gstpeaq_tpu_torch/tools/ab.py), on the CPU: its children run from each
root in the order parent, this, this, parent, with the tool's arguments; a
child that fails ends the tool with its code; the table prints every case
of either side and gives the worst ratio of this checkout's faster time
to the parent's.  Each A/B tool's comparison, fed four runs in place of
the card's, prints its table and exits as its checks say."""

import json
import pathlib
import sys

import pytest

from gstpeaq_tpu_torch.tools import ab
from gstpeaq_tpu_torch.tools import band_ab
from gstpeaq_tpu_torch.tools import batch_ab
from gstpeaq_tpu_torch.tools import ehs_ab
from gstpeaq_tpu_torch.tools import fir_ab
from gstpeaq_tpu_torch.tools import gate_ab

ROOT = pathlib.Path(__file__).resolve().parents[1]
# a child: where it ran and with what, as the last line of its output
CHILD = """import json, os, sys
print("warming up")
print(json.dumps({"cwd": os.getcwd(), "argv": sys.argv[1:]}))
"""


def test_runs_in_order_from_each_root(tmp_path):
    tool = tmp_path / "tool.py"
    tool.write_text(CHILD)
    parent = tmp_path / "parent"
    parent.mkdir()
    got = ab.runs(str(tool), str(parent), "--program", "p.npz")
    assert ab.ROOT == ROOT
    roots = [str(parent), str(ROOT), str(ROOT), str(parent)]
    assert [pathlib.Path(r["cwd"]).resolve() for r in got] == [
        pathlib.Path(r).resolve() for r in roots]
    assert [r["argv"] for r in got] == [
        ["--program", "p.npz", "--child", r] for r in roots]


def test_a_failing_child_ends_the_tool(tmp_path, capsys):
    tool = tmp_path / "tool.py"
    tool.write_text("import sys\nprint('no card')\nsys.exit(3)\n")
    with pytest.raises(SystemExit) as done:
        ab.runs(str(tool), str(tmp_path))
    assert done.value.code == 3
    assert "no card" in capsys.readouterr().err


def readings(parent: float, this: float, only: str = "") -> dict:
    """A run's {dtype: {case: reading}}: case "a" at `this` ms, case "b"
    at twice that, and `only` beside them where given."""
    cases = {"a": {"ms": this}, "b": {"ms": 2 * this}}
    if only:
        cases[only] = {"ms": parent}
    return {dtype: dict(cases) for dtype in ab.DTYPES}


def test_table_prints_every_case_and_the_worst_ratio(capsys):
    runs = [readings(1.0, 1.0, "old"), readings(1.0, 0.5),
            readings(1.0, 0.6), readings(1.0, 0.8, "old")]
    worst = ab.table(runs, lambda t: f"{t['ms']:.2f}")
    assert worst == pytest.approx(0.5 / 0.8)
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"  {dtype} {case}: {cells}" for dtype in ab.DTYPES
                     for case, cells in (
                         ("a", "1.00 / 0.50 / 0.60 / 0.80"),
                         ("b", "2.00 / 1.00 / 1.20 / 1.60"),
                         ("old", "1.00 / - / - / 1.00"))]


def fake(monkeypatch, runs) -> None:
    """The card and four runs in place of the children's."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(ab, "card", lambda: "H100, 700.00 W")
    monkeypatch.setattr(ab, "runs", lambda tool, parent, *args, **kw: runs)


def kernel_runs(key: str, held: bool) -> list:
    """Four runs of a kernel's A/B child: ms, bound and a check each."""
    one = {"ms": 0.5, "bound_ms": 0.25, key: True}
    bad = dict(one, **{key: held})
    return [{d: {"batch": one} for d in ab.DTYPES},
            {d: {"batch": bad} for d in ab.DTYPES},
            {d: {"batch": one} for d in ab.DTYPES},
            {d: {"batch": one} for d in ab.DTYPES}]


@pytest.mark.parametrize("held", [True, False])
@pytest.mark.parametrize("tool,key,flag", [(ehs_ab, "ok", "FAILS"),
                                           (gate_ab, "equal", "BITS DIFFER")])
def test_kernel_tools_compare_and_check(monkeypatch, capsys, tool, key,
                                        flag, held):
    fake(monkeypatch, kernel_runs(key, held))
    assert tool.main(["--parent", "elsewhere"]) == (0 if held else 1)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "H100, 700.00 W"
    assert ("  float64 batch: 0.5000 (50.0%) / 0.5000 (50.0%)"
            + ("" if held else f" {flag}") + " / 0.5000 (50.0%) / "
            "0.5000 (50.0%)") in out
    assert any(line.startswith("worst this / parent") and "1.000" in line
               for line in out)
    assert json.loads(out[-1])["card"] == "H100, 700.00 W"


def test_band_and_fir_tools_print_their_tables(monkeypatch, capsys):
    fake(monkeypatch, kernel_runs("ok", True))
    assert band_ab.main(["--parent", "elsewhere"]) == 0
    assert "  float32 batch: " + " / ".join(["0.5000 (50.0%)"] * 4) in (
        capsys.readouterr().out.splitlines())
    fake(monkeypatch, [{d: {"pair": t} for d in ab.DTYPES}
                       for t in (0.2, 0.1, 0.1, 0.2)])
    assert fir_ab.main(["--parent", "elsewhere"]) == 0
    assert "  float64 pair: 0.2000 / 0.1000 / 0.1000 / 0.2000" in (
        capsys.readouterr().out.splitlines())


def test_batch_tool_prints_the_runs(monkeypatch, capsys):
    runs = [{"root": str(i)} for i in range(4)]
    fake(monkeypatch, runs)
    assert batch_ab.main(["--parent", "elsewhere"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == "H100, 700.00 W"
    assert json.loads(out[-1]) == {"card": "H100, 700.00 W", "runs": runs}
