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
from gstpeaq_tpu_torch.tools import spectral_ab

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


def kernel_runs(key: str, held: bool, **reading) -> list:
    """Four runs of a kernel's A/B child: ms, bound and a check each, and
    `reading`'s keys."""
    one = {"ms": 0.5, "bound_ms": 0.25, key: True, **reading}
    bad = dict(one, **{key: held})
    return [{d: {"batch": one} for d in ab.DTYPES},
            {d: {"batch": bad} for d in ab.DTYPES},
            {d: {"batch": one} for d in ab.DTYPES},
            {d: {"batch": one} for d in ab.DTYPES}]


# spectral_ab's child reports S2's traffic, and the tool counts its bound
# over the bins the call reads: 0.25 ms here at 769 bins
SPECTRAL = {"bytes_a_bin": 1e9, "rest": 0.25e-3 * 3.35e12 - 769e9,
            "hi": 769, "bandwidth": False}


@pytest.mark.parametrize("held", [True, False])
@pytest.mark.parametrize("tool,key,flag", [(ehs_ab, "ok", "FAILS"),
                                           (gate_ab, "equal", "BITS DIFFER"),
                                           (spectral_ab, "ok", "FAILS")])
def test_kernel_tools_compare_and_check(monkeypatch, capsys, tool, key,
                                        flag, held):
    fake(monkeypatch, kernel_runs(key, held, **(
        SPECTRAL if tool is spectral_ab else {})))
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


@pytest.mark.parametrize("argv", [[], ["--parent"]])
def test_spectral_tool_wants_parent_or_split(argv, capsys):
    """spectral_ab.py without --parent DIR or --split stops with argparse's
    usage error (code 2), before any card is touched."""
    with pytest.raises(SystemExit) as done:
        spectral_ab.main(argv)
    assert done.value.code == 2
    assert "usage" in capsys.readouterr().err


def test_spectral_tool_counts():
    """spectral_ab.py's counts: the bound over the bins a call reads
    (cuda_spectral.bins_read) and over all 1,025, the library calls a row,
    and the resident blocks an SM from a build's registers and shared
    memory."""
    import chip_smoke as S
    reading = dict(SPECTRAL, bandwidth=True)
    rate = S.MEMORY_BYTES_PER_S
    assert spectral_ab.bound_ms(reading, rate) == pytest.approx(
        (1024e9 + reading["rest"]) / rate * 1e3)
    assert spectral_ab.bound_ms(dict(reading, bandwidth=False), rate) == \
        pytest.approx(0.25)
    assert spectral_ab.bound_ms(reading, rate, 1025) == pytest.approx(
        (1025e9 + reading["rest"]) / rate * 1e3)
    assert spectral_ab.row_calls(769) == {
        "sqrt": 2 * 769, "div": 769 + 512, "log1p": 512}
    # 64 registers and 99 KB: two blocks of 512 threads; 40 registers and
    # 25 KB static: six blocks of 256 (registers); 255: one of 256
    assert spectral_ab.occupancy(64, 0, 99104, 512) == 2
    assert spectral_ab.occupancy(40, 24652, 0, 256) == 6
    assert spectral_ab.occupancy(255, 0, 0, 256) == 1


def test_spectral_tool_variants_rewrite_one_line(tmp_path):
    """--sweep's variants: each a copy of csrc/ whose spectral.cu has its
    one line rewritten, the shipped source untouched."""
    from gstpeaq_tpu_torch.ops import _build
    shipped = (_build.CSRC / "spectral.cu").read_text()
    for name, (old, new) in spectral_ab.VARIANTS.items():
        assert shipped.count(old) == 1
        copy = spectral_ab.variant_sources(name, _build.CSRC, tmp_path)
        assert copy == tmp_path / f"spectral_{name}" / "csrc"
        assert (copy / "spectral.cu").read_text() == shipped.replace(old,
                                                                     new)
        assert sorted(f.name for f in copy.iterdir()) == sorted(
            f.name for f in _build.CSRC.iterdir())
    assert (_build.CSRC / "spectral.cu").read_text() == shipped
