"""BS.1387 conformance harness, on the card (gstpeaq_tpu/conformance.py;
the tables are the port's own copies of that module's).

Mirrors the reference's checkconformanceresults.sh: for each of the 16 ITU
test items in $CONFORMANCEDATADIR ({item}ref.wav vs {item}.wav), compute the
DI and compare against (a) the ITU reference values and (b) the C
implementation's own blessed outputs (doc/conformance_{basic,advanced}_table.xml
— the regression targets; matching those to 1e-3 is the parity gate).

The expected tables below are data extracted from the reference's published
conformance tables (doc/conformance_basic_table.xml:14-66,
doc/conformance_advanced_table.xml:14-66).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# item -> (ITU reference DI, gstpeaq blessed DI)
CONFORMANCE_BASIC = {
    "acodsna": (1.304, 1.297), "bcodtri": (1.949, 1.973),
    "ccodsax": (0.048, 0.074), "ecodsmg": (1.731, 1.811),
    "fcodsb1": (0.677, 0.700), "fcodtr1": (1.419, 1.468),
    "fcodtr2": (-0.045, 0.085), "fcodtr3": (-0.715, -0.564),
    "gcodcla": (1.781, 1.798), "icodsna": (-3.029, -2.961),
    "kcodsme": (3.093, 3.133), "lcodhrp": (1.041, 1.095),
    "lcodpip": (1.973, 2.735), "mcodcla": (-0.436, -0.378),
    "ncodsfe": (3.135, 3.101), "scodclv": (1.689, 1.723),
}

CONFORMANCE_ADVANCED = {
    "acodsna": (1.632, 1.600), "bcodtri": (2.000, 1.978),
    "ccodsax": (0.567, 0.474), "ecodsmg": (1.594, 1.592),
    "fcodsb1": (1.039, 0.819), "fcodtr1": (1.555, 1.506),
    "fcodtr2": (0.162, 0.061), "fcodtr3": (-0.783, -0.282),
    "gcodcla": (1.457, 1.369), "icodsna": (-2.510, -2.430),
    "kcodsme": (2.765, 2.797), "lcodhrp": (1.538, 1.331),
    "lcodpip": (2.149, 2.089), "mcodcla": (0.430, -0.148),
    "ncodsfe": (3.163, 3.125), "scodclv": (1.972, 2.104),
}


# item -> ITU reference ODG (doc/make_conformance_tables.sh:62-77,107-122)
ITU_ODG_BASIC = {
    "acodsna": -0.676, "bcodtri": -0.304, "ccodsax": -1.829,
    "ecodsmg": -0.412, "fcodsb1": -1.195, "fcodtr1": -0.598,
    "fcodtr2": -1.927, "fcodtr3": -2.601, "gcodcla": -0.386,
    "icodsna": -3.786, "kcodsme": 0.038, "lcodhrp": -0.876,
    "lcodpip": -0.293, "mcodcla": -2.331, "ncodsfe": 0.045,
    "scodclv": -0.435,
}

ITU_ODG_ADVANCED = {
    "acodsna": -0.467, "bcodtri": -0.281, "ccodsax": -1.300,
    "ecodsmg": -0.489, "fcodsb1": -0.877, "fcodtr1": -0.512,
    "fcodtr2": -1.711, "fcodtr3": -2.662, "gcodcla": -0.573,
    "icodsna": -3.664, "kcodsme": -0.029, "lcodhrp": -0.523,
    "lcodpip": -0.219, "mcodcla": -1.435, "ncodsfe": 0.050,
    "scodclv": -0.293,
}


@dataclasses.dataclass
class ConformanceRow:
    item: str
    di: float
    odg: float
    itu_di: float
    blessed_di: float
    itu_odg: float = float("nan")

    @property
    def delta_itu(self) -> float:
        return self.di - self.itu_di

    @property
    def delta_blessed(self) -> float:
        return self.di - self.blessed_di


def data_dir() -> str | None:
    d = os.environ.get("CONFORMANCEDATADIR")
    if d and os.path.isdir(d):
        return d
    return None


def run(advanced: bool = False, dtype: str | None = None,
        directory: str | None = None, settings=None,
        device=None) -> list[ConformanceRow]:
    """Run all 16 items on `device` (None: CUDA, which must be present);
    raises FileNotFoundError if the dataset is absent."""
    from . import api
    from . import constants as C
    from .utils import native

    d = directory or data_dir()
    if d is None:
        raise FileNotFoundError(
            "CONFORMANCEDATADIR not set or missing (the BS.1387 dataset is "
            "proprietary and not distributed with this repository)")
    settings = settings or C.DEFAULT_SETTINGS
    table = CONFORMANCE_ADVANCED if advanced else CONFORMANCE_BASIC
    odg_table = ITU_ODG_ADVANCED if advanced else ITU_ODG_BASIC
    rows = []
    for item, (itu_di, blessed_di) in table.items():
        ref = native.load_audio_48k(os.path.join(
            d, item.replace("cod", "ref") + ".wav"))
        test = native.load_audio_48k(os.path.join(d, item + ".wav"))
        res = api.peaq(ref, test, advanced=advanced, dtype=dtype,
                       settings=settings, device=device)
        rows.append(ConformanceRow(item=item, di=res.di, odg=res.odg,
                                   itu_di=itu_di, blessed_di=blessed_di,
                                   itu_odg=odg_table[item]))
    return rows


def report(rows: list[ConformanceRow]) -> str:
    lines = [f"{'item':8s} {'DI':>8s} {'blessed':>8s} {'dBlessed':>9s} "
             f"{'ITU':>8s} {'dITU':>8s}"]
    for r in rows:
        lines.append(f"{r.item:8s} {r.di:8.3f} {r.blessed_di:8.3f} "
                     f"{r.delta_blessed:9.4f} {r.itu_di:8.3f} "
                     f"{r.delta_itu:8.3f}")
    d_blessed = np.array([r.delta_blessed for r in rows])
    d_itu = np.array([r.delta_itu for r in rows])
    lines.append(f"max |dBlessed| = {np.abs(d_blessed).max():.4f}   "
                 f"RMSE vs ITU = {np.sqrt((d_itu ** 2).mean()):.4f}")
    return "\n".join(lines)


def stats(rows: list[ConformanceRow]) -> str:
    """ODG/DI bias and MSE vs the ITU targets, like the tail of
    doc/make_conformance_tables.sh:80-84."""
    d_odg = np.array([r.odg - r.itu_odg for r in rows])
    d_di = np.array([r.delta_itu for r in rows])
    return (f"ODG mean error (bias): {d_odg.mean():.3f}\n"
            f"ODG mean square error: {(d_odg ** 2).mean():.6f}\n"
            f"DI mean error (bias): {d_di.mean():.3f}\n"
            f"DI mean square error: {(d_di ** 2).mean():.6f}")


def xml_table(rows: list[ConformanceRow], advanced: bool) -> str:
    """Regenerate the DocBook conformance table, format-compatible with the
    reference's doc/conformance_{basic,advanced}_table.xml (emitted by
    doc/make_conformance_tables.sh:27-54,86-104)."""
    mode = "advanced" if advanced else "basic"
    head = (
        f'<table frame="none" id="conformance_{mode}_table">\n'
        f"\t<title>Conformance test results for the {mode} version."
        "</title>\n"
        "\t<tgroup cols='4' align='right' colsep='1' rowsep='1'>\n"
        "\t\t<colspec align='left' />\n"
        "\t\t<thead>\n\t\t\t<row>\n"
        "\t\t\t\t<entry>Item</entry>\n"
        "\t\t\t\t<entry>Reference DI</entry>\n"
        "\t\t\t\t<entry>Actual DI</entry>\n"
        "\t\t\t\t<entry>Difference</entry>\n"
        "\t\t\t</row>\n\t\t</thead>\n\t\t<tbody>")
    body = []
    for r in rows:
        body.append(
            "\t\t\t<row>\n"
            f"\t\t\t\t<entry>{r.item}</entry>\n"
            f"\t\t\t\t<entry>{r.itu_di:.3f}</entry>\n"
            f"\t\t\t\t<entry>{r.di:.3f}</entry>\n"
            f"\t\t\t\t<entry>{r.di - r.itu_di:.3f}</entry>\n"
            "\t\t\t</row>")
    tail = "\t\t</tbody>\n\t</tgroup>\n</table>"
    return "\n".join([head, *body, tail])


def main(argv=None) -> int:
    """The checkconformanceresults.sh equivalent: 77 without the dataset,
    else 0 when every item's DI is within 1e-3 of the blessed one.  The
    device is CUDA unless GSTPEAQ_PLATFORM names another (`cpu`)."""
    import argparse
    p = argparse.ArgumentParser(description="BS.1387 conformance check")
    p.add_argument("--advanced", action="store_true")
    p.add_argument("--precision", default=None)
    p.add_argument("--emit-tables", metavar="DIR", default=None,
                   help="regenerate conformance_{basic,advanced}_table.xml "
                   "into DIR and print ODG/DI bias + MSE (the "
                   "make_conformance_tables.sh equivalent)")
    args = p.parse_args(argv)
    if data_dir() is None:
        print("CONFORMANCEDATADIR not set, conformance test NOT run.")
        return 77
    device = os.environ.get("GSTPEAQ_PLATFORM") or None
    if args.emit_tables:
        os.makedirs(args.emit_tables, exist_ok=True)
        for advanced in (False, True):
            rows = run(advanced, args.precision, device=device)
            mode = "advanced" if advanced else "basic"
            path = os.path.join(args.emit_tables,
                                f"conformance_{mode}_table.xml")
            with open(path, "w") as fh:
                fh.write(xml_table(rows, advanced) + "\n")
            print(f"# {mode}")
            print(stats(rows))
            print(f"wrote {path}")
        return 0
    rows = run(args.advanced, args.precision, device=device)
    print(report(rows))
    print(stats(rows))
    return 0 if max(abs(r.delta_blessed) for r in rows) < 1e-3 else 1


if __name__ == "__main__":
    raise SystemExit(main())
