"""The item generator: deterministic for a seed, and no item of a class that
the specification scores as NaN (at a short length, on the CPU)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from peaqbench import items
from peaqbench.reference import torch_ref

CLASSES = json.loads((pathlib.Path(__file__).resolve().parents[1]
                      / "traffic" / "sweep.json").read_text())["classes"]
SEED = 2**31 + 12345


def test_same_seed_same_items():
    a, da = items.make(CLASSES, 6, 0.5, SEED, "cpu")
    b, db = items.make(CLASSES, 6, 0.5, SEED, "cpu")
    assert a.shape == (2, 6, 2, 24000) and a.dtype == torch.float32
    assert torch.equal(a, b)
    for key in da:
        np.testing.assert_array_equal(da[key], db[key])
    c, _ = items.make(CLASSES, 6, 0.5, SEED + 1, "cpu")
    assert not torch.equal(a, c)


def test_written_into_a_longer_pool():
    out = torch.full((2, 3, 2, 30000), 7.0)
    x, _ = items.make(CLASSES, 3, 0.5, SEED, "cpu", out=out)
    assert x is out
    want, _ = items.make(CLASSES, 3, 0.5, SEED, "cpu")
    assert torch.equal(out[..., :24000], want)
    assert torch.all(out[..., 24000:] == 7.0)


def test_draw_covers_the_classes():
    d = items.draw(CLASSES, 4000, SEED)
    assert set(d["class"].tolist()) == set(range(len(CLASSES)))
    assert 0 <= d["strength"].min() and d["strength"].max() < 1


@pytest.mark.parametrize("n", [1, 7, 20, 1024])
def test_every_seed_draws_the_same_set(n):
    """Seeds change the order of the items, not the set of classes,
    strengths and tones (so not the work the set asks of the card)."""
    a = items.draw(CLASSES, n, SEED)
    b = items.draw(CLASSES, n, SEED + 99)
    rows = lambda d: sorted(zip(d["class"], d["strength"], d["tone"]))
    assert rows(a) == rows(b)
    if n > 20:
        assert not np.array_equal(a["class"], b["class"])
    assert len(CLASSES) == 20
    assert {c["kind"] for c in CLASSES} <= set(items.KINDS)


@pytest.fixture(scope="module")
def every_class_at_both_ends():
    """Every class at the least and the most strength of its ranges."""
    n = 2 * len(CLASSES)
    forced = {"class": np.repeat(np.arange(len(CLASSES)), 2),
              "strength": np.tile([0.0, 0.999], len(CLASSES)),
              "tone": np.tile([0.0, 0.999], len(CLASSES))}
    draw = items.draw
    items.draw = lambda classes, n_, seed: forced
    try:
        x, _ = items.make(CLASSES, n, 1.5, SEED, "cpu")
    finally:
        items.draw = draw
    return x


def test_no_identical_or_silent_pair(every_class_at_both_ends):
    x = every_class_at_both_ends
    assert torch.isfinite(x).all()
    diff = (x[1] - x[0]).abs().amax((-1, -2))
    assert torch.all(diff > 0)
    assert torch.all(x[0].abs().amax((-1, -2)) > 0.05)


@pytest.mark.parametrize("advanced", [False, True])
def test_no_nan_class(every_class_at_both_ends, advanced):
    x = every_class_at_both_ends
    out = torch_ref.peaq(x[0], x[1], advanced, block=len(x[0]))
    bad = [CLASSES[i // 2]["name"]
           for i in torch.nonzero(~torch.isfinite(out).all(1)).flatten()]
    assert not bad
    # the classes span the scale, near-transparent to annoying
    assert out[:, 0].min() < -3.0 and out[:, 0].max() > 0.0
