"""On a card (the `cuda` marker; each test decides whether there is one
and skips without): the control, the port's float32 tier in the place of
the float64 the configurations state, comes out not correct, and the
float64 tier correct, at full-length items in a microbatch smaller than
the cells' and a short window.  The benchmark's own runs never run the
control; its readings at the cells' sizes are in PERF.md.

    python -m pytest -m cuda peaqbench/tests/test_peaqbench_card.py
"""

import pathlib

import pytest
import torch

from peaqbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = {"microbatch": 8, "pool_microbatches": 2, "trace_seconds": 0.5}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["advanced.sweep", "basic.sweep"])
@pytest.mark.parametrize("tier,correct", [("float64", True),
                                          ("float32", False)])
def test_control_fails_and_the_stated_tier_passes(name, tier, correct):
    card()
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        result, checks = harness.run_cell(
            harness.Bench(ROOT), name, seed, 2.0, False, "cuda", tier=tier,
            overrides=SMALL)
        assert result["correct"] is correct, checks
