"""The port's float64 level adapter on the CPU is deterministic.

Its square roots are IEEE ones (ops/exact.py: torch's CPU sqrt goes
through MKL's vector math, up to 1 ulp off, and on a worker thread's first
call it has returned that thread's chunk up to 3e-11 off), and its band
average is a fixed-order sum of shifted slices (band_average), so the
adapter's float64 result is a pure function of its inputs: the same bits
on every call, at every thread count, with the machine busy or not, and
for every slice of a batch that carries the same data.  exact.sqrt is
held bit for bit against NumPy's sqrt, no module of the port calls
torch.sqrt, and the band average is held bit for bit against an
ascending-order NumPy sum and within 1e-15 of the matrix form.
"""

import pathlib
import threading

import numpy as np
import pytest
import torch

from gstpeaq_tpu_torch.models import level_adapt as LA
from gstpeaq_tpu_torch.ops import exact


def inputs(rng, z, f, n):
    a = torch.from_numpy(np.exp(-rng.uniform(0.01, 0.5, z)))
    exc2 = rng.uniform(0.01, 10.0, (2, n, z, f))
    uns2 = rng.uniform(0.01, 10.0, (2, n, z, f))
    avg = torch.from_numpy(LA.sliding_average_matrix(z))
    return a, avg, torch.from_numpy(exc2), torch.from_numpy(uns2)


def busy(stop: threading.Event) -> None:
    """Keep the CPU's cores busy with float64 products until `stop`."""
    x = torch.rand(256, 256, dtype=torch.float64)
    while not stop.is_set():
        x = torch.tanh(x @ x)


@pytest.mark.parametrize("z", [109, 55, 40])
def test_fused_mod_bit_identical_under_load(z):
    """level_adapt_fused_mod on one input, called at 1, 2, 3 and all
    threads, alone and beside a busy thread: every call gives the first
    call's bits."""
    rng = np.random.default_rng(z)
    args = inputs(rng, z, 120, 2)
    threads = torch.get_num_threads()
    first = LA.level_adapt_fused_mod(*args, 1024)
    try:
        for n_threads in (1, 2, 3, threads):
            torch.set_num_threads(n_threads)
            for loaded in (False, True):
                stop = threading.Event()
                worker = threading.Thread(target=busy, args=(stop,))
                if loaded:
                    worker.start()
                try:
                    got = LA.level_adapt_fused_mod(*args, 1024)
                finally:
                    stop.set()
                    if loaded:
                        worker.join(timeout=60)
                        assert not worker.is_alive()
                for g, w in zip(got, first):
                    assert torch.equal(g, w), (n_threads, loaded)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [2, 5])
def test_adapter_slices_of_equal_data_are_equal(n):
    """A batch of n copies of one pair: each slice of the adapted
    excitations equals the pair's result alone, bit for bit."""
    rng = np.random.default_rng(n)
    a, avg, exc2, uns2 = inputs(rng, 109, 64, 1)
    one = LA.level_adapt_fused_mod(a, avg, exc2, uns2, 1024)
    many = LA.level_adapt_fused_mod(a, avg, exc2.repeat(1, n, 1, 1),
                                    uns2.repeat(1, n, 1, 1), 1024)
    for got, want in zip(many[:2], one[:2]):
        for i in range(n):
            assert torch.equal(got[i], want[0])


@pytest.mark.parametrize("z", [109, 55, 40, 20])
def test_band_average_fixed_order(z):
    """band_average equals the ascending-order sum of each band's window
    times 1 / (m1 + m2 + 1), computed in NumPy, bit for bit; and the
    matrix form of sliding_average_matrix within 1e-15."""
    rng = np.random.default_rng(z)
    x = rng.uniform(0.0, 1.0, (2, 3, z, 17))
    avg = LA.sliding_average_matrix(z)
    m1c, m2c = z // 36, z // 25
    want = np.empty_like(x)
    for k in range(z):
        lo, hi = k - min(k, m1c), k + min(z - k - 1, m2c)
        total = x[..., lo, :]
        for w in range(lo + 1, hi + 1):
            total = total + x[..., w, :]
        want[..., k, :] = (1.0 / (hi - lo + 1)) * total
    got = LA.band_average(torch.from_numpy(x), torch.from_numpy(avg))
    np.testing.assert_array_equal(got.numpy(), want)
    matrix = np.einsum("wk,...wf->...kf", avg, x)
    assert np.abs(got.numpy() - matrix).max() < 1e-15


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_exact_sqrt_is_ieee(dtype):
    """exact.sqrt equals NumPy's (IEEE) sqrt bit for bit: at a size that
    torch splits over threads, on a strided view, at 0-d, and on zeros,
    subnormals, huge values, inf and NaN."""
    rng = np.random.default_rng(1)
    big = (rng.uniform(0.0, 1e3, (2, 2, 109, 512)) ** 3).astype(dtype)
    info = np.finfo(dtype)
    special = np.array([0.0, -0.0, info.smallest_subnormal, info.tiny,
                        info.max, np.inf, np.nan, 2.0, 1e-300 if
                        dtype == np.float64 else 1e-40], dtype)
    for x in (big, big[..., ::3], special, np.asarray(dtype(7.0))):
        got = exact.sqrt(torch.from_numpy(np.asarray(x)))
        want = np.sqrt(x)
        assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_port_takes_every_sqrt_from_exact():
    """No module of the port calls torch.sqrt but ops/exact.py."""
    root = pathlib.Path(__file__).resolve().parents[1] / "gstpeaq_tpu_torch"
    calls = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if "torch.sqrt(" in p.read_text() and p.name != "exact.py"]
    assert calls == []
