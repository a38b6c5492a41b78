"""The roofline arithmetic against hand counts at small shapes."""

import pytest

from peaqbench import roofline as R
from peaqbench.reference import constants as C


def test_fir_window_taps():
    # a band's window starts past its first tap (sin^2(0) = 0), so it
    # spans its filter length less one, in both parts; band 0's aliased
    # lag-1456 tap, folded into lag 0, widens its window by one again
    n = int(C.FB_FILTER_LENGTH.sum())
    assert R.fir_window_taps() == 2 * (n - 40) + 2 == 43578


def test_basic_ear_by_hand():
    # 4096 samples: 3 full FFT frames and a flush frame
    work = R.ear_work("basic", "float64", pairs=1, channels=1, samples=4096)
    read = 2 * 4096 * 4
    written = 2 * 4 * 2 * 109 * 8 + 4 * (5 * 8 + 2) + 4
    assert set(work) == {"fft_ear"}
    ms, by, moved, ops = work["fft_ear"]
    assert moved == read + written and ops == 0 and by == "bytes"
    assert ms == pytest.approx((read + written) / 3.35e12 * 1e3, rel=1e-15)


def test_advanced_ears_by_hand():
    work = R.ear_work("advanced", "float64", pairs=2, channels=2,
                      samples=4096)
    read = 2 * 2 * 2 * 4096 * 4
    fft_written = 2 * 2 * 4 * (2 * 8 + 2) + 2 * 4
    assert work["fft_ear"][2] == read + fft_written
    # 21 full FB frames of 192 and a flush frame: 22 frames, 132 instants
    rows = 2 * 2 * 2
    fb_written = rows * 22 * 2 * 40 * 8 + 2 * 22
    ops = 2 * 43578 * 132 * rows
    ms, by, moved, counted = work["fb_ear"]
    assert moved == read + fb_written and counted == ops
    want = max((read + fb_written) / 3.35e12, ops / 67e12) * 1e3
    assert ms == pytest.approx(want, rel=1e-15)
    assert by == "operations"


def test_ten_second_advanced_microbatch_is_bound_by_the_fir():
    ms, by, _, ops = R.ear_work("advanced", "float64", 64, 2,
                                480000)["fb_ear"]
    assert by == "operations"
    assert ops == 2 * 43578 * 15000 * 256
