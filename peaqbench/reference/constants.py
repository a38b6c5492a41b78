"""Static constants of ITU-R BS.1387-1 (PEAQ) as implemented by gstpeaq:
the benchmark's frozen copy, read only by its plain references.

Every constant here is traceable to the C implementation; citations point
at gstpeaq's sources (HSU-ANT/gstpeaq) file:line.  Plain Python and NumPy
data only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SAMPLING_RATE = 48000  # src/earmodel.c:43

# ---------------------------------------------------------------------------
# FFT ear model (src/fftearmodel.c)
# ---------------------------------------------------------------------------
FFT_FRAMESIZE = 2048        # src/fftearmodel.c:51
FFT_STEPSIZE = 1024         # src/fftearmodel.c:226
GAMMA = 0.84971762641205    # src/fftearmodel.c:52
FFT_LOUDNESS_SCALE = 1.07664  # src/fftearmodel.c:53
FFT_TAU_MIN = 0.008         # src/fftearmodel.c:227
FFT_TAU_100 = 0.030         # src/fftearmodel.c:228
BASIC_BAND_COUNT = 109      # src/gstpeaq.c:524
ADVANCED_FFT_BAND_COUNT = 55  # src/gstpeaq.c:522

# ---------------------------------------------------------------------------
# Filter-bank ear model (src/fbearmodel.c)
# ---------------------------------------------------------------------------
FB_FRAMESIZE = 192          # src/fbearmodel.c:48
FB_SUBSAMPLING = 32         # src/fbearmodel.c:314 (filter evaluated every 32nd sample)
FB_BAND_COUNT = 40
FB_BUFFER_LENGTH = 1456     # src/fbearmodel.c:52
FB_LOUDNESS_SCALE = 1.26539  # src/fbearmodel.c:174
FB_TAU_MIN = 0.004          # src/fbearmodel.c:176
FB_TAU_100 = 0.020          # src/fbearmodel.c:177
SLOPE_FILTER_A = 0.993355506255034  # src/fbearmodel.c:49  exp(-32/(48000*0.1))
DIST = 0.921851456499719    # src/fbearmodel.c:50
CL = 0.0802581846102741     # src/fbearmodel.c:51  DIST**31

# Table 8 in BS.1387; src/fbearmodel.c:57-61
FB_FILTER_LENGTH = np.array([
    1456, 1438, 1406, 1362, 1308, 1244, 1176, 1104, 1030, 956, 884, 814, 748,
    686, 626, 570, 520, 472, 430, 390, 354, 320, 290, 262, 238, 214, 194, 176,
    158, 144, 130, 118, 106, 96, 86, 78, 70, 64, 58, 52], dtype=np.int64)

# DC-rejection high-pass cascade; src/fbearmodel.c:291-303.
# Each stage: y[t] = x[t] - 2 x[t-1] + x[t-2] + a1 y[t-1] + a2 y[t-2]
HP1_A = (1.99517, -0.995174)
HP2_A = (1.99799, -0.997998)

# ---------------------------------------------------------------------------
# Level adapter / modulation processor time constants (tau_min, tau_100)
# src/leveladapter.c:205, src/modpatt.c:185
# ---------------------------------------------------------------------------
ADAPT_TAU_MIN = 0.008
ADAPT_TAU_100 = 0.05

# ---------------------------------------------------------------------------
# MOV computation constants (src/movs.c)
# ---------------------------------------------------------------------------
FIVE_DB_POWER_FACTOR = 3.16227766016838        # src/movs.c:41
ONE_POINT_FIVE_DB_POWER_FACTOR = 1.41253754462275  # src/movs.c:42
MAXLAG = 256                                    # src/movs.c:43
EHS_ENERGY_THRESHOLD = 8000.0 / (32768.0 * 32768.0)  # src/fftearmodel.c:511
FRAME_THRESHOLD = 200.0 / 32768.0               # src/gstpeaq.c:1093

# Detection-probability step-size polynomial; src/movs.c:1247-1249
PD_S_COEFFS = (5.95072, 6.39468, 1.71332, 9.01033e-11, 5.05622e-6,
               0.00102438, 0.0550197, 0.198719)

# ---------------------------------------------------------------------------
# Neural network (cognitive model) weights; src/nn.c:40-93
# ---------------------------------------------------------------------------
NN_AMIN_BASIC = np.array([
    393.916656, 361.965332, -24.045116, 1.110661, -0.206623, 0.074318,
    1.113683, 0.950345, 0.029985, 0.000101, 0.0])
NN_AMAX_BASIC = np.array([
    921.0, 881.131226, 16.212030, 107.137772, 2.886017, 13.933351, 63.257874,
    1145.018555, 14.819740, 1.0, 1.0])
NN_WX_BASIC = np.array([
    [-0.502657, 0.436333, 1.219602],
    [4.307481, 3.246017, 1.123743],
    [4.984241, -2.211189, -0.192096],
    [0.051056, -1.762424, 4.331315],
    [2.321580, 1.789971, -0.754560],
    [-5.303901, -3.452257, -10.814982],
    [2.730991, -6.111805, 1.519223],
    [0.624950, -1.331523, -5.955151],
    [3.102889, 0.871260, -5.922878],
    [-1.051468, -0.939882, -0.142913],
    [-1.804679, -0.503610, -0.620456]])
NN_WXB_BASIC = np.array([-2.518254, 0.654841, -2.207228])
NN_WY_BASIC = np.array([-3.817048, 4.107138, 4.629582])
NN_WYB_BASIC = -0.307594

NN_AMIN_ADVANCED = np.array([13.298751, 0.041073, -25.018791, 0.061560, 0.02452])
NN_AMAX_ADVANCED = np.array([2166.5, 13.24326, 13.46708, 10.226771, 14.224874])
NN_WX_ADVANCED = np.array([
    [21.211773, -39.013052, -1.382553, -14.545348, -0.320899],
    [-8.981803, 19.956049, 0.935389, -1.686586, -3.238586],
    [1.633830, -2.877505, -7.442935, 5.606502, -1.783120],
    [6.103821, 19.587435, -0.240284, 1.088213, -0.511314],
    [11.556344, 3.892028, 9.720441, -3.287205, -11.031250]])
NN_WXB_ADVANCED = np.array([1.330890, 2.686103, 2.096598, -1.327851, 3.087055])
NN_WY_ADVANCED = np.array([-4.696996, -3.289959, 7.004782, 6.651897, 4.009144])
NN_WYB_ADVANCED = -1.360308

NN_BMIN = -3.98  # src/nn.c:92
NN_BMAX = 0.22   # src/nn.c:93

# MOV ordering for the basic version, src/gstpeaq.c:95-108 / src/nn.c:165-177
MOV_BASIC_NAMES = (
    "BandwidthRefB", "BandwidthTestB", "TotalNMRB", "WinModDiff1B", "ADBB",
    "EHSB", "AvgModDiff1B", "AvgModDiff2B", "RmsNoiseLoudB", "MFPDB",
    "RelDistFramesB")
# MOV ordering for the advanced version, src/gstpeaq.c:86-93 / src/nn.c:288-295
MOV_ADVANCED_NAMES = (
    "RmsModDiffA", "RmsNoiseLoudAsymA", "SegmentalNMRB", "EHSB", "AvgLinDistA")


@dataclasses.dataclass(frozen=True)
class Settings:
    """Compile-time ambiguity switches of the reference (src/settings.h:47-97).

    Defaults match the reference's blessed conformance choices exactly.
    """

    swap_mod_patts_for_noise_loudness_movs: bool = True   # settings.h:47
    center_ehs_correlation_window: bool = False           # settings.h:56
    ehs_subtract_dc_before_window: bool = True            # settings.h:66
    use_floor_for_steps_above_threshold: bool = False     # settings.h:76
    clamp_movs: bool = False                              # settings.h:86
    swap_slope_filter_coefficients: bool = False          # settings.h:97


DEFAULT_SETTINGS = Settings()
