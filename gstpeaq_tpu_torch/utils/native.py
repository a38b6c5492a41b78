"""ctypes bindings to the native host-side I/O library (native/peaqio.c):
the port's own copy of gstpeaq_tpu/utils/native.py.

Falls back to the pure-Python wavio implementation when the shared library
has not been built (`make -C native`).  The fallback is in the host's file
reading only; `available()` says which reader runs.  The native path
matters for codec-sweep loading, where Python WAV decode of thousands of
pairs would starve the device.
"""

from __future__ import annotations

import ctypes
import os
import pathlib

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = pathlib.Path(__file__).resolve().parents[2]
    cand = root / "native" / "libpeaqio.so"
    if cand.exists():
        try:
            lib = ctypes.CDLL(str(cand))
        except OSError:
            # built for another machine: read with wavio instead
            return None
        lib.peaq_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
        lib.peaq_wav_info.restype = ctypes.c_int
        lib.peaq_wav_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.peaq_wav_read_f32.restype = ctypes.c_int64
        lib.peaq_resample_48k.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.peaq_resample_48k.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Native WAV decode -> (float32 [frames, channels], rate)."""
    lib = _find_lib()
    if lib is None:
        from . import wavio
        return wavio.read_wav(path)
    rate = ctypes.c_int()
    channels = ctypes.c_int()
    frames = ctypes.c_int64()
    rc = lib.peaq_wav_info(path.encode(), ctypes.byref(rate),
                           ctypes.byref(channels), ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"peaq_wav_info({path}) failed: {rc}")
    out = np.empty((frames.value, channels.value), dtype=np.float32)
    got = lib.peaq_wav_read_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames.value)
    if got < 0:
        raise IOError(f"peaq_wav_read_f32({path}) failed: {got}")
    return out[:got], rate.value


def load_audio_48k(path: str) -> np.ndarray:
    """Native decode + resample -> float32 [frames, channels] @48 kHz."""
    lib = _find_lib()
    if lib is None:
        from . import wavio
        return wavio.load_audio_48k(path)
    x, rate = read_wav(path)
    if rate == 48000:
        return x
    x = np.ascontiguousarray(x)
    cap = x.shape[0] * 48000 // rate + 64
    out = np.empty((cap, x.shape[1]), dtype=np.float32)
    got = lib.peaq_resample_48k(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.shape[0],
        x.shape[1], rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    if got < 0:
        raise IOError(f"peaq_resample_48k failed: {got}")
    return out[:got]


def load_audio_48k_ship(path: str) -> np.ndarray:
    """Sweep-loader variant preferring the raw PCM16 ship form: 48 kHz
    16-bit PCM files return int16 [T, C] untouched (zero host conversion;
    the device dequantizes — framing.dequantize); anything else falls back
    to the float32 decode+resample path."""
    from . import wavio
    raw = wavio.read_wav_pcm16_48k(path)
    if raw is not None:
        return raw
    return load_audio_48k(path)
