"""Host-side WAV loading and resampling to 48 kHz float32: the port's own
copy of gstpeaq_tpu/utils/wavio.py.

Replaces the reference CLI's filesrc->wavparse->audioconvert->audioresample
front-end (src/peaq.c:154-209) with a thin loader: PCM 8/16/24/32-bit and
float32/64 WAV (incl. WAVE_FORMAT_EXTENSIBLE), integer-to-float conversion by
1/2^(bits-1) like audioconvert, and polyphase resampling to 48 kHz.
"""

from __future__ import annotations

import struct

import numpy as np

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 [samples, channels], sample_rate)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = body
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    (audio_format, channels, rate, _, block_align,
     bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_format == WAVE_FORMAT_EXTENSIBLE:
        audio_format = struct.unpack_from("<H", fmt, 24)[0]
    n = len(payload) // block_align
    payload = payload[:n * block_align]
    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(payload, dtype=dtype).astype(np.float32)
    elif audio_format == WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32)
            x /= 32768.0
        elif bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            ints = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32)
            x /= float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}")
    return x.reshape(-1, channels), rate


def read_wav_pcm16_48k(path: str) -> np.ndarray | None:
    """Raw int16 [T, C] when `path` is a 48 kHz 16-bit PCM WAV, else None.

    The PCM16 ship path (parallel/batch, framing.dequantize) transfers
    these bytes to the device untouched — no host float conversion, half
    the transfer volume, bit-identical results (the 1/32768 scale is a
    power of two)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = body
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    (audio_format, channels, rate, _, block_align,
     bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_format == WAVE_FORMAT_EXTENSIBLE:
        audio_format = struct.unpack_from("<H", fmt, 24)[0]
    if audio_format != WAVE_FORMAT_PCM or bits != 16 or rate != 48000:
        return None
    n = len(payload) // block_align
    x = np.frombuffer(payload[:n * block_align], dtype="<i2")
    return x.reshape(-1, channels)


def resample_to_48k(x: np.ndarray, rate: int) -> np.ndarray:
    """Polyphase resample [T, C] float32 to 48 kHz."""
    if rate == 48000:
        return x
    from math import gcd

    from scipy.signal import resample_poly
    g = gcd(48000, rate)
    up, down = 48000 // g, rate // g
    return resample_poly(x.astype(np.float64), up, down,
                         axis=0).astype(np.float32)


def load_audio_48k(path: str) -> np.ndarray:
    """Read + resample in one step -> float32 [T, C] at 48 kHz."""
    x, rate = read_wav(path)
    return resample_to_48k(x, rate)


def write_wav(path: str, x: np.ndarray, rate: int = 48000) -> None:
    """Write float32 [T, C] as an IEEE-float WAV (test fixture helper)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    payload = x.astype("<f4").tobytes()
    channels = x.shape[1]
    block_align = 4 * channels
    fmt = struct.pack("<HHIIHH", WAVE_FORMAT_IEEE_FLOAT, channels, rate,
                      rate * block_align, block_align, 32)
    chunks = (b"WAVE"
              + b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"data" + struct.pack("<I", len(payload)) + payload)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(chunks)) + chunks)
