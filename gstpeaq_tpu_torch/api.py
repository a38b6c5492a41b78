"""Public API: peaq(ref, test) -> ODG, DI and MOVs for one 48 kHz pair.

The host pads the pair to its own frame count of each path (the
GstAdapter drain and flush semantics, src/gstpeaq.c:596-611,715-745) into
one [2(ref, test), 1, CH, T] array, as parallel/batch.py pads a batch, and
copies it to the device once; the batched pipelines (BasicPipeline,
AdvancedPipeline.unified_input) score it as a batch of one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from . import constants as C
from .models.advanced import AdvancedPipeline
from .models.basic import BasicPipeline
from .ops import framing
from .parallel import batch as PB

# precision tiers -> (band dtype, spectrum dtype), the pair that
# gstpeaq_tpu/api.py::resolve_dtypes returns; TF32 is off in every tier.
#   float64   double everywhere: reproduces the pinned ODGs and the C
#             reference; on an H100 it costs what float32 costs (PERF.md
#             section 5), so it is the default
#   float32   float32 everywhere
#   mixed     JAX's FFT-spectra tier: float32 spectra from an FFT and the
#             float32 band chain, which is what float32 computes here (the
#             port has one rDFT form, torch.fft.rfft), so the same pair
#   accurate  the float32 band chain on float64 spectra: the rDFT, power,
#             the bin-domain MOV terms and, in the advanced mode, the DC
#             stage and the FIR bank in float64.  Held within 1e-3 ODG of
#             float64 on drift corpus v2 (chip_smoke.py phase 5c), the
#             conformance gate JAX's "accurate" is held to
DTYPES = {"float64": (torch.float64, torch.float64),
          "float32": (torch.float32, torch.float32),
          "mixed": (torch.float32, torch.float32),
          "accurate": (torch.float32, torch.float64)}
DEFAULT_DTYPE = "float64"


@dataclasses.dataclass
class PeaqResult:
    odg: float
    di: float
    movs: dict[str, float]
    total_snr_db: float | None = None


@contextlib.contextmanager
def full_precision_matmuls():
    """Turn TF32 off for float32 matrix products and convolutions, and
    restore the previous settings on exit: no product runs at reduced
    precision without being asked to."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def resolve_device(device) -> torch.device:
    """None means CUDA, which must be present; only an explicit "cpu" runs
    on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=8)
def pipeline(band_count: int, playback_level: float, settings: C.Settings,
             dtype: str, device: torch.device) -> BasicPipeline:
    """The basic pipeline of precision tier `dtype` with its constants on
    `device`, built once per configuration."""
    band, spectrum = DTYPES[dtype]
    return BasicPipeline(band_count, playback_level, settings, band, device,
                         spectrum)


@functools.lru_cache(maxsize=8)
def advanced_pipeline(playback_level: float, settings: C.Settings,
                      dtype: str, device: torch.device) -> AdvancedPipeline:
    """The advanced pipeline of precision tier `dtype` with its constants
    on `device`, built once per configuration."""
    band, spectrum = DTYPES[dtype]
    return AdvancedPipeline(playback_level, settings, band, device, spectrum)


def _as_2d_f32(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError("signals must be [samples] or [samples, channels]")
    return x


def peaq(ref, test, advanced: bool = False, playback_level: float = 92.0,
         settings: C.Settings = C.DEFAULT_SETTINGS, dtype: str | None = None,
         return_snr: bool = False, band_count: int | None = None,
         device=None) -> PeaqResult:
    """Compute PEAQ ODG/DI for one 48 kHz pair, basic or advanced.

    ref/test: arrays [samples] or [samples, channels].  band_count: the
    FFT ear's critical-band count, 55..109 (default 109), basic mode only:
    advanced pins 55.  dtype: a precision tier of DTYPES, "float64" by
    default.  device: a torch device; None means "cuda" and raises when
    CUDA is absent.
    """
    ref = _as_2d_f32(ref)
    test = _as_2d_f32(test)
    if ref.shape[1] != test.shape[1]:
        raise ValueError("ref/test channel counts differ")
    dtype = dtype or DEFAULT_DTYPE
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
    if band_count is not None and advanced:
        raise ValueError("band_count applies to basic mode only "
                         "(advanced pins 55)")
    band_count = C.BASIC_BAND_COUNT if band_count is None else band_count
    if not 55 <= band_count <= 109:
        raise ValueError("band_count must be in 55..109")
    dev = resolve_device(device)

    buckets = tuple(
        framing.num_frames(ref.shape[0], test.shape[0], size, step)
        for size, step in ((C.FFT_FRAMESIZE, C.FFT_STEPSIZE),
                           (C.FB_FRAMESIZE, C.FB_FRAMESIZE))[:1 + advanced])
    sig, _ = PB.prepare_chunk([ref], [test], buckets)
    if advanced:
        pipe = advanced_pipeline(float(playback_level), settings, dtype, dev)
        names = C.MOV_ADVANCED_NAMES
    else:
        pipe = pipeline(band_count, float(playback_level), settings, dtype,
                        dev)
        names = C.MOV_BASIC_NAMES
    with full_precision_matmuls(), torch.inference_mode():
        # the buckets are the pair's own frame counts: nothing to mask
        out = PB.dispatch(pipe, buckets, sig.to(dev))
        values = torch.cat([
            torch.stack([out.odg, out.di, out.total_signal_energy,
                         out.total_noise_energy], -1).to(torch.float64),
            out.movs.to(torch.float64)], -1)[0].cpu().numpy()
    odg, di, signal_energy, noise_energy = values[:4]
    snr = (float(10 * np.log10(signal_energy / noise_energy))
           if return_snr else None)
    movs = dict(zip(names, map(float, values[4:])))
    return PeaqResult(odg=float(odg), di=float(di), movs=movs,
                      total_snr_db=snr)
