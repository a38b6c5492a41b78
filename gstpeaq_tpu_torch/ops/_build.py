"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles every `gstpeaq_tpu_torch/csrc/*.cu` for Hopper (`sm_90a`),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, in the git-ignored
`gstpeaq_tpu_torch/_build/`.  The library's file name carries a hash of the
sources, the headers they include (`csrc/*.cuh`) and the flags, so an edited
source or header builds anew and an unchanged one is loaded as it is.  The
compiler's report (`-Xptxas -v`: registers, shared memory and spills of
each kernel) is kept beside the library as `<library>.log`.  Each C entry
launches on the stream it is given and returns `cudaGetLastError()`;
`check` raises on anything but 0.

There is no `--use_fast_math`: it would swap `/`, `sqrtf`, `logf`, `expf`
and `powf` for approximations, and an inexact x/x has already shifted this
system's identical-signal ODG once (0.176 instead of 0.171).  A missing
`nvcc` or a failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# flags of one source on top of NVCC_FLAGS: band.cu rounds every product and
# sum as the eager PyTorch version does, never contracting them into an fma
SOURCE_FLAGS = {"band.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_F64 = ctypes.c_double
_RECURRENCE = (_P, _P, _P, _P, _I64, _I32, _I64, _P)
_FUSED_MOD = (_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _F64, _P)
_SPREAD = (_P, _P, _P, _P, _F64, _P, _P, _I64, _I32, _P)
_SLOPE = (_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _I64, _P, _P)
_SPREAD_FB = (_P, _P, _P, _F64, _P, _I64, _I64, _P)
_DC_CHAIN = (_P, _F64, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _P)
_FIR_BANK = (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _I32, _P)
_FIR_MMA_RATE = (_I32, _I64, _I32, _P, _P)
_PAIR_FRAMES = (_P, _P, _I32, _P, _P, _P, _P, _I64, _I64, _P)
_SPECTRAL_MOVS = (_P, _P, _P, _P, _I32, _I32, _P, _I32, _I32, _I32, _I32,
                  _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P, _I64,
                  _P)
_FRAME_GATE = (_P, _I32, _I64, _I32, _I64, _I64, _I64, _I32, _I32, _F64,
               _I32, _I32, _I32, _I64, _I32, _I32, _I32, _P, _P)
_LEVCORR = (_P, _P, _I64, _I32, _I32, _P, _P, _P)
_PATTERN_ADAPT = (_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P, _P)
_BAND_MOVS = (_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P,
              _P)
_BAND_MATH_RATE = (_I32, _I64, _I32, _P, _P)
_EHS_FRAMES = (_P, _P, _I64, _I32, _I32, _I32, _P, _P)
_MASK_FRAMES = (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I64, _P)
SIGNATURES = {
    "peaq_recurrence_banded_f32": _RECURRENCE,
    "peaq_recurrence_banded_f64": _RECURRENCE,
    "peaq_fused_mod_smoothers_f32": _FUSED_MOD,
    "peaq_fused_mod_smoothers_f64": _FUSED_MOD,
    "peaq_spread_fft_f32": _SPREAD,
    "peaq_spread_fft_f64": _SPREAD,
    "peaq_slope_state_f32": _SLOPE,
    "peaq_slope_state_f64": _SLOPE,
    "peaq_spread_fb_f32": _SPREAD_FB,
    "peaq_spread_fb_f64": _SPREAD_FB,
    "peaq_dc_chain_f32": _DC_CHAIN,
    "peaq_dc_chain_f64": _DC_CHAIN,
    "peaq_fir_bank_f32": _FIR_BANK,
    "peaq_fir_bank_f64": _FIR_BANK,
    "peaq_fir_mma_rate": _FIR_MMA_RATE,
    "peaq_pair_frames_f32": _PAIR_FRAMES,
    "peaq_pair_frames_f64": _PAIR_FRAMES,
    "peaq_spectral_movs_f32": _SPECTRAL_MOVS,
    "peaq_spectral_movs_f64": _SPECTRAL_MOVS,
    "peaq_frame_gate_f32": _FRAME_GATE,
    "peaq_frame_gate_f64": _FRAME_GATE,
    "peaq_levcorr_f32": _LEVCORR,
    "peaq_levcorr_f64": _LEVCORR,
    "peaq_pattern_adapt_f32": _PATTERN_ADAPT,
    "peaq_pattern_adapt_f64": _PATTERN_ADAPT,
    "peaq_band_movs_f32": _BAND_MOVS,
    "peaq_band_movs_f64": _BAND_MOVS,
    "peaq_band_math_rate_f32": _BAND_MATH_RATE,
    "peaq_band_math_rate_f64": _BAND_MATH_RATE,
    "peaq_ehs_frames_f32": _EHS_FRAMES,
    "peaq_ehs_frames_f64": _EHS_FRAMES,
    "peaq_mask_frames_f32": _MASK_FRAMES,
    "peaq_mask_frames_f64": _MASK_FRAMES,
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def sources() -> list[pathlib.Path]:
    """The compiled sources, csrc/*.cu."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[pathlib.Path]:
    """The headers the sources include, csrc/*.cuh."""
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda).  Raises when neither has one."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (not on PATH, not under $CUDA_HOME): "
                       "the port's CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    digest.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in sources() + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpeaq_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, float]:
    """Compile the kernels unless this exact build exists.  Returns the
    library's path and the seconds spent compiling (0.0 when it existed)."""
    lib = library_path()
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    start = time.perf_counter()
    compiler = nvcc()
    # build in a private directory and rename the library into place: a
    # concurrent process never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        work = pathlib.Path(work)
        jobs = []
        try:
            for src in sources():
                cmd = [compiler, *NVCC_FLAGS,
                       *SOURCE_FLAGS.get(src.name, ()), "-c", "-o",
                       str(work / f"{src.stem}.o"), str(src)]
                log = work / f"{src.stem}.txt"
                with open(log, "w") as out:
                    jobs.append((cmd, log, subprocess.Popen(
                        cmd, stdout=out, stderr=subprocess.STDOUT)))
        finally:
            # every compiler started is waited for, also when one fails
            for _, _, proc in jobs:
                proc.wait()
        logs = [log.read_text() for _, log, _ in jobs]
        for (cmd, _, proc), text in zip(jobs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}"
                                   f":\n{' '.join(cmd)}\n{text}")
        tmp = work / lib.name
        cmd = [compiler, *LINK_FLAGS, "-o", str(tmp),
               *(str(work / f"{src.stem}.o") for src in sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, lib)
    return lib, time.perf_counter() - start


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.peaq_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.peaq_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if status != 0:
        msg = library().peaq_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def require(name: str, like: torch.Tensor, **operands: torch.Tensor) -> None:
    """Check what a kernel takes: CUDA tensors of one float type on one
    device, each contiguous."""
    if like.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {like.device}")
    if like.dtype not in _SUFFIX:
        raise TypeError(f"{name}: expected float32 or float64, got "
                        f"{like.dtype}")
    for arg, t in operands.items():
        if t.device != like.device or t.dtype != like.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                            f"expected {like.dtype} on {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def launch(name: str, like: torch.Tensor, *args, dtype=None) -> None:
    """Call the C entry `peaq_<name>_<f32|f64>` of `dtype` (default
    `like`'s) on `like`'s device and its current stream; raise if the
    launch failed."""
    fn = getattr(library(), f"peaq_{name}_{_SUFFIX[dtype or like.dtype]}")
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(fn(*args, stream), name)
