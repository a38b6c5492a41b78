"""FB-ear DC-rejection cascade: CUDA kernel D3 and its plain PyTorch version.

D3 `dc_chain` (csrc/dc_chain.cu) replaces the Pallas TPU kernel
gstpeaq_tpu/ops/pallas_dc.py::dc_chain_blocked (K7) on the flat [..., T]
sample layout.  What it computes: src/fbearmodel.c:291-303, two
(1 - z^-1)^2 feedforwards each followed by a pole pair, in the
well-conditioned forms of gstpeaq_tpu/ops/fb_ear.py::dc_reject: ff1, the
CASCADE of HP1's two real poles, ff2, and HP2's conjugate pair as one
complex recurrence with y = 2 Re(g u).  The state is dc_reject's tuple
(x_tail, u1, y1_tail, u2), each [..., 2], in the scaled domain, so a state
of either package resumes in the other.

D3 cuts each row into tiles of tile_scan.TILE samples, one block each, and
makes five CUDA launches per call (csrc/dc_chain.cu).  The launch plan
(ops/tile_scan.py) and every scan factor a^n are computed on the host, in
float64, and handed to the kernel.

The wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; there is no fallback.  It
counts its launches in `dc_chain_launches`, one per call.
"""

from __future__ import annotations

import cmath
import functools
import math

import numpy as np
import torch

from .. import constants as C
from . import _build
from . import iir
from . import tile_scan

dc_chain_launches = 0

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def coefficients() -> tuple[float, float, complex, complex]:
    """(lp, lm, lam, g): HP1's real poles, HP2's pole in the upper half
    plane and its output gain, as fb_ear._biquad_feedback forms them."""
    a1, a2 = C.HP1_A
    disc = math.sqrt(a1 * a1 + 4.0 * a2)
    lp, lm = (a1 + disc) / 2.0, (a1 - disc) / 2.0
    b1, b2 = C.HP2_A
    lam = (b1 + complex(0.0, math.sqrt(-(b1 * b1 + 4.0 * b2)))) / 2.0
    g = complex(lam / (lam - np.conj(lam)))
    return lp, lm, lam, g


@functools.cache
def scan_factors(seg: int) -> np.ndarray:
    """D3's coefficients, float64, in the order dc_chain.cu reads them: lp
    and each lp^n, lm and each lm^n, lam and each lam^n as (re, im) pairs,
    then g as (re, im); n from tile_scan.scan_exponents(seg).  Complex
    powers through polar form, |lam|^n at the angle n arg(lam).  Read-only:
    it is cached."""
    lp, lm, lam, g = coefficients()
    ns = tile_scan.scan_exponents(seg)
    out = [*tile_scan.real_powers(lp, seg), *tile_scan.real_powers(lm, seg)]
    for z in (lam, *(cmath.rect(abs(lam) ** n, cmath.phase(lam) * n)
                     for n in ns)):
        out += [z.real, z.imag]
    out = np.array(out + [g.real, g.imag], dtype=np.float64)
    out.flags.writeable = False
    return out


def _zero_state(x: torch.Tensor):
    z = x.new_zeros((*x.shape[:-1], 2))
    return z, z, z, z


def dc_chain_plain(x: torch.Tensor, level_factor: float, state=None):
    """hp2 = dc_reject(level_factor * x) along the last axis, each pole
    stage a doubling scan (the complex one in complex arithmetic).

    x: [..., T]; state: (x_tail, u1, y1_tail, u2), each [..., 2], or None
    for a zero state.  Returns (hp2, new state)."""
    lp, lm, lam, g = coefficients()
    x_tail, u1, y1_tail, u2 = state if state is not None else _zero_state(x)
    xs = x * level_factor

    def ff(u, tail):
        ext = torch.cat([tail, u], dim=-1)
        return u - 2.0 * ext[..., 1:-1] + ext[..., :-2]

    w = iir.linear_recurrence(lp, ff(xs, x_tail), axis=-1, y0=u1[..., 0])
    y1 = iir.linear_recurrence(lm, w, axis=-1, y0=u1[..., 1])
    v2 = ff(y1, y1_tail).to(_COMPLEX[x.dtype])
    u = iir.linear_recurrence(lam, v2, axis=-1,
                              y0=torch.complex(u2[..., 0], u2[..., 1]))
    hp2 = (2.0 * (g * u).real).contiguous()
    new_state = (torch.cat([x_tail, xs], dim=-1)[..., -2:],
                 torch.stack([w[..., -1], y1[..., -1]], dim=-1),
                 torch.cat([y1_tail, y1], dim=-1)[..., -2:],
                 torch.stack([u.real[..., -1], u.imag[..., -1]], dim=-1))
    return hp2, new_state


def dc_chain(x: torch.Tensor, level_factor: float, state=None):
    """D3: see dc_chain_plain.  x: contiguous [..., T]; level_factor: a
    Python float; state: (x_tail, u1, y1_tail, u2) each [..., 2], or None.
    Returns (hp2 with x's shape and dtype, new state)."""
    global dc_chain_launches
    if x.shape[-1] == 0:
        return x.clone(), state if state is not None else _zero_state(x)
    if x.device.type == "cpu":
        return dc_chain_plain(x, level_factor, state)
    lead, t = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, t)
    operands = {"x": x2}
    st = None
    if state is not None:
        if any(s.shape != (*lead, 2) for s in state):
            raise ValueError(f"dc_chain: state shapes "
                             f"{[tuple(s.shape) for s in state]} do not "
                             f"match x {tuple(x.shape)}")
        st = operands["state"] = torch.cat(
            [s.reshape(-1, 2) for s in state], dim=-1).contiguous()
    _build.require("dc_chain", x2, **operands)
    rows = x2.shape[0]
    tiles, seg, _ = tile_scan.launch_plan(rows, t, "dc_chain")
    hp2 = torch.empty_like(x2)
    y1 = torch.empty_like(x2)
    agg = x2.new_empty((4, rows, tiles))     # each tile's zero-entry ends
    st_out = x2.new_empty((rows, 8))
    coef = scan_factors(seg)
    _build.launch("dc_chain", x2, x2.data_ptr(), float(level_factor),
                  None if st is None else st.data_ptr(), hp2.data_ptr(),
                  y1.data_ptr(), agg.data_ptr(), st_out.data_ptr(), rows, t,
                  tiles, seg, coef.ctypes.data)
    dc_chain_launches += 1
    st_out = st_out.reshape(*lead, 8)
    return hp2.reshape(x.shape), tuple(st_out[..., 2 * i:2 * i + 2]
                                       for i in range(4))
