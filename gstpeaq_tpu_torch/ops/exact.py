"""A correctly rounded square root, and logarithms and an exponential that
give one result for their input on every run, on every device.

On the CPU, torch.sqrt, torch.log and torch.log10 go through MKL's vector
math library, which on a worker thread's first call has returned a whole
thread's chunk off: sqrt up to 3e-11 (the level adapter's band sums), log
up to 2e-10 (EHS's log-spectral difference), log10 1.1e-10, so that a
float64 result changed from run to run (ROADMAP.md queue C, C3, C5 and
C6); torch.exp takes the same path.  Its sqrt is also up to 1 ulp from the
IEEE square root.  NumPy's sqrt is the IEEE operation, as is CUDA's, and
as XLA's is in the JAX package; NumPy's log, log10 and exp are
single-threaded routines.  The port takes every square root, logarithm
and exponential through `sqrt`, `log`, `log10` and `exp` here, except
where a gradient flows (models/nn.py's sigmoid).

MKL's GEMM on the CPU sums in an order that follows the thread count, so a
band grouping `x @ matrix` moved with it (C5).  `band_sum` groups in one
fixed order on the CPU, over each band's run of bins as `group_table`
gives it (S2's compact table, cuda_spectral.py), built once per matrix.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE (correctly rounded) square root of x, elementwise."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def log(x: torch.Tensor) -> torch.Tensor:
    """The natural logarithm of x, elementwise: on the CPU NumPy's, the
    same bits for the same input on every call and thread."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.log(x.numpy())))
    return torch.log(x)


def log10(x: torch.Tensor) -> torch.Tensor:
    """The base-10 logarithm of x, elementwise: on the CPU NumPy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.log10(x.numpy())))
    return torch.log10(x)


def exp(x: torch.Tensor) -> torch.Tensor:
    """e to the x, elementwise: on the CPU NumPy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.exp(x.numpy())))
    return torch.exp(x)


def group_table(group_matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The grouping matrix [bins, Z] as a compact table: span [3, Z]
    int32 of each band's first bin, its bin count (from the first to the
    last nonzero weight) and where its weights start in `weights`, the
    bands' weight runs one after another (zeros inside a run kept).  A
    band without a nonzero weight has count 0."""
    gm = np.asarray(group_matrix)
    span = np.zeros((3, gm.shape[1]), np.int32)
    runs = []
    for b in range(gm.shape[1]):
        nz = np.flatnonzero(gm[:, b])
        if nz.size:
            span[0, b], span[1, b] = nz[0], nz[-1] + 1 - nz[0]
        span[2, b] = sum(len(r) for r in runs)
        runs.append(gm[span[0, b]:span[0, b] + span[1, b], b])
    return span, np.concatenate(runs) if runs else np.zeros(0, gm.dtype)


def _table(matrix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """group_table of a CPU matrix as tensors (span int64, weights in the
    matrix's dtype), built once and kept on the matrix (on its base, for a
    view such as group_matrix[:hi]), keyed by the view and the version."""
    owner = matrix if matrix._base is None else matrix._base
    key = (matrix.storage_offset(), tuple(matrix.shape),
           tuple(matrix.stride()), owner._version)
    tables = owner.__dict__.setdefault("_group_tables", {})
    if key not in tables:
        span, weights = group_table(matrix.numpy())
        tables[key] = (torch.from_numpy(span.astype(np.int64)),
                       torch.from_numpy(weights))
    return tables[key]


def band_sum(x: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """x @ matrix for a band matrix [N, Z] whose columns are each one run
    of rows (the FFT ear's grouping): on the CPU each band summed over its
    run (group_table) in ascending rows, from 0, one product at a time, so
    that the bits follow neither the thread count nor the buffers;
    elsewhere the matmul.  x: [..., N] -> [..., Z]."""
    if x.device.type != "cpu":
        return x @ matrix
    (first, count, start), weights = _table(matrix)
    out = x.new_zeros((*x.shape[:-1], matrix.shape[1]))
    for m in range(int(count.max()) if count.numel() else 0):
        inside = m < count
        row = torch.where(inside, first + m, 0)
        w = torch.where(inside, weights[torch.where(inside, start + m, 0)],
                        0.0).to(x.dtype)
        out = out + x[..., row] * w
    return out
