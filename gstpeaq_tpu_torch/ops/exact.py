"""A correctly rounded square root on every device.

On the CPU, torch.sqrt goes through MKL's vector math library: its double
results are up to 1 ulp from the IEEE square root, and on a worker
thread's first call it has returned a whole thread's chunk up to 3e-11
off, so that a float64 result changed from run to run (the level
adapter's band sums, ROADMAP.md queue C).  NumPy's sqrt is the IEEE
operation, as is CUDA's, and as XLA's is in the JAX package.  The port
takes every square root through `sqrt` here.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE (correctly rounded) square root of x, elementwise."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)
