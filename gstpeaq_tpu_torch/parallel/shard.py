"""Data parallelism over several devices: codec-eval sweeps and the
cognitive model's training (gstpeaq_tpu/parallel/shard.py).

PEAQ pairs are independent, so a sweep splits its pairs into contiguous
equal shards, one per device, and runs each shard through the batch path
(parallel/batch.py) on its device: every shard is dispatched before any
result is read, so that the devices overlap.  The training step splits
its examples the same way and takes the mean of the shards' gradients on
the first device.  One process drives every device; there are no
collectives.  `devices` is a list of torch devices in place of the JAX
package's mesh; a device may repeat (e.g. ["cpu"] * 8).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import constants as C
from . import batch as B


def default_devices() -> list[torch.device]:
    """Every CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=['cpu', ...] "
                           "to shard over the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices) -> list[torch.device]:
    if devices is None:
        return default_devices()
    if not devices:
        raise ValueError("devices must name at least one device")
    return [torch.device(d) for d in devices]


def _pad_to(xs: list, n_dev: int) -> list:
    """xs padded with copies of its last item to a multiple of n_dev."""
    return list(xs) + [xs[-1]] * ((-len(xs)) % n_dev)


def peaq_sharded(refs: Sequence[np.ndarray], tests: Sequence[np.ndarray],
                 devices=None, advanced: bool = False,
                 playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None, granularity: int = 64,
                 microbatch: int = 8):
    """Batched ODG over `devices` (default: every CUDA device).

    The pair count is padded to a multiple of the device count with copies
    of the last pair (results discarded).  One compute_buckets over all
    pairs gives every shard the same shapes.  Each device scores its shard
    in microbatches of `microbatch`, as peaq_batch does.  Returns
    peaq_batch's dict for the n pairs.
    """
    from .. import api
    devices = _devices(devices)
    n_dev = len(devices)
    refs = [B.as_2d_ship(r) for r in refs]
    tests = [B.as_2d_ship(t) for t in tests]
    if not refs or len(refs) != len(tests):
        raise ValueError("peaq_sharded needs as many tests as refs, at "
                         "least one")
    n = len(refs)
    refs, tests = _pad_to(refs, n_dev), _pad_to(tests, n_dev)
    dtype = dtype or api.DEFAULT_DTYPE
    buckets = B.compute_buckets(refs, tests, advanced, granularity)
    per = len(refs) // n_dev
    pending = [B.submit(B.batch_pipeline(advanced, playback_level, settings,
                                         dtype, dev),
                        refs[i * per:(i + 1) * per],
                        tests[i * per:(i + 1) * per], buckets, dev,
                        microbatch)
               for i, dev in enumerate(devices)]
    values = np.concatenate([B.collect(p) for p in pending])
    return B.as_result(values[:n])


def train_cognitive_sharded(movs: np.ndarray, target_di: np.ndarray,
                            devices=None, advanced: bool = False,
                            steps: int = 100, lr: float = 1e-2):
    """Refit the MOV -> DI cognitive model with data-parallel SGD.

    movs: [N, M]; target_di: [N].  The examples are padded to a multiple
    of the device count with the first ones (the JAX package's padding)
    and split into equal shards, one per device.  Each device holds a copy
    of the parameters; each step takes the mean of the shards' gradients
    and losses on the first device (the JAX package's pmean: the shards
    are equal, so it is the global mean), updates the parameters there
    and copies them out.  Returns (params on the first device, losses).
    """
    from ..models import nn
    devices = _devices(devices)
    n_dev = len(devices)
    movs, target_di = np.asarray(movs), np.asarray(target_di)
    pad = (-movs.shape[0]) % n_dev
    if pad:
        movs = np.concatenate([movs, movs[:pad]], axis=0)
        target_di = np.concatenate([target_di, target_di[:pad]], axis=0)
    first = devices[0]
    params = nn.init_cognitive_params(advanced, device=first)
    dtype = params["wx"].dtype
    per = movs.shape[0] // n_dev
    shards = [(torch.as_tensor(movs[i * per:(i + 1) * per], dtype=dtype,
                               device=dev),
               torch.as_tensor(target_di[i * per:(i + 1) * per],
                               dtype=dtype, device=dev))
              for i, dev in enumerate(devices)]
    losses = []
    for _ in range(steps):
        copies = [{name: p.detach().to(dev) for name, p in params.items()}
                  for dev in devices]
        # every shard's backward is queued before any is gathered
        parts = [nn.loss_and_grads(copy, m, t)
                 for copy, (m, t) in zip(copies, shards)]
        loss = sum(part[0].to(first) for part in parts) / n_dev
        grads = {name: sum(part[1][name].to(first) for part in parts) / n_dev
                 for name in params}
        params = nn.sgd_apply(params, grads, lr)
        losses.append(float(loss))
    return {name: p.detach() for name, p in params.items()}, losses
