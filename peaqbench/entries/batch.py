"""The port's batch layer on items already on the card: a pool of
`pool_microbatches` microbatches of `item_seconds` stereo items made from
the seed (`items.make`), scored in turn through
`gstpeaq_tpu_torch.parallel.batch`: `batch_pipeline`, then `dispatch` and
`results` on chunks [2, B, CH, T], each chunk's results [B, 2 + M] (ODG,
DI, MOVs) copied to a page-locked host buffer without waiting.

An item's id is its place in the pool, microbatch k's row r being k B + r.
The compared sample holds one item of every row of the microbatch (of
every `compare_stride` rows, where the configuration sets more than 1),
each from a dispatched microbatch drawn from the seed.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from peaqbench import items, roofline
from peaqbench.client import Handle


class System:
    """The pipeline, the pool and the host ring of one run."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tier: str, fault=None):
        from gstpeaq_tpu_torch import api
        from gstpeaq_tpu_torch import constants as PC
        from gstpeaq_tpu_torch.ops import framing
        from gstpeaq_tpu_torch.parallel import batch as PB
        self.api, self.PB = api, PB
        advanced = cfg["version"] == "advanced"
        if cfg["channels"] != 2 or cfg["sample_rate_hz"] != items.RATE:
            raise ValueError("the generator makes stereo items at 48 kHz")
        self.device, self.fault = device, fault
        self.item_seconds = traffic["item_seconds"]
        samples = int(round(self.item_seconds * cfg["sample_rate_hz"]))
        self.samples = samples
        b = self.b = cfg["microbatch"]
        self.stride = cfg["compare_stride"]
        with api.full_precision_matmuls(), torch.no_grad():
            self.pipe = PB.batch_pipeline(
                advanced, cfg["playback_level_db_spl"],
                PC.Settings(**cfg["settings"]), tier, device)
            shape = np.empty((samples, cfg["channels"]), np.float32)
            self.buckets = PB.compute_buckets([shape], [shape], advanced)
            length = framing.padded_length(self.buckets[0],
                                           PC.FFT_FRAMESIZE, PC.FFT_STEPSIZE)
            if advanced:
                length = max(length, self.buckets[1] * PC.FB_FRAMESIZE)
            sizes = ((PC.FFT_FRAMESIZE, PC.FFT_STEPSIZE),
                     (PC.FB_FRAMESIZE, PC.FB_FRAMESIZE))[:len(self.buckets)]
            self.valid = torch.tensor(
                [[framing.num_frames(samples, samples, size, step)] * b
                 for size, step in sizes], dtype=torch.int64, device=device)
            n = traffic["pool_microbatches"] * b
            self.pool = torch.zeros(2, n, cfg["channels"], length,
                                    dtype=torch.float32, device=device)
            items.make(traffic["classes"], n, self.item_seconds, seed,
                       device, out=self.pool)
        self.chunks = [self.pool[:, s:s + b] for s in range(0, n, b)]
        width = 2 + len(cfg["movs"])
        pin = device.type == "cuda"
        self.ring = [torch.empty((b, width), dtype=torch.float64,
                                 pin_memory=pin)
                     for _ in range(traffic["in_flight"] + 1)]
        self.work = roofline.ear_work(cfg["version"], tier, b,
                                      cfg["channels"], samples)

    def context(self):
        """What the window runs under: TF32 off, inference mode."""
        stack = contextlib.ExitStack()
        stack.enter_context(self.api.full_precision_matmuls())
        stack.enter_context(torch.inference_mode())
        return stack

    def warm(self) -> None:
        """Every shape the window uses: the one microbatch shape, twice."""
        for m in range(2):
            self.submit(m).wait()

    def submit(self, m: int) -> Handle:
        """Pool microbatch m % P through the batch layer."""
        k = m % len(self.chunks)
        out = self.PB.results(self.PB.dispatch(self.pipe, self.buckets,
                                               self.chunks[k], self.valid))
        if self.fault is not None:
            out = self.fault(out)
        host = self.ring[m % len(self.ring)]
        event = None
        if self.device.type == "cuda":
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host.copy_(out)
        return Handle(m, k * self.b + np.arange(self.b),
                      self.b * self.item_seconds, event, host)

    def sample(self, rng: np.random.Generator, handles: list) -> np.ndarray:
        """One item of every `stride` microbatch rows (a row drawn within
        each run of `stride`), each from a dispatched microbatch drawn
        from the seed."""
        rows = np.arange(0, self.b, self.stride)
        rows = np.minimum(rows + rng.integers(self.stride, size=rows.size),
                          self.b - 1)
        k = [handles[i].items[0] // self.b
             for i in rng.integers(len(handles), size=rows.size)]
        return np.asarray(k, dtype=np.int64) * self.b + rows

    def pairs(self, ids: np.ndarray) -> list:
        """[(ids, ref [K, CH, T], test [K, CH, T])]: the items' signals as
        the pool holds them, groups of one length (here one group)."""
        ids = np.asarray(ids)
        where = torch.as_tensor(ids, device=self.device)
        sig = self.pool[:, where, :, :self.samples].clone()
        return [(ids, sig[0], sig[1])]

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        del self.pipe, self.pool, self.chunks, self.valid, self.ring


def build(cfg: dict, traffic: dict, seed: int, device, tier: str,
          fault=None) -> System:
    return System(cfg, traffic, seed, device, tier, fault)
