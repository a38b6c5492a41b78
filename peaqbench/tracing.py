"""Reduces a torch.profiler trace of a traced window to what the per-layer
readers read: every device operation with its layer (by the kernel table),
the device's busy time (the union of its operations' intervals), and the
idle gaps named by what the benchmark's loop was doing on the host when
each began."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re

EAGER = "eager"
# the loops' host ranges: "peaqbench.submit", "peaqbench.wait", ...
LOOP_PREFIX = "peaqbench."


@dataclasses.dataclass
class KernelRule:
    name: str
    pattern: re.Pattern
    layer: str


def kernel_table(directory: pathlib.Path) -> list:
    """The kernel table: one file per kernel or library name pattern, in
    file-name order; a device operation belongs to the first rule whose
    pattern it matches, and to the eager layer if none does."""
    rules = []
    for path in sorted(directory.glob("*.json")):
        spec = json.loads(path.read_text())
        rules.append(KernelRule(path.stem, re.compile(spec["pattern"]),
                                spec["layer"]))
    return rules


def layer_of(name: str, rules: list) -> str:
    for rule in rules:
        if rule.pattern.search(name):
            return rule.layer
    return EAGER


@dataclasses.dataclass
class Trace:
    """A traced window: device operations [(name, start_us, end_us,
    layer)], host loop ranges [(name, start_us, end_us)], the microbatches
    it held and its length on the host clock."""
    ops: list
    ranges: list
    microbatches: int
    window_s: float

    def busy_s(self) -> float:
        busy, reach = 0.0, None
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if reach is None or s > reach:
                busy += e - s
                reach = e
            elif e > reach:
                busy += e - reach
                reach = e
        return busy / 1e6

    def layer_ms(self, layer: str) -> float:
        """Device ms of a layer's operations per microbatch."""
        return sum(e - s for _, s, e, lay in self.ops
                   if lay == layer) / 1e3 / self.microbatches

    def device_ms(self) -> float:
        return sum(e - s for _, s, e, _ in self.ops) / 1e3 / self.microbatches

    def top_ops(self, n: int = 10) -> list:
        total = {}
        for name, s, e, _ in self.ops:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps between device operations, each named by the
        loop range the host was in when it began ("host" outside them)."""
        gaps, reach = [], None
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if reach is not None and s > reach:
                gaps.append((reach, s))
            reach = e if reach is None else max(reach, e)
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            what = "host"
            for name, rs, re_ in self.ranges:
                if rs <= s < re_:
                    what = name
                    break
            named.append([f"{what} (gap at {s / 1e6:.6f} s)", (e - s) / 1e6])
        return named


def reduce(prof, rules: list, microbatches: int, window_s: float) -> Trace:
    """The Trace of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType
    ops, ranges = [], []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            # a host range's mirror on the device timeline is no operation
            if ev.name.startswith(LOOP_PREFIX) or getattr(
                    ev, "is_user_annotation", False):
                continue
            ops.append((ev.name, start, end, layer_of(ev.name, rules)))
        elif ev.name.startswith(LOOP_PREFIX):
            ranges.append((ev.name, start, end))
    return Trace(ops, ranges, microbatches, window_s)
