"""What an entry and a loop hand each other: a dispatched unit of work
(`Handle`) and what a loop saw (`Window`).

An entry (`entries/<name>.py`) builds the system under test and its
`submit(m)`, which dispatches unit m of the traffic and returns a Handle
whose answers come to the host without blocking.  A loop
(`loops/<name>.py`) calls `submit` for `seconds` of host-clock time in its
own pattern and returns a Window.  The harness times, compares and reports
from the Windows alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Handle:
    """One dispatched unit: its index m, the ids of the items its answer
    rows belong to, the audio-seconds it scores, the event its host copy
    completes at (None where the copy was synchronous), the host buffer,
    and once done its answers [rows, width] and completion time."""
    m: int
    items: np.ndarray
    audio_s: float
    event: object
    host: object
    values: np.ndarray | None = None
    t_done: float | None = None

    def finish(self, now: float) -> None:
        self.values = self.host.numpy().copy()
        self.t_done = now

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def ready(self) -> bool:
        return self.event is None or self.event.query()


@dataclasses.dataclass
class Window:
    """What a loop saw: its start and close on the host clock, every
    handle in dispatch order, the ones whose answers reached the host by
    the close, and the host seconds spent in `submit`."""
    start: float
    close: float
    handles: list
    in_window: list
    enqueue_s: float
